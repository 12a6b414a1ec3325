"""Process-local metrics registry + structured event log for the stack.

A copy of ``horovod_tpu/metrics.py`` for the PyTorch port, which may not
import the JAX package (its ``__init__`` pulls in jax); environment
knobs are ``HVD_TORCH_*`` here.  Names of modules the port does not
have yet (the router, the monitor, tracing, ...) are the reference's.

The reference ships exactly one observability surface — the Chrome-trace
timeline (timeline.h/.cc, :mod:`horovod_tpu.timeline`) — which is
rank-0-only, file-based, and made for eyeballs, not machines.  A
production engine needs the request-level latency decomposition that
Dapper (Sigelman et al. 2010) made standard and vLLM-class servers
expose as first-class metrics: TTFT, per-output-token latency, queue
wait, preemption/retry cost — as queryable numbers.  This module is
that layer, shared by training and serving:

* :class:`MetricsRegistry` — a thread-safe, process-local registry of
  monotonically increasing :class:`Counter`\\ s, last-value
  :class:`Gauge`\\ s, and fixed-log-bucket :class:`Histogram`\\ s.
  ``snapshot()`` returns a plain nested dict (with p50/p90/p99 per
  histogram) and ``to_prometheus()`` renders the standard Prometheus
  text exposition, so a serving sidecar can scrape the engine with
  zero extra dependencies.

* :class:`EventLog` — an optional JSONL structured event log.  Setting
  ``HVD_TORCH_EVENT_LOG=<path>`` makes every registry created with the
  default ``event_log="auto"`` append one JSON object per event —
  request state transitions, fault-site hits, preemptions, prefix-cache
  evictions — each stamped with wall-clock time and (when the emitter
  has one) the engine step.  The log is the replayable ground truth:
  ``tests/test_metrics.py`` pins that replaying a serve run's lines
  reproduces the engine's lifecycle counters exactly.

* :class:`Trace` — the per-request span threaded through
  :class:`~horovod_tpu_torch.serving_scheduler.ServeEngine` and surfaced on
  ``RequestResult.trace``: enqueue/admit/first-token/terminal stamps
  (``time.monotonic`` seconds, comparable within a process), plus
  prefill-chunk / preemption / retry / prefix-reuse odometers.

* Canonical name tables (:data:`TIMELINE_COUNTER_SERIES`,
  :data:`FAULT_SITES`, :data:`LIFECYCLE_EVENT_COUNTERS`) — the single
  source of truth ``tools/check_counter_names.py`` lints the codebase
  against, so dashboards built on these names cannot silently drift
  from the code.

Everything here is standard library only and imports nothing else from
``horovod_tpu`` — any module (``basics``, ``ops.eager``, ``faults``,
``serving_scheduler``) can instrument itself without import cycles.
The module-level :data:`DEFAULT` registry is the shared venue: the
eager collectives engine and a default-constructed ``ServeEngine``
both feed it, so one scrape sees training and serving side by side.
:data:`NULL` is the no-op twin for measuring instrumentation overhead
(``bench.py`` records the on-vs-off delta in its serve arm extras).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
import threading
import time
from bisect import bisect_left
from typing import Any, IO


# ---------------------------------------------------------------------------
# Canonical name tables (linted by tools/check_counter_names.py).
# ---------------------------------------------------------------------------

#: Every Chrome-trace counter (``ph: "C"``) activity the codebase emits,
#: mapped to the exact series keys its ``values`` dict carries.  A new
#: timeline counter MUST be registered here or the lint fails the suite.
TIMELINE_COUNTER_SERIES: dict[str, tuple[str, ...]] = {
    # serving_scheduler.ServeEngine, per step
    "SCHED": ("queued", "decoding", "prefilling", "free_blocks"),
    "LIFECYCLE": ("preemptions", "timeouts", "cancellations",
                  "rejections", "retries", "failures"),
    "PREFIX": ("hits", "blocks_reused", "tokens_skipped", "evictions"),
    # serving_scheduler.ServeEngine with spec=True, per step
    "SPEC": ("rounds", "row_rounds", "proposed", "accepted"),
    # serving.speculative_generate, per verify round
    "ACCEPT": ("accepted", "rows"),
}

#: Every named fault-injection site wired through
#: :meth:`horovod_tpu_torch.faults.FaultRegistry.check`.
FAULT_SITES: tuple[str, ...] = (
    "serve.admit",
    "serve.prefill",
    "serve.tick",
    "serve.cache",
    "serve.draft",
    "serve.router",
    "serve.supervisor",
    "serve.autoscale",
    "router.journal",
    "data.producer",
)

#: Event-log ``kind`` → ``ServeEngine.counters`` key.  Replaying a JSONL
#: event log by counting these kinds reproduces the engine's lifecycle
#: counters exactly (pinned by tests/test_metrics.py).
LIFECYCLE_EVENT_COUNTERS: dict[str, str] = {
    "serve.preempt": "preemptions",
    "serve.timeout": "timeouts",
    "serve.cancel": "cancellations",
    "serve.reject": "rejections",
    "serve.retry": "retries",
    "serve.fail": "failures",
}

#: Declared bit-identity replay surfaces: code paths whose output must
#: be byte-for-byte reproducible from their inputs (journal entries, a
#: seed, a snapshot) because something downstream replays or diffs it.
#: ``tools/hvdlint`` (HVD010) walks each ``(surface, path, qualname,
#: note)`` row's same-file call closure and flags wall-clock reads,
#: unseeded entropy, and set-iteration-order dependence.  A new replay
#: path MUST be registered here to get that protection.
DETERMINISM_SURFACES: tuple = (
    ("journal-replay", "horovod_tpu/router.py", "load_journal",
     "journal parse feeding exactly-once accept/terminal state"),
    ("journal-replay", "horovod_tpu/router.py",
     "RouterServer.replay_journal",
     "re-submission of non-terminal journal entries on restart"),
    ("journal-replay", "horovod_tpu/router.py", "compact_journal",
     "rewrite of the journal file from replayed state"),
    ("failover-replay", "horovod_tpu/router.py", "RouterServer._on_done",
     "terminal results recorded for dedupe/journal on completion"),
    ("failover-replay", "horovod_tpu/supervisor.py", "clone_engine",
     "respawned engine must be bit-identical to the dead one"),
    ("chaos-oracle", "horovod_tpu/chaos.py", "ChaosSchedule.generate",
     "seeded fault schedule replayed across campaign runs"),
    ("sim-fleet", "horovod_tpu/simfleet.py", "SimFleet.run",
     "virtual-time fleet driver replayed bit-identically from seed"),
    ("sim-campaign", "horovod_tpu/simfleet.py", "run_sim_campaign",
     "seeded chaos-at-scale campaign diffed by the --compare gate"),
    ("trace-sampling", "horovod_tpu/tracing.py", "sampled",
     "head-sampling decision is a pure function of (seed, request id)"),
    ("device-replay", "horovod_tpu/device_telemetry.py",
     "report_from_events",
     "device report rebuilt from the event log must match the live scrape"),
)

#: Canonical one-line descriptions for every registry metric the codebase
#: emits by literal name — ``to_prometheus()`` renders these as ``# HELP``
#: lines, and ``tools/check_counter_names.py`` lints call sites against
#: this table both directions (a new literal metric name MUST land here).
#: Dynamic families (``"serve." + key`` mirrors of ``ServeEngine.counters``,
#: ``"prefix." + key`` mirrors of the prefix-cache counters) are covered by
#: the ``serve.<lifecycle>`` / ``prefix.<series>`` entries below.
METRIC_HELP: dict[str, str] = {
    # hvd.* — collectives / negotiation / cross-rank step health
    "hvd.allreduce_bytes": "Per-rank eager allreduce payload bytes dispatched",
    "hvd.negotiate_polls": "KV-store poll iterations spent negotiating collective readiness",
    "hvd.negotiate_timeouts": "Negotiation rounds abandoned after the stall timeout",
    "hvd.negotiate_s": "Seconds from eager-op enqueue to negotiated dispatch",
    "hvd.step_s": "Per-rank engine/training step wall time in seconds",
    "hvd.step_skew_s": "Slowest-minus-median rank step time over the straggler window",
    # serve.* — ServeEngine request latencies and occupancy
    "serve.queue_wait_s": "Seconds a request waited from submit to first admission",
    "serve.ttft_s": "Seconds from submit to first emitted token",
    "serve.e2e_s": "Seconds from submit to terminal status",
    "serve.tpot_s": "Seconds per output token after the first (decode cadence)",
    "serve.steps": "Engine scheduler steps executed",
    "serve.queue_depth": "Requests waiting for admission",
    "serve.decoding": "Slots actively decoding",
    "serve.prefilling": "Slots mid-prefill",
    "serve.free_blocks": "Free KV-cache pages",
    "serve.cached_blocks": "KV-cache pages retained by the prefix cache",
    "serve.goodput": "Fraction of windowed terminal requests that finished OK within SLO",
    # serve.* lifecycle counters mirrored from ServeEngine.counters
    "serve.requests_submitted": "Requests accepted by submit()",
    "serve.requests_completed": "Requests reaching a terminal status",
    "serve.tokens_emitted": "Output tokens emitted across all requests",
    "serve.preemptions": "Scheduler preemptions (victim returned to queue)",
    "serve.timeouts": "Requests terminated by deadline expiry",
    "serve.cancellations": "Requests cancelled by the caller",
    "serve.rejections": "Requests load-shed after max_queue_steps",
    "serve.retries": "Fault-triggered replays of a request",
    "serve.failures": "Requests terminated FAILED after exhausting retries",
    "serve.prefix_indexed_blocks": "KV pages indexed by the radix prefix cache",
    "serve.retrace": "Jit cache growths detected mid-serve by the retrace sentry",
    # serve.spec.* — self-drafting speculation (spec=True engines)
    "serve.spec.rounds": "Speculative verify ticks executed (>= 1 decoding row)",
    "serve.spec.row_rounds": "Per-row verify rounds (decoding rows summed over spec ticks)",
    "serve.spec.proposed": "Draft tokens proposed by the prompt-lookup drafter",
    "serve.spec.accepted": "Draft tokens accepted by greedy longest-prefix verification",
    "serve.spec.accepted_per_round": "Accepted draft tokens per decoding row per verify round",
    "serve.spec.draft_faults": "Drafter faults degraded to plain decode (row unaffected)",
    # serve.phase.* — TickProfiler per-tick phase histograms (seconds);
    # the top-level phases tile step() wall time, the admit_* sub-phases
    # nest inside admit, and tick_s is the whole step.
    "serve.phase.expire_s": "Tick phase: deadline expiry + queue bookkeeping",
    "serve.phase.admit_s": "Tick phase: admission, preemption, and prefill windows",
    "serve.phase.admit_cache_acquire_s": "Admit sub-phase: prefix-cache longest-prefix acquire",
    "serve.phase.admit_prefill_dispatch_s": "Admit sub-phase: chunked-prefill window dispatch",
    "serve.phase.draft_s": "Tick phase: prompt-lookup draft proposal (spec engines)",
    "serve.phase.decode_dispatch_s": "Tick phase: host time dispatching the decode tick",
    "serve.phase.device_sync_s": "Tick phase: blocking token readback (device wait)",
    "serve.phase.device_sync_compute_est_s": "Device-sync sub-phase: cost-model-predicted device compute share",
    "serve.phase.device_sync_host_stall_s": "Device-sync sub-phase: readback wait beyond predicted device time",
    "serve.phase.verify_s": "Tick phase: acceptance + token emission (spec engines)",
    "serve.phase.sample_postprocess_s": "Tick phase: per-slot token handling and retirement",
    "serve.phase.bookkeeping_s": "Tick phase: counters, gauges, sentry, watchdog",
    "serve.phase.tick_s": "Whole engine step wall time as the profiler measures it",
    # kv.* — paged KV pool accounting in blocks AND bytes (bytes derive
    # from the llama cache dtype/shape: k+v for one block).
    "kv.free_blocks": "KV pool blocks on the free list",
    "kv.free_bytes": "KV pool bytes on the free list",
    "kv.referenced_blocks": "KV pool blocks mapped by live rows",
    "kv.referenced_bytes": "KV pool bytes mapped by live rows",
    "kv.cached_blocks": "Zero-ref KV pool blocks parked in the prefix cache",
    "kv.cached_bytes": "Zero-ref KV pool bytes parked in the prefix cache",
    "kv.block_bytes": "Device bytes one KV block holds (k+v, all layers)",
    "kv.total_bytes": "Device bytes of the whole paged KV pool (incl. trash)",
    # kv.shard_* / tp.* — per-chip view of the same pool under
    # tensor-parallel serving (logical bytes / tp.size: the pool is
    # head-split, block counts are per-chip already).  Always emitted;
    # equal to the logical kv.* bytes at tp.size = 1.
    "kv.shard_block_bytes": "Per-chip device bytes of one KV block (logical / tp.size)",
    "kv.shard_total_bytes": "Per-chip device bytes of the paged KV pool (logical / tp.size)",
    "kv.shard_free_bytes": "Per-chip KV pool bytes on the free list",
    "kv.shard_referenced_bytes": "Per-chip KV pool bytes mapped by live rows",
    "kv.shard_cached_bytes": "Per-chip KV pool bytes parked in the prefix cache",
    "tp.size": "Tensor-parallel degree of the serving engine (chips per replica)",
    # mem.* — host-side observability footprint (approximate)
    "mem.registry_bytes": "Approximate host bytes held by the metrics registry",
    "mem.trace_ring_bytes": "Approximate host bytes of live traces + the SLO ring",
    "mem.event_log_bytes": "Bytes written to the JSONL event log so far",
    "mem.prefix_index_bytes": "Approximate host bytes of the radix prefix index",
    # prefix.* — RadixPrefixCache counters mirrored from prefix_counters
    "prefix.hits": "Admissions that reused prefix-cache blocks",
    "prefix.blocks_reused": "KV pages spliced from the prefix cache",
    "prefix.tokens_skipped": "Prompt tokens skipped via prefix reuse",
    "prefix.evictions": "Prefix-cache pages evicted under pressure",
    # monitor.* — the cross-rank observability layer itself
    "monitor.scrapes": "HTTP requests served by the /metrics exporter",
    "monitor.aggregations": "Cross-rank aggregate_snapshots() rounds completed",
    "monitor.scrape_s": "Seconds serving one exporter request, per endpoint (monitor.scrape_s.<endpoint>)",
    "monitor.scrape_errors": "Exporter requests that raised or returned 5xx, per endpoint",
    # ts.* — the in-process time-series sampler (horovod_tpu.timeseries)
    "ts.samples": "Registry snapshots folded into the ring-buffer series",
    "ts.series": "Distinct metric series held across all downsample tiers",
    # alert.* — declarative rule evaluation (horovod_tpu.alerts)
    "alert.evals": "ALERT_RULES evaluation passes executed",
    "alert.fired": "Alert transitions into the firing state",
    "alert.resolved": "Firing alerts that resolved after sustained recovery",
    "alert.firing": "Rules currently in the firing state",
    "alert.pending": "Rules currently pending (condition true, not yet sustained)",
    # advisor.* — the capacity advisor (horovod_tpu.alerts)
    "advisor.recommendations": "Capacity recommendation records emitted",
    "advisor.target_delta": "Signed replica delta of the last recommendation (+grow/-shrink)",
    # router.* — the multi-replica front door (horovod_tpu.router)
    "router.requests": "Requests received at the router front door",
    "router.routed.round_robin": "Requests placed by the round_robin policy",
    "router.routed.least_loaded": "Requests placed by the least_loaded policy",
    "router.routed.prefix_affinity": "Requests placed by the prefix_affinity policy",
    "router.affinity_hit_tokens": "Tokens of shadow-index prefix shared with the chosen replica",
    "router.affinity_fallbacks": "Prefix-affinity choices overridden by the load-imbalance fallback",
    "router.sheds": "Requests REJECTED by router admission control (goodput / free-KV floors)",
    "router.failovers": "In-flight requests re-enqueued to survivors after a replica loss",
    "router.replica_deaths": "Replica healthy-to-dead transitions observed by the router",
    "router.replica_revives": "Dead HTTP replicas returned to routing after healthy probes",
    "router.replicas_healthy": "Replicas currently accepting routed requests",
    "router.inflight": "Routed requests not yet terminal, fleet-wide",
    "router.shadow_index_bytes": "Approximate host bytes of the per-replica shadow prefix indexes",
    "router.journal_appends": "Records durably appended to the request-journal WAL",
    "router.journal_errors": "Journal appends lost to a write fault (request still served)",
    "router.journal_replays": "Incomplete journaled requests re-submitted after a router restart",
    "router.journal_dedups": "Duplicate idempotency keys answered from the journaled result",
    "router.route_decision_s": "Seconds the routing policy spent choosing and booking a replica",
    "router.admission_s": "Seconds spent in router admission control per accepted-or-shed request",
    "router.journal_append_s": "Seconds appending the durable accept record to the journal WAL",
    "router.replica_queue_s": "Seconds between router submit and engine enqueue (replica inbox wait)",
    "router.e2e_s": "Seconds from router receive to terminal result, as the client observes",
    "router.failover_hops": "Failover replays one request took before reaching a terminal result",
    "router.poll_s": "Wall seconds one full poller pass took, probes through ticket reaping",
    "router.fleet_size": "Replicas currently in the routing candidate set, any health",
    "router.shadow_evictions": "Shadow-index digests evicted to honor the fleet-wide byte ceiling",
    # supervisor.* — the self-healing layer (horovod_tpu.supervisor)
    "supervisor.respawns": "Dead replicas respawned by the supervisor",
    "supervisor.respawn_failures": "Respawn attempts that failed (fault or factory error)",
    "supervisor.permanent_deaths": "Replicas circuit-broken to permanent-dead after exhausting restarts",
    "supervisor.warm_prefixes": "Hot prompts replayed into a fresh engine to rewarm its prefix cache",
    # autoscaler.* — the advisor-driven elastic actuator (horovod_tpu.autoscaler)
    "autoscaler.epoch": "Fleet membership generation (bumped on every join/leave)",
    "autoscaler.actions": "Actuations initiated (scale-up joins plus scale-down cordons)",
    "autoscaler.scale_ups": "Replicas added to the fleet by the autoscaler",
    "autoscaler.scale_downs": "Replicas retired from the fleet after a zero-drop drain",
    "autoscaler.holds": "Recommendations not actuated (hold advice, guards, or a degraded action)",
    "autoscaler.hold_faults": "Actuations degraded to hold by a serve.autoscale fault",
    "autoscaler.cordons": "Replicas cordoned out of routing pending drain",
    "autoscaler.draining": "Replicas currently cordoned and draining in-flight work",
    "autoscaler.replicas_target": "Fleet size the last actuation drove toward",
    # trace.* — the causal span-tree plane (horovod_tpu.tracing)
    "trace.sampled": "Requests head-sampled into the tracing plane at a root",
    "trace.spans": "Closed trace.span records emitted to the event log",
    # serve.mfu / device.* — the device telemetry plane
    # (horovod_tpu.device_telemetry): XLA cost model, compile ledger,
    # HBM polling, and the transfer/dispatch split.  The conditional
    # gauges (serve.mfu, device.bytes_in_use, ...) are minted only when
    # their value is honestly known — absent beats a fabricated zero.
    "serve.mfu": "Windowed achieved model FLOPs over the platform peak (absent when no peak is known)",
    "serve.arithmetic_intensity": "Windowed cost-model FLOPs per byte accessed across dispatched programs",
    "device.compiles": "XLA program compilations observed (AOT captures plus sentry-detected retraces)",
    "device.compile_s": "Seconds one XLA program compilation took (AOT capture wall time)",
    "device.model_flops": "Cost-model FLOPs dispatched to the device across all pinned programs",
    "device.h2d_bytes": "Host-to-device bytes of per-call program arguments stamped at dispatch",
    "device.d2h_bytes": "Device-to-host bytes read back at the device_sync boundary",
    "device.bytes_in_use": "Device memory in use per memory_stats() (absent when the backend has none)",
    "device.peak_bytes_in_use": "High-water device memory per memory_stats() (absent when the backend has none)",
    "device.hbm_used_fraction": "bytes_in_use over bytes_limit (absent without a device memory limit)",
    "device.overlap_headroom_pct": "Windowed predicted device-compute share of wall time (the double-buffering ceiling)",
    "device.peak_flops_known": "1 when the platform peak-FLOPs table (or override) knows this device, else 0",
}


# ---------------------------------------------------------------------------
# Instruments.
# ---------------------------------------------------------------------------


class _Gen:
    """A shared mutation-generation cell: every instrument write bumps
    ``n`` (under the instrument's lock), so a renderer can cache its
    output keyed on the generation it rendered and serve the cached text
    until ANY instrument changes.  Registry-created instruments share
    the registry's cell; standalone instruments get a private one."""

    __slots__ = ("n",)

    def __init__(self) -> None:
        self.n = 0


class Counter:
    """A monotonically increasing integer (Prometheus ``counter``)."""

    __slots__ = ("name", "_lock", "_gen", "_value")
    _GUARDED_BY_LOCK = ("_value",)

    def __init__(self, name: str, lock: threading.Lock,
                 gen: _Gen | None = None):
        self.name = name
        self._lock = lock
        self._gen = gen if gen is not None else _Gen()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        with self._lock:
            self._value += n
            self._gen.n += 1

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """A last-value-wins float (Prometheus ``gauge``)."""

    __slots__ = ("name", "_lock", "_gen", "_value")
    _GUARDED_BY_LOCK = ("_value",)

    def __init__(self, name: str, lock: threading.Lock,
                 gen: _Gen | None = None):
        self.name = name
        self._lock = lock
        self._gen = gen if gen is not None else _Gen()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)
            self._gen.n += 1

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


def log_bucket_bounds(lo: float = 1e-6, hi: float = 1e3,
                      per_decade: int = 3) -> tuple[float, ...]:
    """Fixed log-spaced bucket upper bounds: ``per_decade`` buckets per
    decade from ``lo`` to ``hi`` inclusive.  The default (1 µs → 1000 s,
    3/decade → 28 bounds) bounds every latency this stack measures with
    <= 10^(1/3) ≈ 2.15x relative quantile error — coarse, but fixed:
    histograms from any two processes/runs merge bucket-for-bucket."""
    if not (0 < lo < hi):
        raise ValueError(f"need 0 < lo < hi, got {lo}, {hi}")
    n = int(round(math.log10(hi / lo) * per_decade))
    return tuple(lo * 10 ** (i / per_decade) for i in range(n + 1))


def percentile_from_buckets(bounds: tuple[float, ...] | list[float],
                            counts: list[int], count: int,
                            mn: float, mx: float, q: float) -> float:
    """Estimate the ``q``-quantile from fixed-bucket counts; 0.0 when
    empty.  This is THE quantile code path — :class:`Histogram` and
    :func:`horovod_tpu.monitor.merge_snapshots` both call it, which is
    what makes a merged fleet histogram's p50/p90/p99 bit-identical to a
    single-process histogram over the union of observations."""
    if count == 0:
        return 0.0
    rank = q * count
    cum = 0.0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if cum + c >= rank:
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i] if i < len(bounds) else mx
            frac = (rank - cum) / c
            est = lo + (hi - lo) * max(frac, 0.0)
            return min(max(est, mn), mx)
        cum += c
    return mx


class Histogram:
    """Fixed-log-bucket histogram with quantile estimation.

    ``bounds`` are bucket *upper* edges (ascending); one implicit
    overflow bucket catches everything above the last edge.  Quantiles
    interpolate linearly inside the resolved bucket and clamp to the
    exact observed min/max, so single-sample and narrow distributions
    report true values instead of bucket edges.
    """

    __slots__ = ("name", "bounds", "_lock", "_gen", "_counts", "_count",
                 "_sum", "_min", "_max", "_exemplars")
    _GUARDED_BY_LOCK = ("_counts", "_count", "_sum", "_min", "_max",
                        "_exemplars")

    def __init__(self, name: str, lock: threading.Lock,
                 bounds: tuple[float, ...] | None = None,
                 gen: _Gen | None = None):
        self.name = name
        self.bounds = tuple(bounds) if bounds else log_bucket_bounds()
        if list(self.bounds) != sorted(self.bounds):
            raise ValueError(f"histogram {name} bounds must ascend")
        self._lock = lock
        self._gen = gen if gen is not None else _Gen()
        self._counts = [0] * (len(self.bounds) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        # bucket index -> (trace_id, value): the OpenMetrics-style
        # exemplar store, lazily created so untraced histograms pay
        # nothing.  Last-write-wins per bucket — the p99 bucket always
        # links to the most recent trace that landed there.
        self._exemplars: dict[int, tuple[str, float]] | None = None

    def observe(self, v: float, exemplar: str | None = None) -> None:
        v = float(v)
        with self._lock:
            idx = bisect_left(self.bounds, v)
            self._counts[idx] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            if exemplar is not None:
                if self._exemplars is None:
                    self._exemplars = {}
                self._exemplars[idx] = (exemplar, v)
            self._gen.n += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, q: float) -> float:
        """Estimate the ``q``-quantile (``q`` in [0, 1]) from the bucket
        counts; 0.0 when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        with self._lock:
            return self._percentile_locked(q)

    def _percentile_locked(self, q: float) -> float:
        return percentile_from_buckets(self.bounds, self._counts,
                                       self._count, self._min, self._max, q)

    def snapshot(self) -> dict:
        """Schema-stable summary: count/sum/min/max + p50/p90/p99, plus
        the raw ``buckets`` counts and their ``bounds`` — the mergeable
        form :func:`horovod_tpu.monitor.merge_snapshots` sums exactly
        (one extra slot past ``bounds`` is the overflow bucket)."""
        with self._lock:
            return self._snapshot_locked()

    def _snapshot_locked(self) -> dict:
        # The registry calls this directly inside ITS lock pass — the
        # instrument lock IS the registry lock there, and a plain Lock
        # re-taken would wedge.
        if self._count == 0:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "p50": 0.0, "p90": 0.0, "p99": 0.0,
                    "buckets": list(self._counts),
                    "bounds": list(self.bounds)}
        snap = {
            "count": self._count,
            "sum": self._sum,
            "min": self._min,
            "max": self._max,
            "p50": self._percentile_locked(0.50),
            "p90": self._percentile_locked(0.90),
            "p99": self._percentile_locked(0.99),
            "buckets": list(self._counts),
            "bounds": list(self.bounds),
        }
        if self._exemplars:
            # keyed by the bucket's le edge label ("+Inf" for overflow)
            # so readers need no index arithmetic; absent entirely when
            # no traced observation ever landed (schema-stable default).
            snap["exemplars"] = {
                (f"{self.bounds[i]:g}" if i < len(self.bounds)
                 else "+Inf"): {"trace_id": tid, "value": v}
                for i, (tid, v) in sorted(self._exemplars.items())}
        return snap


# ---------------------------------------------------------------------------
# Rank identity (stamped onto event-log records and state dumps).
# ---------------------------------------------------------------------------

# This module imports nothing from horovod_tpu, so the rank arrives by
# push: ``basics.init()`` calls ``set_rank()`` once the mesh is up.
# Before that (or in single-process tests) the launcher env var is the
# best available answer, matching jax.distributed's process index.
_RANK_LOCK = threading.Lock()
_RANK: int | None = None


def set_rank(r: int | None) -> None:
    """Pin the rank stamped on event-log records (``basics.init()`` /
    ``shutdown()`` call this; tests may too)."""
    global _RANK
    with _RANK_LOCK:
        _RANK = None if r is None else int(r)


def current_rank() -> int:
    """The rank identity for log attribution: the value ``set_rank()``
    pinned, else ``HOROVOD_TPU_PROCESS_ID`` from the launcher, else 0."""
    with _RANK_LOCK:
        if _RANK is not None:
            return _RANK
    try:
        return int(os.environ.get("HOROVOD_TPU_PROCESS_ID", "0"))
    except ValueError:
        return 0


# ---------------------------------------------------------------------------
# Structured event log (JSONL).
# ---------------------------------------------------------------------------


class EventLog:
    """Append-only JSONL event sink: one JSON object per line, each
    stamped with the ``(wall_s, mono_s)`` clock pair (``ts`` is the
    wall-clock half, kept under its original key; ``mono_s`` is
    ``time.monotonic()`` so cross-rank tools can align on monotonic
    deltas when wall clocks skew) plus ``kind`` and the emitter's
    fields.  Flushed per line — a crashed process leaves a readable log
    up to its last event (the postmortem property the engine watchdog
    counts on).  Thread-safe.

    The sink is size-bounded: past ``max_mb`` (default from
    ``HVD_TORCH_EVENT_LOG_MAX_MB``; unset/0 = unbounded) the file rotates
    to ``<path>.1``, keeping one generation.  :meth:`read` spans the
    rotation boundary and stays torn-line tolerant in both
    generations."""

    _GUARDED_BY_LOCK = ("_file", "_bytes")

    def __init__(self, path: str, max_mb: float | None = None):
        self.path = path
        if max_mb is None:
            raw = os.environ.get("HVD_TORCH_EVENT_LOG_MAX_MB", "")
            try:
                max_mb = float(raw) if raw else 0.0
            except ValueError:
                max_mb = 0.0
        self.max_bytes = int(max_mb * 1024 * 1024) if max_mb > 0 else 0
        self._lock = threading.Lock()
        dirname = os.path.dirname(path)
        if dirname:
            os.makedirs(dirname, exist_ok=True)
        self._file: IO[str] | None = open(path, "a")
        try:
            self._bytes = os.path.getsize(path)
        except OSError:
            self._bytes = 0

    def emit(self, kind: str, **fields: Any) -> None:
        line = json.dumps({"ts": time.time(),
                           "mono_s": time.monotonic(), "kind": kind,
                           "rank": current_rank(), "pid": os.getpid(),
                           **fields})
        with self._lock:
            if self._file is None:
                return
            self._file.write(line + "\n")
            self._file.flush()
            self._bytes += len(line) + 1
            if self.max_bytes and self._bytes > self.max_bytes:
                self._rotate_locked()

    def _rotate_locked(self) -> None:
        """Roll the current file to ``<path>.1`` (replacing any prior
        generation) and start fresh.  Best-effort: a failed rename
        keeps appending to the oversized file rather than losing
        events."""
        assert self._file is not None
        self._file.close()
        try:
            os.replace(self.path, self.path + ".1")
            self._bytes = 0
        except OSError:
            pass
        self._file = open(self.path, "a")

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None

    @staticmethod
    def read(path: str) -> list[dict]:
        """Parse a JSONL event log (test/replay helper), including the
        rotated ``<path>.1`` generation when present (oldest first).
        A torn line (writer died mid-write, or mid-rotation) is
        dropped, not fatal."""
        out = []
        for p in (path + ".1", path):
            if p.endswith(".1") and not os.path.exists(p):
                continue
            with open(p) as f:
                for ln in f:
                    ln = ln.strip()
                    if not ln:
                        continue
                    try:
                        out.append(json.loads(ln))
                    except json.JSONDecodeError:
                        continue
        return out


_ENV_LOG_LOCK = threading.Lock()
_ENV_LOGS: dict[str, EventLog] = {}


def env_event_log() -> EventLog | None:
    """The shared ``HVD_TORCH_EVENT_LOG`` sink, or None when unset.  One
    :class:`EventLog` per path for the process lifetime, shared by every
    registry resolving ``event_log="auto"`` — so concurrent emitters
    serialize on one lock instead of interleaving file appends."""
    path = os.environ.get("HVD_TORCH_EVENT_LOG")
    if not path:
        return None
    with _ENV_LOG_LOCK:
        log = _ENV_LOGS.get(path)
        if log is None:
            log = _ENV_LOGS[path] = EventLog(path)
        return log


# ---------------------------------------------------------------------------
# The registry.
# ---------------------------------------------------------------------------


def _prom_name(name: str) -> str:
    """Prometheus metric names allow [a-zA-Z0-9_:] — dots become
    underscores (``serve.ttft_s`` → ``serve_ttft_s``)."""
    return "".join(c if (c.isalnum() or c in "_:") else "_" for c in name)


def escape_label_value(v: str) -> str:
    """Escape a label VALUE per the Prometheus 0.0.4 exposition spec:
    backslash, double-quote, and line-feed must be escaped inside the
    ``name="value"`` quotes."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    """Escape a ``# HELP`` docstring per the 0.0.4 spec: backslash and
    line-feed only (quotes are legal in help text)."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


class MetricsRegistry:
    """Thread-safe, process-local home for counters/gauges/histograms.

    Instruments are get-or-create by name (a name is permanently one
    type; reusing it as another raises).  ``event_log`` controls the
    structured-event sink: the default ``"auto"`` resolves
    ``HVD_TORCH_EVENT_LOG`` at each emit (so tests can monkeypatch the
    env mid-process), ``None`` disables events, and an explicit
    :class:`EventLog` pins one.
    """

    _GUARDED_BY_LOCK = ("_counters", "_gauges", "_histograms",
                        "_prom_cache", "_prom_gen")

    def __init__(self, event_log: "EventLog | None | str" = "auto"):
        # ONE lock and ONE generation cell shared by every instrument
        # this registry creates: snapshot()/to_prometheus() take a
        # single lock pass over a frozen registry instead of one
        # acquisition per metric, and any instrument write bumps the
        # shared generation, invalidating the cached Prometheus text.
        self._lock = threading.Lock()
        self._gen = _Gen()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._prom_cache: str | None = None
        self._prom_gen = -1
        self._event_log = event_log

    def _get(self, table: dict, name: str, factory) -> Any:
        with self._lock:
            inst = None
            for t in (self._counters, self._gauges, self._histograms):
                if name in t:
                    inst = t[name]
                    break
            if inst is None:
                inst = table[name] = factory()
            elif table.get(name) is not inst:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, name,
                         lambda: Counter(name, self._lock, self._gen))

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, name,
                         lambda: Gauge(name, self._lock, self._gen))

    def histogram(self, name: str,
                  bounds: tuple[float, ...] | None = None) -> Histogram:
        return self._get(
            self._histograms, name,
            lambda: Histogram(name, self._lock, bounds, self._gen))

    # -- events ------------------------------------------------------------

    def active_event_log(self) -> "EventLog | None":
        """The sink ``event()`` would write to right now (resolving the
        ``"auto"`` env indirection), or None."""
        log = self._event_log
        if log == "auto":
            log = env_event_log()
        return log

    def event(self, kind: str, **fields: Any) -> None:
        """Emit one structured event to the configured sink (no-op when
        no sink is configured)."""
        log = self.active_event_log()
        if log is not None:
            log.emit(kind, **fields)

    # -- export ------------------------------------------------------------

    def snapshot(self) -> dict:
        """Plain nested dict of every instrument — JSON-serializable,
        schema-stable (``counters`` / ``gauges`` / ``histograms`` with
        count/sum/min/max/p50/p90/p99 each).  One lock pass: instruments
        share the registry lock, so holding it freezes the whole
        registry and the fields are read directly."""
        with self._lock:
            return {
                "counters": {n: c._value
                             for n, c in sorted(self._counters.items())},
                "gauges": {n: g._value
                           for n, g in sorted(self._gauges.items())},
                "histograms": {n: h._snapshot_locked()
                               for n, h in sorted(self._histograms.items())},
            }

    def to_prometheus(self) -> str:
        """Prometheus text exposition format, version 0.0.4: ``# HELP``
        (from :data:`METRIC_HELP`) and ``# TYPE`` lines plus samples;
        histograms render cumulative ``_bucket`` series with ``le``
        labels, ``_sum`` and ``_count``.  Label values are escaped per
        the spec via :func:`escape_label_value`.

        The rendered text is cached keyed on the registry's mutation
        generation: consecutive scrapes of an unchanged registry return
        the same string with zero render work (the monitor-overhead
        fix).  The shared lock makes the pairing exact — no instrument
        can move while the render reads it."""
        with self._lock:
            if (self._prom_cache is not None
                    and self._prom_gen == self._gen.n):
                return self._prom_cache
            lines: list[str] = []

            def _head(name: str, pn: str, kind: str) -> None:
                help_text = METRIC_HELP.get(name)
                if help_text:
                    lines.append(f"# HELP {pn} {_escape_help(help_text)}")
                lines.append(f"# TYPE {pn} {kind}")

            for name, c in sorted(self._counters.items()):
                pn = _prom_name(name)
                _head(name, pn, "counter")
                lines.append(f"{pn} {c._value}")
            for name, g in sorted(self._gauges.items()):
                pn = _prom_name(name)
                _head(name, pn, "gauge")
                lines.append(f"{pn} {g._value:g}")
            for name, h in sorted(self._histograms.items()):
                pn = _prom_name(name)
                _head(name, pn, "histogram")
                cum = 0
                ex = h._exemplars or {}
                for i, (edge, c) in enumerate(zip(h.bounds, h._counts)):
                    cum += c
                    le = escape_label_value(f"{edge:g}")
                    line = f'{pn}_bucket{{le="{le}"}} {cum}'
                    if i in ex:
                        tid, v = ex[i]
                        line += (f' # {{trace_id="'
                                 f'{escape_label_value(tid)}"}} {v:g}')
                    lines.append(line)
                line = f'{pn}_bucket{{le="+Inf"}} {h._count}'
                if len(h.bounds) in ex:
                    tid, v = ex[len(h.bounds)]
                    line += (f' # {{trace_id="'
                             f'{escape_label_value(tid)}"}} {v:g}')
                lines.append(line)
                lines.append(f"{pn}_sum {h._sum:g}")
                lines.append(f"{pn}_count {h._count}")
            text = "\n".join(lines) + "\n"
            self._prom_cache = text
            self._prom_gen = self._gen.n
            return text

    def approx_footprint_bytes(self) -> int:
        """Approximate host memory the registry itself holds (the
        ``mem.registry_bytes`` gauge): instruments, their name strings,
        and histogram bucket arrays — shallow ``sys.getsizeof`` sums, an
        accounting estimate rather than a deep audit."""
        with self._lock:
            total = (sys.getsizeof(self._counters)
                     + sys.getsizeof(self._gauges)
                     + sys.getsizeof(self._histograms))
            for c in self._counters.values():
                total += sys.getsizeof(c) + sys.getsizeof(c.name)
            for g in self._gauges.values():
                total += sys.getsizeof(g) + sys.getsizeof(g.name)
            for h in self._histograms.values():
                total += (sys.getsizeof(h) + sys.getsizeof(h.name)
                          + sys.getsizeof(h.bounds)
                          + sys.getsizeof(h._counts)
                          + 28 * len(h._counts))   # the int cells
            if self._prom_cache is not None:
                total += sys.getsizeof(self._prom_cache)
            return total


class _NullCounter(Counter):
    __slots__ = ()

    def inc(self, n: int = 1) -> None:
        pass


class _NullGauge(Gauge):
    __slots__ = ()

    def set(self, v: float) -> None:
        pass


class _NullHistogram(Histogram):
    __slots__ = ()

    def observe(self, v: float, exemplar: str | None = None) -> None:
        pass


class NullRegistry(MetricsRegistry):
    """A registry whose instruments discard everything — attach it to
    measure the cost of instrumentation itself (the bench's metrics-off
    arm), or to silence a hot path without if-guards at every site."""

    def __init__(self):
        super().__init__(event_log=None)

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, name,
                         lambda: _NullCounter(name, self._lock, self._gen))

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, name,
                         lambda: _NullGauge(name, self._lock, self._gen))

    def histogram(self, name: str,
                  bounds: tuple[float, ...] | None = None) -> Histogram:
        return self._get(
            self._histograms, name,
            lambda: _NullHistogram(name, self._lock, bounds, self._gen))

    def event(self, kind: str, **fields: Any) -> None:
        pass


#: The shared process-local registry: the eager collectives engine,
#: ``basics`` negotiation, and default-constructed ServeEngines all feed
#: this one, so a single scrape sees training and serving together.
DEFAULT = MetricsRegistry()

#: The no-op twin (overhead measurement / explicit opt-out).
NULL = NullRegistry()


# ---------------------------------------------------------------------------
# Per-request tracing.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Trace:
    """One request's span through the serving stack, surfaced on
    ``RequestResult.trace``.  Timestamps are ``time.monotonic`` seconds
    (comparable within the process; durations exact); ``*_step`` fields
    are engine step indices.  ``None`` timestamp = the request never
    reached that state (e.g. ``admit_ts`` stays None on a queue-side
    REJECTED/TIMEOUT result)."""

    rid: int
    enqueue_ts: float
    enqueue_step: int
    admit_ts: float | None = None
    admit_step: int | None = None
    first_token_ts: float | None = None
    terminal_ts: float | None = None
    terminal_step: int | None = None
    status: str | None = None
    n_tokens: int = 0
    prefill_chunks: int = 0
    preemptions: int = 0
    retries: int = 0
    prefix_tokens_skipped: int = 0
    queue_steps: int = 0
    # Causal-tracing identity (None on unsampled requests): the trace
    # this request belongs to, its own serve.request span, and the
    # propagated parent (a router replica.attempt span, or None on an
    # engine-origin root).  See horovod_tpu.tracing.
    trace_id: str | None = None
    span_id: str | None = None
    parent_span_id: str | None = None

    @property
    def queue_wait_s(self) -> float | None:
        """Enqueue → first admission (None while queued)."""
        if self.admit_ts is None:
            return None
        return self.admit_ts - self.enqueue_ts

    @property
    def ttft_s(self) -> float | None:
        """Enqueue → first emitted token (None if none was emitted)."""
        if self.first_token_ts is None:
            return None
        return self.first_token_ts - self.enqueue_ts

    @property
    def e2e_s(self) -> float | None:
        """Enqueue → terminal state (None while live)."""
        if self.terminal_ts is None:
            return None
        return self.terminal_ts - self.enqueue_ts

    @property
    def tpot_s(self) -> float | None:
        """Time per output token after the first (decode cadence);
        None until the request terminates with >= 2 tokens."""
        if (self.terminal_ts is None or self.first_token_ts is None
                or self.n_tokens < 2):
            return None
        return ((self.terminal_ts - self.first_token_ts)
                / (self.n_tokens - 1))

    def to_dict(self) -> dict:
        """JSON-serializable form: every field plus the derived
        latencies (the shape the event log and dashboards consume)."""
        d = dataclasses.asdict(self)
        d.update(queue_wait_s=self.queue_wait_s, ttft_s=self.ttft_s,
                 e2e_s=self.e2e_s, tpot_s=self.tpot_s)
        return d
