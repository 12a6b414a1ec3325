"""Continuous-batching decode engine: slot recycling over a paged KV pool.

Port of ``horovod_tpu/serving_scheduler.py`` (``ServeEngine`` with
``SchedulerEvent``, ``_QueueEntry`` and ``_Slot``).  :class:`ServeEngine`
serves a queue of greedy requests (Orca OSDI '22 / vLLM SOSP '23):

* a **request queue** feeding a slot table: a finished row's slot and
  cache blocks are recycled for the next queued request on the next step;
* **chunked prefill interleaved with decode**: admission runs one
  fixed-width prompt window per step, between decode ticks;
* a **paged KV cache** (:class:`~horovod_tpu_torch.models.llama.PagedKVCache`):
  admission allocates only the blocks a request needs, retirement returns
  them; the pool, its tables and lengths are written in place, never
  copied;
* **fixed shapes**: every device program (``tick``, ``chunk``,
  ``set_row``, ``spec_tick``) sees one argument signature for the life of
  the server, since admission and retirement change table *data*, never
  shapes.  The reference pins this with the jit cache; the port runs
  eagerly and counts the distinct signatures each program has been called
  with (:meth:`ServeEngine.compile_cache_sizes`), the invariant CUDA-graph
  capture will rest on.

Request lifecycle and fault tolerance, as the reference: typed
:class:`~horovod_tpu_torch.serving.RequestResult` statuses (``OK /
TIMEOUT / CANCELLED / FAILED / REJECTED``); ``cancel`` in any state;
deadlines and step-counted queue budgets; KV-pressure preemption with
replay under a pluggable :mod:`~horovod_tpu_torch.scheduling` policy;
poison-request quarantine with bounded, backed-off retries; fault sites
``serve.admit`` / ``serve.prefill`` / ``serve.tick`` / ``serve.cache`` /
``serve.draft`` (:mod:`horovod_tpu_torch.faults`); a no-progress watchdog
that raises with a state dump.  Shared-prefix KV reuse
(``prefix_cache=True``, :mod:`horovod_tpu_torch.prefix_cache`) and
self-drafting speculation (``spec=True``, :mod:`horovod_tpu_torch.drafting`
and :func:`~horovod_tpu_torch.models.llama.spec_verify_paged`) change
block-table data and the tick's width, never outputs.

Scheduler invariants:

1. *Write-before-read*: a row's blocks hold garbage beyond its length;
   every reader masks past the length and every writer writes a position
   before anything attends to it.  Free rows tick along with the batch and
   scatter into the trash block (block 0).
2. *Row independence*: attention never crosses rows, so each request's
   greedy output is its solo ``llama.generate`` output, whatever the
   admission order, preemption victim or cache hits.
3. *Fixed signature*: host state makes every decision; device programs
   only ever see [n_slots]-shaped data.

Each tick reads the device once (the emitted tokens, and on a spec engine
the accepted counts with them); the tick's inputs go up from pinned host
memory without a wait.

Measurement planes, as the reference's: the live exporter
(:mod:`~horovod_tpu_torch.monitor`), the time-series sampler and the alert
rules with the capacity advisor (:mod:`~horovod_tpu_torch.timeseries`,
:mod:`~horovod_tpu_torch.alerts`, on by default at 1 s), causal-tracing
spans (:mod:`~horovod_tpu_torch.tracing`) and device telemetry
(:mod:`~horovod_tpu_torch.device_telemetry`: counted FLOPs and bytes per
program, ``serve.mfu``, the HBM gauges and the ``device_sync`` split).
The reference keeps its telemetry plane at ``engine.device``; here
``device`` is the torch device and the plane is ``device_telemetry``.

:func:`measure_throughput`, :func:`measure_prefix_throughput` and
:func:`measure_spec_throughput` are the bench arms; the reference's
``measure_tp_throughput`` waits for tensor-parallel serving.
Tensor-parallel serving (``tp_size > 1``, ROADMAP item 12b) raises
``NotImplementedError``.  The engine is greedy-only; sampling pools stay
on :class:`~horovod_tpu_torch.serving.ContinuousBatcher`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Any

import numpy as np
import torch
from torch.utils import _pytree as pytree

from horovod_tpu_torch import alerts as alerts_mod
from horovod_tpu_torch import device_telemetry as device_telemetry_mod
from horovod_tpu_torch import drafting as drafting_mod
from horovod_tpu_torch import faults as faults_mod
from horovod_tpu_torch import metrics as metrics_mod
from horovod_tpu_torch import monitor as monitor_mod
from horovod_tpu_torch import profiler as profiler_mod
from horovod_tpu_torch import scheduling as scheduling_mod
from horovod_tpu_torch import timeseries as timeseries_mod
from horovod_tpu_torch import tracing as tracing_mod
from horovod_tpu_torch.metrics import Trace
from horovod_tpu_torch.models import llama
from horovod_tpu_torch.prefix_cache import RadixPrefixCache
from horovod_tpu_torch.serving import (
    CANCELLED, FAILED, OK, REJECTED, TIMEOUT, Request, RequestResult,
)

FREE, PREFILL, DECODE = "free", "prefill", "decode"


@dataclasses.dataclass
class SchedulerEvent:
    """One scheduler decision, for tests/telemetry: ``kind`` is
    ``"admit"``, ``"hit"`` (admission with a prefix-cache match),
    ``"recycle"`` (OK retirement), ``"preempt"``, ``"retry"``,
    ``"cancel"``, ``"timeout"``, ``"reject"`` or ``"fail"``; ``step``
    the engine step index; ``slot`` is -1 for queue-side events
    (reject, queued cancel/timeout, admit retry)."""

    kind: str
    step: int
    slot: int
    request_id: int


@dataclasses.dataclass
class _QueueEntry:
    """A queued request plus its lifecycle state.  ``prior`` holds
    tokens already emitted before a preemption/replay re-queue (the
    replay prompt is ``req.prompt + prior``); ``wait_steps`` is the
    step-counted retry backoff; ``deadline`` is absolute monotonic."""

    rid: int
    req: Request
    prior: list[int] = dataclasses.field(default_factory=list)
    retries: int = 0
    wait_steps: int = 0
    queued_steps: int = 0
    deadline: float | None = None
    slo_deadline: float | None = None    # enqueue + slo_s (EDF policy)


@dataclasses.dataclass
class _Slot:
    state: str = FREE
    request_id: int = -1
    padded: np.ndarray | None = None     # [1, n_win * chunk] prompt
    n_win: int = 0
    w_done: int = 0
    true_len: int = 0
    budget: int = 0
    eos: int | None = None
    out: list[int] = dataclasses.field(default_factory=list)
    n_blocks: int = 0                    # blocks mapped by this slot
    blocks: list[int] = dataclasses.field(default_factory=list)
    base: int = 0                        # cached-prefix positions skipped
    n_hit: int = 0                       # leading shared (hit) blocks
    req: Request | None = None           # original request (for replay)
    prior: list[int] = dataclasses.field(default_factory=list)
    retries: int = 0
    wait_steps: int = 0                  # prefill-retry backoff
    deadline: float | None = None
    slo_deadline: float | None = None    # enqueue + slo_s (EDF policy)
    admit_seq: int = -1                  # monotonic; max = youngest row
    draft: "drafting_mod.NgramDraftState | None" = None


# ---------------------------------------------------------------------------
# Device programs.
# ---------------------------------------------------------------------------


def _signature(x) -> Any:
    """What a compiled program would be keyed on: each tensor's shape,
    dtype and device, the type of every other leaf."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype, x.device)
    if isinstance(x, dict):
        return tuple((k, _signature(v)) for k, v in x.items())
    if isinstance(x, (tuple, list)):
        return tuple(_signature(v) for v in x)
    return type(x)


class _Program:
    """One of the engine's device programs: a plain function plus the set
    of argument signatures it has been called with (the port's stand-in
    for a jit cache; one signature is what a captured CUDA graph needs)."""

    def __init__(self, fn):
        self.fn = fn
        self.signatures: set = set()

    def __call__(self, *args):
        self.signatures.add(_signature(args))
        return self.fn(*args)


class ServeEngine:
    """Serve a queue of greedy requests through a recycled slot pool.

    ``n_slots``: decode batch width.  ``max_len``: per-request logical
    depth bound (prompt + generation).  ``chunk``: the chunked-prefill
    window: one [1, chunk] prompt window runs per step per admitting
    slot.  ``block_size`` (default: ``chunk``) and ``n_blocks`` size the
    paged pool; the default fully backs every slot, smaller pools
    overcommit and admission waits for free blocks.  The pool lives on
    the parameters' device.  ``timeline``: an optional object with the
    reference's ``horovod_tpu.timeline.Timeline`` methods (``instant``,
    ``counter``, ``async_start``, ``async_end``, ``async_span``) receiving
    admit/recycle instants and per-step ``SCHED`` / ``LIFECYCLE`` /
    ``SPEC`` / ``PREFIX`` counters.

    ``preempt_after``: consecutive steps the queue head may starve on an
    overcommitted pool before the policy's victim row is preempted and
    re-queued for replay (``None`` disables preemption).
    ``max_retries``: bounded retries for transient per-request faults
    (prefill windows retry in place after a ``2**retries``-step backoff;
    decode readback retries re-queue through the replay path); once
    exhausted, or at once on a
    :class:`~horovod_tpu_torch.faults.PermanentFault`, the request ends
    ``FAILED`` with the exception attached.  ``watchdog_steps``:
    consecutive no-progress steps before ``step()`` raises
    ``RuntimeError`` with a state dump.  ``faults``: a
    :class:`~horovod_tpu_torch.faults.FaultRegistry` (default: the shared
    one, a no-op unless armed).

    ``metrics``: a :class:`~horovod_tpu_torch.metrics.MetricsRegistry`
    fed every step (TTFT / TPOT / queue-wait / e2e histograms, lifecycle
    counters, KV-pool and prefix-cache gauges; one event per state
    transition when it has an event log, ``HVD_TORCH_EVENT_LOG``).
    Defaults to :data:`horovod_tpu_torch.metrics.DEFAULT`; pass ``NULL``
    to opt out.  ``slo_window`` / ``slo_e2e_s`` size the goodput window.
    ``profile`` (``None`` reads ``HVD_TORCH_PROFILE=1``) turns on the
    per-tick :class:`~horovod_tpu_torch.profiler.TickProfiler`.

    ``prefix_cache``: transparent shared-prefix KV reuse (radix-indexed,
    ref-counted blocks); ``HVD_TORCH_VERIFY_BLOCKS=1`` walks the block
    tables after every step asserting refcount consistency (a debug aid;
    it reads the tables back from the device).  ``spec`` / ``draft_k``:
    self-drafting speculative decode, one ``(draft_k + 1)``-wide verify
    program replacing the tick (``None`` reads ``HVD_TORCH_SPEC`` /
    ``HVD_TORCH_DRAFT_K``: off / 4).  ``policy``: a
    :class:`~horovod_tpu_torch.scheduling.SchedulerPolicy`, a name
    (``fifo`` / ``priority`` / ``edf``) or ``None`` for
    ``HVD_TORCH_SCHED_POLICY``.

    ``tp_size`` (``None`` reads ``HVD_TORCH_TP``, default 1) must be 1:
    tensor-parallel serving is not ported.

    The measurement planes take the reference's values: ``None`` reads the
    environment, ``False`` turns the plane off, an instance is used as it
    is.  ``monitor``: an int binds a
    :class:`~horovod_tpu_torch.monitor.MonitorServer` on that port (0 =
    any free one; ``None`` reads ``HVD_TORCH_MONITOR_PORT``, unset = off).
    ``sampler``: a :class:`~horovod_tpu_torch.timeseries.MetricsSampler`
    ticked every step (``None``: every ``HVD_TORCH_SAMPLE_S`` seconds,
    default 1.0, ``<= 0`` off); ``alerts``: an
    :class:`~horovod_tpu_torch.alerts.AlertManager` over it (``None``:
    ``HVD_TORCH_ALERTS``, default on), and a capacity advisor rides along
    with any sampler.  ``device_telemetry``: ``True`` (or
    ``HVD_TORCH_DEVICE_TELEMETRY=1``) counts every program's FLOPs and
    bytes at construction and reports ``serve.mfu``, the HBM gauges and
    the ``device_sync`` split (:mod:`~horovod_tpu_torch.device_telemetry`);
    the plane lives at ``self.device_telemetry``.  Tracing: a request's
    ``trace_ctx`` joins its caller's trace; otherwise
    ``HVD_TORCH_TRACE_SAMPLE`` head-samples engine roots keyed on the
    request id (seed ``HVD_TORCH_TRACE_SEED``).
    """

    def __init__(self, params: dict, cfg: llama.LlamaConfig, *,
                 n_slots: int, max_len: int, chunk: int,
                 block_size: int | None = None,
                 n_blocks: int | None = None,
                 tp_size: int | None = None,
                 timeline: Any = None,
                 preempt_after: int | None = None,
                 max_retries: int = 2,
                 watchdog_steps: int = 256,
                 faults: "faults_mod.FaultRegistry | None" = None,
                 metrics: "metrics_mod.MetricsRegistry | None" = None,
                 prefix_cache: bool = False,
                 monitor: Any = None,
                 slo_window: int = 256,
                 slo_e2e_s: float | None = None,
                 profile: bool | None = None,
                 profile_window: int | None = None,
                 spec: bool | None = None,
                 draft_k: int | None = None,
                 policy: "scheduling_mod.SchedulerPolicy | str | None"
                     = None,
                 sampler: Any = None,
                 alerts: Any = None,
                 device_telemetry: Any = None):
        if chunk < 1 or chunk > max_len:
            raise ValueError(f"chunk {chunk} must be in [1, max_len "
                             f"{max_len}]")
        if preempt_after is not None and preempt_after < 1:
            raise ValueError("preempt_after must be >= 1 (or None)")
        if watchdog_steps < 1:
            raise ValueError("watchdog_steps must be >= 1")
        block_size = chunk if block_size is None else block_size
        if tp_size is None:
            raw = os.environ.get("HVD_TORCH_TP", "")
            tp_size = int(raw) if raw else 1
        tp_size = int(tp_size)
        if tp_size < 1:
            raise ValueError(f"tp_size must be >= 1, got {tp_size}")
        if tp_size > 1:
            raise NotImplementedError(
                "tensor-parallel serving (tp_size > 1) is not ported yet; "
                "it joins sequence parallelism as a multi-rank item")
        self.tp_size = 1
        self.params = params
        self.cfg = cfg
        self.device = params["embed"].device
        self.n_slots = n_slots
        self.max_len = max_len
        self.chunk = chunk
        self.block_size = block_size
        self.timeline = timeline
        self.preempt_after = preempt_after
        self.max_retries = max_retries
        self.watchdog_steps = watchdog_steps
        self.faults = faults if faults is not None else faults_mod.DEFAULT
        self.metrics = metrics if metrics is not None else metrics_mod.DEFAULT
        self.policy = scheduling_mod.resolve_policy(policy)
        if spec is None:
            spec = os.environ.get("HVD_TORCH_SPEC", "") == "1"
        if draft_k is None:
            raw = os.environ.get("HVD_TORCH_DRAFT_K", "")
            draft_k = int(raw) if raw else drafting_mod.DEFAULT_DRAFT_K
        if spec and draft_k < 1:
            raise ValueError(f"draft_k must be >= 1, got {draft_k}")
        self.spec = bool(spec)
        self.draft_k = int(draft_k)
        self.spec_counters = {"rounds": 0, "row_rounds": 0,
                              "proposed": 0, "accepted": 0}
        if self.spec:
            # registered up front so spec snapshots are schema-stable
            self.metrics.counter("serve.spec.rounds")
            self.metrics.counter("serve.spec.row_rounds")
            self.metrics.counter("serve.spec.proposed")
            self.metrics.counter("serve.spec.accepted")
            self.metrics.counter("serve.spec.draft_faults")
            self.metrics.histogram("serve.spec.accepted_per_round")
        for h in ("serve.ttft_s", "serve.tpot_s", "serve.queue_wait_s",
                  "serve.e2e_s"):
            self.metrics.histogram(h)
        # Causal tracing: spans are emitted after the fact from the Trace
        # stamps, so with sampling off a request pays one None-check.
        self.tracer = tracing_mod.Tracer(self.metrics)
        self._trace_fraction = tracing_mod.env_sample_fraction()
        self._trace_seed = tracing_mod.env_trace_seed()
        if profile is None:
            profile = os.environ.get("HVD_TORCH_PROFILE", "") == "1"
        self.prof = (profiler_mod.TickProfiler(
            self.metrics, timeline=timeline, window=profile_window)
            if profile else None)
        if device_telemetry is False:
            self.device_telemetry = None
        elif device_telemetry is None:
            self.device_telemetry = device_telemetry_mod.maybe_telemetry(
                self.metrics, device=self.device)
        elif device_telemetry is True:
            self.device_telemetry = device_telemetry_mod.DeviceTelemetry(
                self.metrics, device=self.device)
        else:
            self.device_telemetry = device_telemetry
        # Retrace sentry: compile_cache_sizes() is diffed every step and
        # growth past one signature per program bumps serve.retrace
        # (fatal under HVD_TORCH_RETRACE_FATAL=1).
        self._retrace_fatal = os.environ.get(
            "HVD_TORCH_RETRACE_FATAL", "") == "1"
        self.metrics.counter("serve.retrace")
        self._t0 = time.monotonic()
        self._last_step_ts: float | None = None
        self.slo = monitor_mod.SLOWindow(window=slo_window,
                                         slo_e2e_s=slo_e2e_s)
        self._slo_targets: dict[int, float | None] = {}
        # Health plane: sampler and alert rules ticked from step(), no
        # threads; the capacity advisor rides along with any sampler.
        if sampler is False:
            self.sampler = None
        elif sampler is None:
            self.sampler = timeseries_mod.maybe_sampler(self.metrics)
        else:
            self.sampler = sampler
        if alerts is False or self.sampler is None:
            self.alerts = None
        elif alerts is None:
            self.alerts = alerts_mod.maybe_alerts(self.sampler, self.metrics)
        else:
            self.alerts = alerts
        self.advisor = (alerts_mod.CapacityAdvisor(
            self.sampler, alerts=self.alerts, registry=self.metrics)
            if self.sampler is not None else None)
        if monitor is False:
            self.monitor = None
        elif monitor is None:
            self.monitor = monitor_mod.maybe_start_monitor(self.metrics, self)
        elif isinstance(monitor, monitor_mod.MonitorServer):
            monitor.attach_engine(self)
            self.monitor = monitor
        elif isinstance(monitor, int) and monitor is not True:
            self.monitor = monitor_mod.MonitorServer(
                self.metrics, self, port=monitor).start()
        else:
            raise ValueError(
                f"monitor must be None / False / port int / "
                f"MonitorServer, got {monitor!r}")
        self.pcache = llama.init_paged_cache(
            cfg, n_slots, max_len, block_size=block_size,
            n_blocks=n_blocks, device=self.device)
        self.blocks_per_slot = self.pcache.block_table.shape[1]
        total = self.pcache.k.shape[1]
        self.pool = llama.BlockPool(total)
        # the SAME list object the pool allocates from (white-box tests
        # drain it to force block starvation)
        self._free_blocks = self.pool._free
        # one physical block holds block_size positions of K and V across
        # every layer
        kb = self.pcache.k
        self._block_bytes = (2 * kb.element_size() * kb.shape[0]
                             * kb.shape[2] * kb.shape[3] * kb.shape[4])
        self.metrics.gauge("kv.block_bytes").set(self._block_bytes)
        self.metrics.gauge("kv.total_bytes").set(self._block_bytes * total)
        # per-chip gauges equal the logical ones on one card; they exist
        # so scrapes keep the reference's schema
        self._shard_block_bytes = self._block_bytes
        self.metrics.gauge("tp.size").set(self.tp_size)
        self.metrics.gauge("kv.shard_block_bytes").set(
            self._shard_block_bytes)
        self.metrics.gauge("kv.shard_total_bytes").set(
            self._shard_block_bytes * total)
        self.prefix = (RadixPrefixCache(self.pool, block_size,
                                        metrics=self.metrics)
                       if prefix_cache else None)
        self.prefix_counters = {"hits": 0, "blocks_reused": 0,
                                "tokens_skipped": 0, "evictions": 0}
        self._verify_blocks = os.environ.get(
            "HVD_TORCH_VERIFY_BLOCKS", "") == "1"
        self._trash_row = np.zeros((self.blocks_per_slot,), np.int64)
        self.last_logits = torch.zeros((n_slots, cfg.vocab_size),
                                       dtype=torch.float32,
                                       device=self.device)
        self._slots = [_Slot() for _ in range(n_slots)]
        self._queue: list[_QueueEntry] = []
        self._next_id = 0
        self._admit_seq = 0
        self._starve_steps = 0
        self._idle_steps = 0
        self._finished: dict[int, RequestResult] = {}
        self.results: dict[int, RequestResult] = {}
        self.traces: dict[int, Trace] = {}
        self.events: list[SchedulerEvent] = []
        self.counters = {"preemptions": 0, "timeouts": 0,
                         "cancellations": 0, "rejections": 0,
                         "retries": 0, "failures": 0}
        self.step_index = 0

        def _tick(params, pcache, last_logits, active):
            # every row argmaxes its last logits and decodes one position;
            # `active` [B] gates the length advance so idle/prefilling
            # rows hold position (their garbage write lands in their own
            # blocks or trash: invariant 1)
            tok = torch.argmax(last_logits, dim=-1)
            logits, _ = llama.decode_chunk_paged(
                params, tok[:, None], cfg, pcache, advance=active)
            return tok, logits[:, 0]

        def _chunk(params, pcache, last_logits, toks, slot, new_len, sel):
            # one chunked-prefill window for one slot; `sel` picks the
            # window position whose logits seed decoding (only the final
            # window's pick survives)
            logits, _ = llama.decode_chunk_paged_row(
                params, toks, cfg, pcache, slot, new_length=new_len)
            last_logits[slot] = logits[0, sel]

        def _set_row(pcache, slot, row, length):
            # admission/retirement table write: which physical blocks a
            # slot row maps and its length (0, or the cached frontier on
            # a prefix-cache hit) — data only
            pcache.block_table[slot] = row
            pcache.length[slot] = length

        def _spec_tick(params, pcache, last_logits, drafts, active):
            tok, accept, next_logits, _ = llama.spec_verify_paged(
                params, cfg, pcache, last_logits, drafts, active)
            return tok, accept, next_logits

        self._tick = _Program(_tick)
        self._chunk = _Program(_chunk)
        self._set_row = _Program(_set_row)
        self._spec_tick = _Program(_spec_tick) if self.spec else None
        # The cost capture runs on fake tensors and calls each program's
        # plain function, so it adds no signature: taking the sentry
        # baseline after it proves that on every construction.
        if self.device_telemetry is not None:
            self._device_capture_programs(self.device_telemetry)
        # Sentry baseline: all zeros before warm-up.  The first call of
        # each program (0 -> 1) is legitimate; only growth BEYOND one
        # signature per program counts.
        self._jit_cache_seen = self.compile_cache_sizes()

    # -- introspection -----------------------------------------------------

    def compile_cache_sizes(self) -> dict[str, int]:
        """Per-program count of distinct argument signatures (shapes,
        dtypes, devices) seen so far: the no-retrace pin, one per program
        after warm-up.  A spec engine adds the ``spec_tick`` key (its
        always-wide verify program, which replaces ``tick``, so that
        count stays 0)."""
        sizes = {
            "tick": len(self._tick.signatures),
            "chunk": len(self._chunk.signatures),
            "set_row": len(self._set_row.signatures),
        }
        if self._spec_tick is not None:
            sizes["spec_tick"] = len(self._spec_tick.signatures)
        return sizes

    def _device_capture_programs(
            self, dev: "device_telemetry_mod.DeviceTelemetry") -> None:
        """Count every program's FLOPs and bytes into ``dev`` (see
        :func:`~horovod_tpu_torch.device_telemetry.count_cost`) on fake
        copies of the live arguments at serving's own shapes, and hand it
        the exact parameter and pool bytes for HBM reconciliation."""
        if dev.device is None:
            dev.bind(self.device)
        # made for real first: counted under fake tensors, the cached RoPE
        # table would be a fake one
        llama._rope_freqs(self.cfg.rope_theta, self.cfg.head_dim // 2,
                          self.device)
        active = self._up(np.zeros((self.n_slots,), np.int64))
        toks = self._up(np.zeros((1, self.chunk), np.int64))
        row = self._up(self._trash_row)
        args = (self.params, self.pcache, self.last_logits)
        dev.capture("tick", self._tick.fn, *args, active)
        dev.capture("chunk", self._chunk.fn, *args, toks, 0, self.chunk, 0)
        dev.capture("set_row", self._set_row.fn, self.pcache, 0, row, 0)
        if self._spec_tick is not None:
            drafts = self._up(np.full((self.n_slots, self.draft_k), -1,
                                      np.int64))
            dev.capture("spec_tick", self._spec_tick.fn, *args, drafts,
                        active)
        param_bytes = sum(x.numel() * x.element_size() for x in
                          pytree.tree_leaves(self.params))
        dev.set_model_bytes(
            param_bytes=param_bytes,
            kv_total_bytes=self._block_bytes * self.pcache.k.shape[1])

    def free_block_count(self) -> int:
        return len(self._free_blocks)

    def cached_block_count(self) -> int:
        """Zero-ref blocks parked in the prefix cache (0 without it)."""
        return self.pool.cached_count()

    def pending(self) -> bool:
        return bool(self._queue) or any(
            s.state != FREE for s in self._slots)

    def metrics_snapshot(self) -> dict:
        """Plain-dict snapshot of the engine's registry (counters, gauges,
        the TTFT / TPOT / queue-wait / e2e histograms with p50/p90/p99),
        plus the windowed ``slo`` report, the ``memory`` report, the
        prefix index digest (cache on), the ``profile`` breakdown
        (profiling on), the ``device`` report (telemetry on), and the
        trailing ``timeseries``, the ``alerts`` and the capacity
        ``advice`` (sampler on)."""
        mem = self.memory_report()    # refreshes kv.*/mem.* gauges
        snap = self.metrics.snapshot()
        snap["slo"] = self.slo_report()
        snap["memory"] = mem
        if self.prefix is not None:
            snap["prefix"] = self.prefix.key_digest()
        if self.prof is not None:
            snap["profile"] = self.prof.report()
        if self.device_telemetry is not None:
            snap["device"] = self.device_telemetry.report()
        if self.sampler is not None:
            # trailing points only; the full rings are /timeseries
            snap["timeseries"] = self.sampler.report(points=16)
        if self.alerts is not None:
            snap["alerts"] = self.alerts.report()
        if self.advisor is not None:
            snap["advice"] = self.advisor.recommend()
        return snap

    def memory_report(self) -> dict:
        """Where the memory is: the paged KV pool by state (free /
        referenced / cached, in blocks and device bytes) and the host-side
        observability footprint (registry, trace ring + SLO window,
        event-log file, prefix radix index).  Also refreshes the
        ``kv.*`` / ``mem.*`` gauges."""
        free = self.pool.free_count()
        referenced = self.pool.ref_count()
        cached = self.pool.cached_count()
        bb = self._block_bytes
        sbb = self._shard_block_bytes
        kv = {
            "block_bytes": bb,
            "total_bytes": bb * self.pcache.k.shape[1],
            "free_blocks": free, "free_bytes": free * bb,
            "referenced_blocks": referenced,
            "referenced_bytes": referenced * bb,
            "cached_blocks": cached, "cached_bytes": cached * bb,
            "tp_size": self.tp_size,
            "shard_block_bytes": sbb,
            "shard_total_bytes": sbb * self.pcache.k.shape[1],
            "shard_free_bytes": free * sbb,
            "shard_referenced_bytes": referenced * sbb,
            "shard_cached_bytes": cached * sbb,
        }
        # host side: getsizeof-level approximations, trend lines
        trace_ring = sum(sys.getsizeof(t) for t in
                         list(self.traces.values()))
        trace_ring += len(self.slo) * 128    # SLO ring holds Trace refs
        log = self.metrics.active_event_log()
        try:
            log_bytes = (os.path.getsize(log.path)
                         if log is not None else 0)
        except OSError:
            log_bytes = 0
        host = {
            "registry_bytes": self.metrics.approx_footprint_bytes(),
            "trace_ring_bytes": trace_ring,
            "event_log_bytes": log_bytes,
            "prefix_index_bytes": (self.prefix.approx_footprint_bytes()
                                   if self.prefix is not None else 0),
        }
        self._set_kv_gauges(free, referenced, cached)
        self.metrics.gauge("mem.registry_bytes").set(
            host["registry_bytes"])
        self.metrics.gauge("mem.trace_ring_bytes").set(trace_ring)
        self.metrics.gauge("mem.event_log_bytes").set(log_bytes)
        self.metrics.gauge("mem.prefix_index_bytes").set(
            host["prefix_index_bytes"])
        return {"kv": kv, "host": host}

    def _set_kv_gauges(self, free: int, referenced: int,
                       cached: int) -> None:
        bb, sbb = self._block_bytes, self._shard_block_bytes
        self.metrics.gauge("kv.free_blocks").set(free)
        self.metrics.gauge("kv.free_bytes").set(free * bb)
        self.metrics.gauge("kv.referenced_blocks").set(referenced)
        self.metrics.gauge("kv.referenced_bytes").set(referenced * bb)
        self.metrics.gauge("kv.cached_blocks").set(cached)
        self.metrics.gauge("kv.cached_bytes").set(cached * bb)
        self.metrics.gauge("kv.shard_free_bytes").set(free * sbb)
        self.metrics.gauge("kv.shard_referenced_bytes").set(
            referenced * sbb)
        self.metrics.gauge("kv.shard_cached_bytes").set(cached * sbb)

    def slo_report(self) -> dict:
        """Goodput, status mix and windowed TTFT/TPOT/E2E percentiles over
        the last ``slo_window`` terminal requests."""
        return self.slo.report()

    def state_dump(self) -> str:
        """Human-readable scheduler state (the watchdog's evidence):
        uptime and step totals, slot and terminal-status counts, pool and
        prefix-cache pictures, every queued and live request, and the
        metrics snapshot."""
        states = {FREE: 0, PREFILL: 0, DECODE: 0}
        for s in self._slots:
            states[s.state] += 1
        by_status: dict[str, int] = {}
        for r in self.results.values():
            by_status[r.status] = by_status.get(r.status, 0) + 1
        total = self.pcache.k.shape[1]
        lines = [
            f"rank={metrics_mod.current_rank()} pid={os.getpid()} "
            f"step={self.step_index} uptime_s="
            f"{time.monotonic() - self._t0:.3f} "
            f"queue_depth={len(self._queue)} "
            f"free_blocks={len(self._free_blocks)}/{total - 1} "
            f"starve_steps={self._starve_steps} counters={self.counters}",
            f"  slots: free={states[FREE]} prefill={states[PREFILL]} "
            f"decode={states[DECODE]}; submitted={self._next_id} "
            f"finished={dict(sorted(by_status.items()))}",
            "  metrics=" + json.dumps(self.metrics_snapshot(),
                                      sort_keys=True),
        ]
        if self.alerts is not None:
            arep = self.alerts.report()
            lines.append(
                f"  alerts: firing={arep['firing']} "
                f"pending={arep['pending']} "
                f"transitions={len(arep['history'])}")
        if self.advisor is not None:
            rec = self.advisor.recommend()
            lines.append(f"  advice: {rec['action']} n={rec['n']} "
                         f"({rec['reason']})")
        bb = self._block_bytes
        lines.append(
            f"  kv bytes: block={bb} free={self.pool.free_count() * bb}"
            f" referenced={self.pool.ref_count() * bb}"
            f" cached={self.pool.cached_count() * bb}"
            f" total={bb * total} tp_size={self.tp_size}"
            f" shard_total={self._shard_block_bytes * total}")
        if self.prof is not None:
            rep = self.prof.report()
            lines.append(
                "  profile (mean ms over last "
                f"{rep['n']} ticks): " + " ".join(
                    f"{p}={rep['phases'][p]['mean_s'] * 1e3:.3f}"
                    for p in rep["phases"] if "." not in p)
                + f" tick={rep['tick']['mean_s'] * 1e3:.3f}")
        if self.device_telemetry is not None:
            drep = self.device_telemetry.report()
            mfu = drep["win"]["mfu"]
            lines.append(
                f"  device: {drep['platform']}/{drep['device_kind']}"
                f" x{drep['n_devices']}"
                f" peak_known={drep['peak_flops_known']}"
                f" mfu={'n/a' if mfu is None else f'{mfu:.4f}'}"
                f" flops/s={drep['win']['flops_per_s']:.3e}"
                f" headroom={drep['win']['overlap_headroom_pct']:.1f}%"
                f" compiles={drep['compiles']}"
                f" retrace_est_s={drep['retrace_compile_est_s']:.3f}")
        lines += ["  " + ln for ln in self.pool.state_lines()]
        if self.prefix is not None:
            lines.append(
                f"  prefix cache: indexed="
                f"{self.prefix.indexed_blocks()} "
                f"counters={self.prefix_counters} "
                f"stats={self.prefix.stats}")
        for e in self._queue:
            lines.append(
                f"  queued rid={e.rid} prompt={len(e.req.prompt)} "
                f"prior={len(e.prior)} need={self._need_blocks(e.req)} "
                f"retries={e.retries} wait={e.wait_steps} "
                f"queued_steps={e.queued_steps}")
        for i, s in enumerate(self._slots):
            lines.append(
                f"  slot {i}: {s.state}" + (
                    "" if s.state == FREE else
                    f" rid={s.request_id} w={s.w_done}/{s.n_win} "
                    f"out={len(s.out)} budget={s.budget} "
                    f"blocks={s.n_blocks} shared={s.n_hit} "
                    f"retries={s.retries} wait={s.wait_steps}"))
        return "\n".join(lines)

    # -- host -> device ------------------------------------------------------

    def _up(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device: from pinned memory without
        a wait on the card (the caching host allocator keeps the pinned
        block until the copy has run), as is on the CPU."""
        t = torch.from_numpy(np.ascontiguousarray(arr, np.int64))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _write_row(self, slot: int, row: np.ndarray, length: int) -> None:
        self._set_row(self.pcache, slot, self._up(row), length)
        if self.device_telemetry is not None:
            # the slot and length ride as kernel arguments, not copies
            self.device_telemetry.dispatch("set_row", h2d_bytes=row.nbytes)

    # -- queue -------------------------------------------------------------

    def _need_blocks(self, req: Request) -> int:
        # constant across replays: the replay prompt grows by exactly the
        # tokens the remaining budget shrinks by
        return -(-(len(req.prompt) + req.max_new_tokens)
                 // self.block_size)

    def submit(self, req: Request) -> int:
        """Queue a request; returns its id (key into ``results``).
        Validation happens here so a rejected request never holds a
        queue position."""
        L = len(req.prompt)
        if L < 1 or req.max_new_tokens < 1:
            # malformed client data: a terminal REJECTED, not an exception
            return self._reject_submit(req, L)
        if req.temperature not in (None, 0.0) or req.sample_key is not None:
            raise ValueError(
                "ServeEngine is greedy-only; serve sampled requests "
                "through ContinuousBatcher")
        if req.prefix is not None:
            raise ValueError(
                "ServeEngine does not splice prefix caches yet; use "
                "ContinuousBatcher for prefix requests")
        if req.slo_s is not None and req.slo_s <= 0:
            raise ValueError(f"slo_s must be positive, got {req.slo_s}")
        if L + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt {L} + max_new_tokens {req.max_new_tokens} "
                f"exceeds max_len {self.max_len}")
        n_win = -(-L // self.chunk)
        if n_win * self.chunk > self.max_len:
            raise ValueError(
                f"prompt {L} padded to {n_win * self.chunk} prefill "
                f"windows exceeds max_len {self.max_len}")
        need = self._need_blocks(req)
        if need > self.pcache.k.shape[1] - 1:
            raise ValueError(
                f"request needs {need} cache blocks but the pool only "
                f"has {self.pcache.k.shape[1] - 1} allocatable")
        rid = self._new_trace(req, L)
        now = self.traces[rid].enqueue_ts
        deadline = None if req.deadline_s is None else now + req.deadline_s
        slo_deadline = None if req.slo_s is None else now + req.slo_s
        self._queue.append(_QueueEntry(rid=rid, req=req,
                                       deadline=deadline,
                                       slo_deadline=slo_deadline))
        return rid

    def _new_trace(self, req: Request, L: int) -> int:
        """A fresh request id with its trace, SLO target, submit counter
        and event."""
        rid = self._next_id
        self._next_id += 1
        now = time.monotonic()
        self.traces[rid] = Trace(rid=rid, enqueue_ts=now,
                                 enqueue_step=self.step_index)
        self._maybe_open_trace(req, rid, self.traces[rid], now)
        self._slo_targets[rid] = req.slo_s
        self.metrics.counter("serve.requests_submitted").inc()
        self.metrics.event("serve.submit", rid=rid, step=self.step_index,
                           prompt_len=L,
                           max_new_tokens=req.max_new_tokens)
        if self.timeline is not None:
            self.timeline.async_start("serving.requests", "REQ", rid)
        return rid

    def _maybe_open_trace(self, req: Request, rid: int, tr: Trace,
                          now: float) -> None:
        """Join the tracing plane at submit: adopt a propagated context as
        parent, or head-sample an engine root keyed on ``serve:<rid>`` (a
        pure function of the seed and the id, so decisions replay)."""
        ctx = req.trace_ctx
        if ctx is not None:
            sctx = ctx.child("serve.request")
            tr.parent_span_id = ctx.span_id
        elif self._trace_fraction > 0.0:
            sctx = tracing_mod.TraceContext.root(
                f"serve:{rid}", "serve.request",
                self._trace_fraction, self._trace_seed)
            if sctx is None:
                return
            tracing_mod.count_sampled(self.metrics)
        else:
            return
        tr.trace_id = sctx.trace_id
        tr.span_id = sctx.span_id
        self.tracer.span_open(sctx, "serve.request", now,
                              parent_id=tr.parent_span_id, rid=rid)

    def _reject_submit(self, req: Request, L: int) -> int:
        """Terminal ``REJECTED`` for a request invalid on its face (empty
        prompt, non-positive budget): a real rid, a trace and the full
        submit/reject event pair, never a queue position."""
        rid = self._new_trace(req, L)
        self._finish_queued(_QueueEntry(rid=rid, req=req), REJECTED)
        return rid

    def cancel(self, rid: int) -> bool:
        """Cancel a request in ANY live state (queued, prefilling,
        decoding).  Its result becomes ``CANCELLED`` with tokens-so-far.
        Returns False when ``rid`` is unknown or already terminal."""
        for i, e in enumerate(self._queue):
            if e.rid == rid:
                self._queue.pop(i)
                self._finish_queued(e, CANCELLED)
                return True
        for slot, s in enumerate(self._slots):
            if s.state != FREE and s.request_id == rid:
                self._terminate(slot, CANCELLED)
                return True
        return False

    # -- scheduling --------------------------------------------------------

    def _admit_entry(self, e: _QueueEntry, slot: int,
                     hit: list[int] | None = None) -> None:
        """Map a queue entry into a free slot.  ``hit`` is the
        prefix-cache match (already referenced by ``acquire``): its
        blocks lead the row's block table and prefill starts at the first
        position past them (the match is capped so the write frontier
        lands in a fresh private block: the COW rule)."""
        hit = hit or []
        prompt = list(e.req.prompt) + list(e.prior)
        L = len(prompt)
        need = self._need_blocks(e.req)
        base = len(hit) * self.block_size
        s = self._slots[slot]
        blocks = list(hit)
        for _ in range(need - len(hit)):
            b = self.pool.alloc()
            self.pool.incref(b)
            blocks.append(b)
        row = self._trash_row.copy()
        row[:need] = blocks
        self._write_row(slot, row, base)
        rem = L - base                    # tokens still to prefill (>= 1)
        n_win = -(-rem // self.chunk)
        padded = np.zeros((1, n_win * self.chunk), np.int64)
        padded[0, :rem] = prompt[base:]
        s.state = PREFILL
        s.request_id = e.rid
        s.padded = padded
        s.n_win = n_win
        s.w_done = 0
        s.true_len = L
        s.base = base
        s.n_hit = len(hit)
        s.budget = e.req.max_new_tokens - len(e.prior)
        s.eos = e.req.eos_id
        s.out = []
        s.n_blocks = need
        s.blocks = blocks
        s.req = e.req
        s.prior = list(e.prior)
        s.retries = e.retries
        s.wait_steps = 0
        s.deadline = e.deadline
        s.slo_deadline = e.slo_deadline
        s.admit_seq = self._admit_seq
        # drafting state seeds from the full replay context
        s.draft = (drafting_mod.NgramDraftState(prompt)
                   if self.spec else None)
        self._admit_seq += 1
        tr = self.traces.get(e.rid)
        if tr is not None:
            if tr.admit_ts is None:       # first admission only
                tr.admit_ts = time.monotonic()
                tr.admit_step = self.step_index
                self.metrics.histogram("serve.queue_wait_s").observe(
                    tr.admit_ts - tr.enqueue_ts)
            tr.prefix_tokens_skipped += base
        self._event("admit", slot, e.rid)
        if hit:
            self.prefix_counters["hits"] += 1
            self.prefix_counters["blocks_reused"] += len(hit)
            self.prefix_counters["tokens_skipped"] += base
            self._event("hit", slot, e.rid)

    def _admit_fault(self, e: _QueueEntry, exc: BaseException) -> None:
        """Quarantine an admission-side fault (``serve.cache``,
        ``serve.admit``) to its request: retry after a backoff, or
        ``FAILED`` when permanent or out of retries."""
        if (isinstance(exc, faults_mod.PermanentFault)
                or e.retries >= self.max_retries):
            self._queue.remove(e)
            self._finish_queued(e, FAILED, exc)
        else:
            e.retries += 1
            e.wait_steps = 2 ** e.retries
            self._bump_counter("retries")
            self._event("retry", -1, e.rid)

    def _admit_ready(self) -> tuple[int, int | None]:
        """Policy-ordered admission: move queued requests into free slots
        while both a slot and enough cache blocks are available.
        Head-of-line blocking on BLOCK pressure applies to the first
        block-starved candidate in the policy's order, which feeds the
        preemption trigger.  Entries serving a retry backoff are skipped.
        With the prefix cache on, each candidate first
        longest-prefix-matches and zero-ref cached blocks are evicted
        LRU-leaf-first to cover any shortfall.  Returns ``(admitted,
        starved_need)``: the NEW block count the stalled head needs, or
        None when nothing starved."""
        admitted = 0
        for e in self.policy.admission_order(self._queue):
            free = [j for j, s in enumerate(self._slots)
                    if s.state == FREE]
            if not free:
                return admitted, None
            if e.wait_steps > 0:          # admit-retry backoff
                continue
            need = self._need_blocks(e.req)
            hit: list[int] = []
            if self.prefix is not None:
                try:
                    self.faults.check("serve.cache", key=e.rid)
                    t_cq = (0.0 if self.prof is None
                            else time.perf_counter())
                    hit = self.prefix.acquire(
                        list(e.req.prompt) + list(e.prior))
                    if self.prof is not None:
                        self.prof.add("admit.cache_acquire", t_cq,
                                      time.perf_counter())
                except Exception as exc:
                    # nothing was referenced; only this request retries
                    self._admit_fault(e, exc)
                    continue
                short = (need - len(hit)) - self.pool.free_count()
                if short > 0:             # cache evicts before rows do
                    self.prefix_counters["evictions"] += \
                        self.prefix.evict(short)
            if need - len(hit) > len(self._free_blocks):
                if hit:                   # hit blocks re-park in LRU
                    self.prefix.release(reversed(hit))
                return admitted, need - len(hit)
            try:
                self.faults.check("serve.admit", key=e.rid)
            except Exception as exc:
                if hit:
                    self.prefix.release(reversed(hit))
                self._admit_fault(e, exc)
                continue
            self._queue.remove(e)
            self._admit_entry(e, free[0], hit)
            admitted += 1
        return admitted, None

    def _replay_len(self, s: _Slot) -> int:
        return len(s.req.prompt) + len(s.prior) + len(s.out)

    def _replayable(self, s: _Slot) -> bool:
        # the replay prompt must still fit the chunked-prefill padding
        n_win = -(-self._replay_len(s) // self.chunk)
        return n_win * self.chunk <= self.max_len

    def _release_row_blocks(self, s: _Slot, *, register: bool) -> None:
        """Drop a retiring row's block references; with the prefix cache
        on and ``register`` set (OK retirement or a requeue whose KV is
        known-good) its fully written blocks first join the radix index
        (release-to-cache)."""
        if self.prefix is not None and register and s.req is not None:
            toks = (list(s.req.prompt) + list(s.prior) + list(s.out))
            self.prefix.insert(toks, s.blocks, s.true_len + len(s.out))
        for b in reversed(s.blocks):
            self.pool.decref(b)

    def _requeue(self, slot: int, *, retried: bool) -> None:
        """Free a row and put its request back in the queue with
        ``prompt + out`` as the replay prompt (preemption, or a decode
        retry, which replays because the faulted tick already advanced
        the row's cache position)."""
        s = self._slots[slot]
        entry = _QueueEntry(
            rid=s.request_id, req=s.req,
            prior=list(s.prior) + list(s.out),
            retries=s.retries + (1 if retried else 0),
            wait_steps=2 ** (s.retries + 1) if retried else 0,
            deadline=s.deadline,
            slo_deadline=s.slo_deadline)
        self._release_row_blocks(s, register=True)
        self._write_row(slot, self._trash_row, 0)
        self._slots[slot] = _Slot()
        self._queue.append(entry)

    def _preempt(self, need: int) -> int:
        """Free blocks for a starved head: evict zero-ref cached blocks
        first, then preempt the policy's victims until ``need`` blocks
        are free (or no candidate remains).  Preempted requests re-queue
        for replay."""
        preempted = 0
        while len(self._free_blocks) < need:
            if self.prefix is not None:
                evicted = self.prefix.evict(
                    need - len(self._free_blocks))
                if evicted:
                    self.prefix_counters["evictions"] += evicted
                    continue
            cands = [(i, s) for i, s in enumerate(self._slots)
                     if s.state == DECODE and self._replayable(s)]
            if not cands:
                break
            slot = self.policy.victim(cands)
            self._event("preempt", slot, self._slots[slot].request_id)
            self._bump_counter("preemptions")
            self._requeue(slot, retried=False)
            preempted += 1
        return preempted

    def _terminate(self, slot: int, status: str,
                   error: BaseException | None = None) -> RequestResult:
        """Retire a row with a terminal status: blocks back to the pool
        (release-to-cache on a clean OK finish with the prefix cache on),
        row to the trash block."""
        s = self._slots[slot]
        res = RequestResult(list(s.prior) + list(s.out), status, error)
        self.results[s.request_id] = res
        self._finished[s.request_id] = res
        self._finalize_trace(s.request_id, res)
        self._release_row_blocks(s, register=status == OK)
        self._write_row(slot, self._trash_row, 0)
        kind = {OK: "recycle", TIMEOUT: "timeout",
                CANCELLED: "cancel", FAILED: "fail"}[status]
        self._event(kind, slot, s.request_id)
        self._bump_status(status)
        self._slots[slot] = _Slot()
        return res

    def _finish_queued(self, e: _QueueEntry, status: str,
                       error: BaseException | None = None) -> None:
        """Terminal result for a request that never (re)entered a slot:
        tokens-so-far is whatever a previous stint emitted."""
        res = RequestResult(list(e.prior), status, error)
        self.results[e.rid] = res
        self._finished[e.rid] = res
        self._finalize_trace(e.rid, res)
        kind = {TIMEOUT: "timeout", CANCELLED: "cancel",
                REJECTED: "reject", FAILED: "fail"}[status]
        self._event(kind, -1, e.rid)
        self._bump_status(status)

    def _bump_status(self, status: str) -> None:
        key = {TIMEOUT: "timeouts", CANCELLED: "cancellations",
               REJECTED: "rejections", FAILED: "failures"}.get(status)
        if key is not None:
            self._bump_counter(key)

    def _bump_counter(self, key: str) -> None:
        """Advance a lifecycle counter in ``self.counters`` AND its mirror
        in the metrics registry, so both always agree."""
        self.counters[key] += 1
        self.metrics.counter("serve." + key).inc()

    def _bump_spec(self, key: str, n: int = 1) -> None:
        self.spec_counters[key] += n
        self.metrics.counter("serve.spec." + key).inc(n)

    def _finalize_trace(self, rid: int, res: RequestResult) -> None:
        """Stamp a request's :class:`Trace` terminal, attach it to the
        result and feed the SLO window and the latency histograms."""
        tr = self.traces.pop(rid, None)
        if tr is None:
            return
        tr.terminal_ts = time.monotonic()
        tr.terminal_step = self.step_index
        tr.status = res.status
        tr.n_tokens = len(res.tokens)
        res.trace = tr
        self.slo.add(tr, self._slo_targets.pop(rid, None))
        self.metrics.gauge("serve.goodput").set(self.slo.goodput())
        self.metrics.histogram("serve.e2e_s").observe(
            tr.e2e_s, exemplar=tr.trace_id)
        if tr.trace_id is not None:
            self._emit_request_spans(tr)
        tpot = tr.tpot_s
        if tpot is not None:
            self.metrics.histogram("serve.tpot_s").observe(tpot)
        self.metrics.counter("serve.requests_completed").inc()
        if tr.n_tokens:
            self.metrics.counter("serve.tokens_emitted").inc(tr.n_tokens)
        if self.timeline is not None:
            self.timeline.async_end("serving.requests", "REQ", rid)

    def _emit_request_spans(self, tr: Trace) -> None:
        """A sampled request's spans at its terminal: ``serve.queue`` /
        ``serve.prefill`` / ``serve.decode`` children tiled from the Trace
        stamps, then the ``serve.request`` close.  Phases a request never
        reached are absent."""
        sctx = tracing_mod.TraceContext(tr.trace_id, tr.span_id)
        if tr.admit_ts is not None:
            self.tracer.span(sctx.child("serve.queue"), "serve.queue",
                             tr.enqueue_ts, tr.admit_ts,
                             parent_id=tr.span_id, rid=tr.rid,
                             steps=tr.queue_steps)
            if tr.first_token_ts is not None:
                self.tracer.span(
                    sctx.child("serve.prefill"), "serve.prefill",
                    tr.admit_ts, tr.first_token_ts,
                    parent_id=tr.span_id, rid=tr.rid,
                    chunks=tr.prefill_chunks)
                self.tracer.span(
                    sctx.child("serve.decode"), "serve.decode",
                    tr.first_token_ts, tr.terminal_ts,
                    parent_id=tr.span_id, rid=tr.rid,
                    n_tokens=tr.n_tokens, admit_step=tr.admit_step,
                    terminal_step=tr.terminal_step)
        self.tracer.span(sctx, "serve.request", tr.enqueue_ts,
                         tr.terminal_ts, parent_id=tr.parent_span_id,
                         rid=tr.rid, status=tr.status)

    def _emit_chunk_span(self, tr: Trace, t0: float, t1: float) -> None:
        """One ``serve.prefill_chunk`` span per prefill window of a sampled
        request, under its ``serve.prefill`` span, whose id is derived
        (the same ``child_span_id`` the close uses), so chunks emitted
        before their parent still join the tree."""
        prefill_id = tracing_mod.child_span_id(
            tr.trace_id, tr.span_id, "serve.prefill")
        ctx = tracing_mod.TraceContext(
            tr.trace_id,
            tracing_mod.child_span_id(tr.trace_id, prefill_id,
                                      "serve.prefill_chunk",
                                      seq=tr.prefill_chunks))
        self.tracer.span(ctx, "serve.prefill_chunk", t0, t1,
                         parent_id=prefill_id, rid=tr.rid,
                         seq=tr.prefill_chunks)

    def _slot_fault(self, slot: int, exc: BaseException) -> None:
        """Quarantine a prefill-window fault to its own request: transient
        → bounded in-place retry after a backoff (the window never ran);
        permanent or out of retries → ``FAILED``."""
        s = self._slots[slot]
        if (isinstance(exc, faults_mod.PermanentFault)
                or s.retries >= self.max_retries):
            self._terminate(slot, FAILED, exc)
            return
        s.retries += 1
        s.wait_steps = 2 ** s.retries
        self._bump_counter("retries")
        self._event("retry", slot, s.request_id)

    def _row_fault(self, slot: int, exc: BaseException) -> None:
        """Quarantine a decode-tick readback fault: a transient retry
        replays (the faulted tick already advanced the row's cache);
        permanent or exhausted → ``FAILED``."""
        s = self._slots[slot]
        if (isinstance(exc, faults_mod.PermanentFault)
                or s.retries >= self.max_retries
                or not self._replayable(s)):
            self._terminate(slot, FAILED, exc)
            return
        self._bump_counter("retries")
        self._event("retry", slot, s.request_id)
        self._requeue(slot, retried=True)

    def _expire(self, now: float | None) -> int:
        """Deadline enforcement; returns how many requests terminated."""
        done = 0
        if now is not None:
            i = 0
            while i < len(self._queue):
                e = self._queue[i]
                if e.deadline is not None and now >= e.deadline:
                    self._queue.pop(i)
                    self._finish_queued(e, TIMEOUT)
                    done += 1
                    continue
                i += 1
            for slot, s in enumerate(self._slots):
                if (s.state != FREE and s.deadline is not None
                        and now >= s.deadline):
                    self._terminate(slot, TIMEOUT)
                    done += 1
        return done

    def _event(self, kind: str, slot: int, rid: int) -> None:
        self.events.append(
            SchedulerEvent(kind, self.step_index, slot, rid))
        tr = self.traces.get(rid)
        if tr is not None:
            if kind == "retry":
                tr.retries += 1
            elif kind == "preempt":
                tr.preemptions += 1
        # one structured-log line per scheduler event: replaying the
        # JSONL reproduces ``self.counters``
        self.metrics.event("serve." + kind, rid=rid, slot=slot,
                           step=self.step_index)
        if self.timeline is not None:
            self.timeline.instant("serving.scheduler", kind.upper())

    def _check_block_invariants(self) -> None:
        """The ``HVD_TORCH_VERIFY_BLOCKS=1`` debug walk: block tables,
        slot bookkeeping and the pool must agree after every step."""
        table = self.pcache.block_table.cpu().numpy()
        free = set(self._free_blocks)
        usage: dict[int, int] = {}
        for slot, s in enumerate(self._slots):
            row = table[slot]
            if s.state == FREE:
                if row.any():
                    raise AssertionError(
                        f"free slot {slot} maps blocks "
                        f"{[int(b) for b in row if b]}")
                continue
            if [int(b) for b in row[:s.n_blocks]] != s.blocks:
                raise AssertionError(
                    f"slot {slot} table row {row[:s.n_blocks]} != "
                    f"bookkeeping {s.blocks}")
            if row[s.n_blocks:].any():
                raise AssertionError(
                    f"slot {slot} maps blocks beyond its "
                    f"{s.n_blocks} allocated")
            for b in s.blocks:
                if b == 0:
                    raise AssertionError(
                        f"slot {slot} maps the trash block")
                if b in free:
                    raise AssertionError(
                        f"live slot {slot} references freed block {b}")
                usage[b] = usage.get(b, 0) + 1
        for b, n in usage.items():
            if self.pool.refcount(b) != n:
                raise AssertionError(
                    f"block {b}: {n} rows map it but pool refcount is "
                    f"{self.pool.refcount(b)}")
        for b in self.pool._ref:
            if b not in usage:
                raise AssertionError(
                    f"block {b} holds {self.pool.refcount(b)} pool "
                    f"references but no live row maps it")
        if self.prefix is not None:
            self.prefix.check_consistency()
        total = self.pcache.k.shape[1] - 1
        accounted = (len(free) + self.pool.cached_count()
                     + len(self.pool._ref))
        if accounted != total:
            raise AssertionError(
                f"pool accounting leak: free={len(free)} "
                f"cached={self.pool.cached_count()} "
                f"referenced={len(self.pool._ref)} != {total}")

    def step(self) -> dict[int, RequestResult]:
        """One engine step: expire deadlines, admit (preempting for a
        starved head if enabled), run one prefill window per admitting
        slot, then one decode tick over the pool.  Returns
        ``{request_id: RequestResult}`` for every request that reached a
        terminal state during the step."""
        self._finished = {}
        progress = 0
        # mark-based phase profiling: each boundary charges the time
        # since the previous one, so the phases tile the tick
        prof = self.prof
        if prof is not None:
            prof.begin(self.step_index)
        if self.device_telemetry is not None:
            self.device_telemetry.start()
        now = None
        if (any(e.deadline is not None for e in self._queue)
                or any(s.deadline is not None for s in self._slots
                       if s.state != FREE)):
            now = time.monotonic()
        progress += self._expire(now)
        # queue bookkeeping: backoff countdown + admission budgets
        i = 0
        while i < len(self._queue):
            e = self._queue[i]
            if (e.req.max_queue_steps is not None
                    and e.queued_steps >= e.req.max_queue_steps):
                self._queue.pop(i)
                self._finish_queued(e, REJECTED)
                progress += 1
                continue
            e.queued_steps += 1
            tr = self.traces.get(e.rid)
            if tr is not None:
                tr.queue_steps += 1
            if e.wait_steps > 0:
                e.wait_steps -= 1
                progress += 1
            i += 1
        if prof is not None:
            prof.mark("expire")
        admitted, starved_need = self._admit_ready()
        progress += admitted
        if starved_need is None:
            self._starve_steps = 0
        else:
            self._starve_steps += 1
            if (self.preempt_after is not None
                    and self._starve_steps >= self.preempt_after):
                freed = self._preempt(starved_need)
                if freed:
                    progress += freed
                    self._starve_steps = 0
                    more, _ = self._admit_ready()  # head admits this step
                    progress += more
        t_pf = 0.0 if prof is None else time.perf_counter()
        for slot, s in enumerate(self._slots):
            if s.state != PREFILL:
                continue
            if s.wait_steps > 0:          # prefill-retry backoff
                s.wait_steps -= 1
                progress += 1
                continue
            w = s.w_done
            final = w == s.n_win - 1
            toks = s.padded[:, w * self.chunk:(w + 1) * self.chunk]
            # windows cover prompt[base:]: positions [0, base) are the
            # shared blocks' KV, never rewritten
            new_len = (s.true_len if final
                       else s.base + (w + 1) * self.chunk)
            sel = (s.true_len - 1 - s.base - w * self.chunk
                   if final else 0)
            tr = self.traces.get(s.request_id)
            traced = tr is not None and tr.trace_id is not None
            t_chunk = time.monotonic() if traced else 0.0
            try:
                self.faults.check("serve.prefill", key=s.request_id)
                self._chunk(self.params, self.pcache, self.last_logits,
                            self._up(toks), slot, new_len, sel)
            except Exception as exc:
                self._slot_fault(slot, exc)
                progress += 1
                continue
            if self.device_telemetry is not None:
                self.device_telemetry.dispatch("chunk",
                                               h2d_bytes=toks.nbytes)
            s.w_done += 1
            progress += 1
            if tr is not None:
                if traced:
                    self._emit_chunk_span(tr, t_chunk, time.monotonic())
                tr.prefill_chunks += 1
            if final:
                s.state = DECODE      # joins this step's tick
        if prof is not None:
            prof.add("admit.prefill_dispatch", t_pf, time.perf_counter())
            prof.mark("admit")
        decoding = [i for i, s in enumerate(self._slots)
                    if s.state == DECODE]
        spec = self.spec and bool(decoding)
        drafts_host: np.ndarray | None = None
        if spec:
            # each decoding row proposes up to draft_k tokens from its own
            # history; -1 pads are never accepted.  A faulting drafter
            # (serve.draft) degrades its row to plain decode for the round.
            drafts_host = np.full((self.n_slots, self.draft_k), -1,
                                  np.int64)
            for slot in decoding:
                s = self._slots[slot]
                try:
                    self.faults.check("serve.draft", key=s.request_id)
                    prop = (s.draft.propose(self.draft_k)
                            if s.draft is not None else [])
                except Exception:
                    self.metrics.counter("serve.spec.draft_faults").inc()
                    prop = []
                if prop:
                    drafts_host[slot, :len(prop)] = prop
                    self._bump_spec("proposed", len(prop))
            if prof is not None:
                prof.mark("draft")
        if decoding:
            try:
                active_host = np.zeros((self.n_slots,), np.int64)
                active_host[decoding] = 1
                active = self._up(active_host)
                if spec:
                    tok, accept, self.last_logits = self._spec_tick(
                        self.params, self.pcache, self.last_logits,
                        self._up(drafts_host), active)
                    readback = torch.stack([tok, accept])
                else:
                    tok, self.last_logits = self._tick(
                        self.params, self.pcache, self.last_logits, active)
                    readback = tok[None]
                dev = self.device_telemetry
                if dev is not None:
                    dev.dispatch("spec_tick" if spec else "tick",
                                 h2d_bytes=active_host.nbytes + (
                                     drafts_host.nbytes if spec else 0))
                if prof is not None:
                    prof.mark("decode_dispatch")
                # the one device read of the tick: everything it queued
                # completes first, so this wait is the device-time share
                t_sync0 = time.perf_counter()
                host = readback.cpu().numpy()
                tok_host = host[0]
                accept_host = host[1] if spec else None
                if dev is not None:
                    # the wait split into the cost model's predicted
                    # compute and host stall, nested under device_sync
                    t_sync1 = time.perf_counter()
                    est, _ = dev.on_sync("spec_tick" if spec else "tick",
                                         t_sync0, t_sync1,
                                         d2h_bytes=host.nbytes)
                    if prof is not None:
                        prof.add("device_sync.compute_est",
                                 t_sync0, t_sync0 + est)
                        prof.add("device_sync.host_stall",
                                 t_sync0 + est, t_sync1)
                if prof is not None:
                    prof.mark("device_sync")
            except Exception as exc:
                # a whole-tick failure cannot be attributed to one row;
                # quarantine every decoding row (transients replay)
                for slot in decoding:
                    self._row_fault(slot, exc)
                progress += len(decoding)
            else:
                progress += len(decoding)
                if spec:
                    self._bump_spec("rounds")
                for slot in decoding:
                    s = self._slots[slot]
                    emit = [int(tok_host[slot])]
                    if accept_host is not None:
                        acc = int(accept_host[slot])
                        emit += [int(x) for x in drafts_host[slot, :acc]]
                        self._bump_spec("row_rounds")
                        self._bump_spec("accepted", acc)
                        self.metrics.histogram(
                            "serve.spec.accepted_per_round").observe(acc)
                    try:
                        self.faults.check("serve.tick", key=s.request_id)
                        for t in emit:
                            if not 0 <= t < self.cfg.vocab_size:
                                raise faults_mod.PermanentFault(
                                    "serve.tick", s.request_id, -1)
                    except Exception as exc:
                        self._row_fault(slot, exc)
                        continue
                    if not s.prior and not s.out:
                        tr = self.traces.get(s.request_id)
                        if tr is not None and tr.first_token_ts is None:
                            tr.first_token_ts = time.monotonic()
                            self.metrics.histogram(
                                "serve.ttft_s").observe(tr.ttft_s)
                    # accepted drafts emit in order behind the
                    # unconditional token; a terminal token (budget or
                    # eos) discards the rest of the round
                    for t in emit:
                        s.out.append(t)
                        s.budget -= 1
                        if s.draft is not None:
                            s.draft.extend((t,))
                        if s.budget <= 0 or t == s.eos:
                            self._terminate(slot, OK)
                            break
        if prof is not None:
            prof.mark("verify" if spec else "sample_postprocess")
        prefilling = sum(1 for s in self._slots if s.state == PREFILL)
        if self.timeline is not None:
            self.timeline.counter(
                "serving.scheduler", "SCHED",
                {"queued": len(self._queue),
                 "decoding": len(decoding),
                 "prefilling": prefilling,
                 "free_blocks": len(self._free_blocks)})
            self.timeline.counter(
                "serving.scheduler", "LIFECYCLE", dict(self.counters))
            if self.spec:
                self.timeline.counter(
                    "serving.scheduler", "SPEC", dict(self.spec_counters))
            if self.prefix is not None:
                self.timeline.counter(
                    "serving.scheduler", "PREFIX",
                    dict(self.prefix_counters))
        self.metrics.counter("serve.steps").inc()
        self.metrics.gauge("serve.queue_depth").set(len(self._queue))
        self.metrics.gauge("serve.decoding").set(len(decoding))
        self.metrics.gauge("serve.prefilling").set(prefilling)
        self.metrics.gauge("serve.free_blocks").set(len(self._free_blocks))
        self.metrics.gauge("serve.cached_blocks").set(
            self.pool.cached_count())
        if self.prefix is not None:
            self.metrics.gauge("serve.prefix_indexed_blocks").set(
                self.prefix.indexed_blocks())
        self._set_kv_gauges(self.pool.free_count(), self.pool.ref_count(),
                            self.pool.cached_count())
        # Retrace sentry: a program seeing a second argument signature
        # mid-serve means some host value leaked into a shape or dtype.
        sizes = self.compile_cache_sizes()
        grew = {k: (self._jit_cache_seen[k], v)
                for k, v in sizes.items()
                if v > self._jit_cache_seen[k] and v > 1}
        self._jit_cache_seen = sizes
        if grew:
            n = sum(v - max(prev, 1) for prev, v in grew.values())
            self.metrics.counter("serve.retrace").inc(n)
            if self.device_telemetry is not None:
                self.device_telemetry.on_retrace(grew)
            self.metrics.event(
                "serve.retrace", step=self.step_index,
                programs={k: {"before": prev, "after": v}
                          for k, (prev, v) in grew.items()})
            if self._retrace_fatal:
                raise RuntimeError(
                    f"retrace sentry: a program saw a new argument "
                    f"signature mid-serve (HVD_TORCH_RETRACE_FATAL=1) — "
                    + ", ".join(f"{k}: {prev} -> {v}"
                                for k, (prev, v) in sorted(grew.items()))
                    + f" at step {self.step_index}.  State:\n"
                    f"{self.state_dump()}")
        if self._verify_blocks:
            self._check_block_invariants()
        if self.pending() and progress == 0:
            self._idle_steps += 1
            if self._idle_steps >= self.watchdog_steps:
                raise RuntimeError(
                    f"ServeEngine made no scheduling progress for "
                    f"{self._idle_steps} consecutive steps (no admit / "
                    f"prefill window / decode tick / retirement / "
                    f"preemption while work is pending) — the scheduler "
                    f"is stuck.  State:\n{self.state_dump()}")
        else:
            self._idle_steps = 0
        # health plane: sample the registry, then judge the series; both
        # are a clock read until their cadence elapses
        if self.sampler is not None:
            self.sampler.tick()
            if self.alerts is not None:
                self.alerts.tick()
        if self.device_telemetry is not None:
            self.device_telemetry.on_step(self.step_index)
        self._last_step_ts = time.monotonic()
        self.step_index += 1
        if prof is not None:
            prof.end()                # closes the bookkeeping phase
        return self._finished

    def run(self, requests: list[Request]) -> list[RequestResult]:
        """Serve ``requests`` to completion; returns each request's
        :class:`~horovod_tpu_torch.serving.RequestResult` in submission
        order."""
        ids = [self.submit(r) for r in requests]
        while self.pending():
            self.step()
        return [self.results[i] for i in ids]


# ---------------------------------------------------------------------------
# Throughput measurement (the serve_tokens_per_sec bench metric).
# ---------------------------------------------------------------------------


def _wait(device: torch.device) -> None:
    """End a timed window: the card's queued work counts in it (the
    reference's ``jax.block_until_ready``)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_throughput(
    params: dict, cfg: llama.LlamaConfig, requests: list[Request], *,
    n_slots: int, max_len: int, chunk: int,
    block_size: int | None = None, n_blocks: int | None = None,
    preempt_after: int | None = None, keep_tokens: bool = False,
) -> dict:
    """Continuous-batching vs fixed-batch throughput on one workload.

    The engine serves the queue with slot recycling; the static baseline
    is plain :func:`llama.generate` over fixed batches of ``n_slots`` in
    submission order — every batch decodes until its LONGEST budget is
    spent and prompts pad to the global maximum (the costs continuous
    batching exists to remove).  Both paths are warmed before timing (the
    engine by a full pass, every static batch by one untimed ``generate``,
    as the reference's ``jax.jit`` cache is warmed per token budget); only
    true emitted tokens count, for both.  Each static batch's prefill
    launches the flash forward once a layer.  Returns
    ``serve_tokens_per_sec``, ``static_tokens_per_sec``,
    ``serve_vs_static_ratio``, ``preemptions`` (timed pass only; nonzero
    only with ``preempt_after`` on an overcommitted ``n_blocks`` pool),
    latency percentiles from the metrics-on pass
    (``serve_ttft_p50_ms`` .. ``serve_e2e_p99_ms``),
    ``serve_metrics_overhead_pct`` (instrumented vs null-registry pass),
    ``monitor_overhead_pct`` (exporter on and scraped at ~100 Hz),
    ``serve_profiler_overhead_pct`` (phase profiler on),
    ``serve_health_overhead_pct`` (time-series sampler + alert
    evaluation in the step loop at 20 Hz), ``serve_trace_overhead_pct``
    (causal span plane at 100 % head sampling) and
    ``device_telemetry_overhead_pct`` (device telemetry plane on: counted
    dispatches, the sync split and the per-step gauges; its leg also
    yields ``serve_mfu`` — None when no peak is known, as on the CPU —
    ``serve_model_flops_per_token``, ``serve_device_flops_per_s`` and
    ``serve_overlap_headroom_pct``) — all min-of-2 passes against an
    adjacent min-of-2 metrics-on base, so inter-pass drift doesn't
    masquerade as overhead — with ``serve_phase_pct`` /
    ``serve_phase_mean_ms`` per-phase breakdowns, ``serve_goodput``
    (windowed SLO goodput after the timed passes), ``static_batches``
    and workload shape fields.  ``keep_tokens=True`` adds each request's
    tokens from the timed engine pass and from the static baseline
    (``serve_tokens``, ``static_tokens``).  On CUDA every timed window
    ends with ``torch.cuda.synchronize()``.
    """
    import threading

    if not requests:
        raise ValueError("empty workload")

    eng = ServeEngine(params, cfg, n_slots=n_slots, max_len=max_len,
                      chunk=chunk, block_size=block_size,
                      n_blocks=n_blocks, preempt_after=preempt_after,
                      metrics=metrics_mod.NULL)
    warm = eng.run(requests)
    assert all(r.ok for r in warm), [r.status for r in warm]
    n_tokens = sum(len(t) for t in warm)
    # the timed passes reuse the SAME engine: after run() every slot is
    # free, so the pool is in its admission-ready state again.  Metrics
    # ON is the shipping configuration, so it is the primary number; a
    # second pass with the null registry prices the instrumentation.
    reg = metrics_mod.MetricsRegistry(event_log=None)
    eng.metrics = reg
    preempt0 = eng.counters["preemptions"]
    served: list = []

    def _timed_pass() -> float:
        _wait(eng.device)
        t0 = time.perf_counter()
        out = eng.run(requests)
        _wait(eng.device)
        dt = time.perf_counter() - t0
        assert [len(t) for t in out] == [len(t) for t in warm]
        served[:] = out
        return dt

    t_serve = _timed_pass()
    serve_tokens = [[int(t) for t in r] for r in served]
    preemptions = eng.counters["preemptions"] - preempt0
    eng.metrics = metrics_mod.NULL
    t_serve_off = _timed_pass()
    hist = {name: reg.histogram(name)
            for name in ("serve.ttft_s", "serve.tpot_s",
                         "serve.queue_wait_s", "serve.e2e_s")}

    # Overhead arms, each INTERLEAVED with a fresh metrics-on base —
    # base, arm, base, arm — both sides taking their min (the
    # drift-robust estimator); the overheads are deltas between mins.
    mon_reg = metrics_mod.MetricsRegistry(event_log=None)
    mon = monitor_mod.MonitorServer(mon_reg, eng, port=0).start()
    scraping_on = threading.Event()
    stop_scraping = threading.Event()

    def _scrape_loop() -> None:
        import urllib.request
        url = f"http://{mon.host}:{mon.port}/metrics"
        while not stop_scraping.is_set():
            if scraping_on.is_set():
                try:
                    urllib.request.urlopen(url, timeout=1).read()
                except OSError:
                    pass
                stop_scraping.wait(0.01)
            else:
                stop_scraping.wait(0.001)

    scraper = threading.Thread(target=_scrape_loop, daemon=True)
    scraper.start()
    preg = metrics_mod.MetricsRegistry(event_log=None)
    prof = profiler_mod.TickProfiler(preg, timeline=eng.timeline)
    hreg = metrics_mod.MetricsRegistry(event_log=None)
    # 20 Hz sampling is 20x the shipping default: the health arm prices
    # a deliberately aggressive cadence.
    hsampler = timeseries_mod.MetricsSampler(hreg, sample_s=0.05)
    halerts = alerts_mod.AlertManager(hsampler, registry=hreg)
    treg = metrics_mod.MetricsRegistry(event_log=None)
    ttracer = tracing_mod.Tracer(treg)
    dreg = metrics_mod.MetricsRegistry(event_log=None)
    dtel = device_telemetry_mod.DeviceTelemetry(dreg, device=eng.device)
    # The cost capture happens OUTSIDE the timed passes: it is a
    # construction-time cost in the shipping configuration too.
    eng._device_capture_programs(dtel)
    orig_tracer, orig_fraction = eng.tracer, eng._trace_fraction
    t_base = t_serve_mon = t_serve_prof = float("inf")
    t_serve_health = t_serve_trace = t_serve_dev = float("inf")
    dev_pass_flops = 0.0
    try:
        for _ in range(2):
            # base leg: metrics on, no exporter scrape, no profiler
            eng.metrics = metrics_mod.MetricsRegistry(event_log=None)
            t_base = min(t_base, _timed_pass())
            # monitor leg: the exporter ON and scraped while serving
            eng.metrics = mon_reg
            scraping_on.set()
            t_serve_mon = min(t_serve_mon, _timed_pass())
            scraping_on.clear()
            # profiler leg: per-tick phase timing ON
            eng.metrics = preg
            eng.prof = prof
            t_serve_prof = min(t_serve_prof, _timed_pass())
            eng.prof = None
            # health leg: sampler + alert evaluation in the step loop
            eng.metrics = hreg
            eng.sampler = hsampler
            eng.alerts = halerts
            t_serve_health = min(t_serve_health, _timed_pass())
            eng.sampler = None
            eng.alerts = None
            # trace leg: the span plane at 100 % head sampling
            eng.metrics = treg
            eng.tracer = ttracer
            eng._trace_fraction = 1.0
            t_serve_trace = min(t_serve_trace, _timed_pass())
            eng._trace_fraction = orig_fraction
            # device leg: counted dispatches + sync split + gauges
            eng.metrics = dreg
            eng.device_telemetry = dtel
            dev_flops0 = dtel.total_flops
            t_serve_dev = min(t_serve_dev, _timed_pass())
            dev_pass_flops = dtel.total_flops - dev_flops0
            eng.device_telemetry = None
    finally:
        eng.prof = None
        eng.sampler = None
        eng.alerts = None
        eng.device_telemetry = None
        eng.tracer = orig_tracer
        eng._trace_fraction = orig_fraction
        stop_scraping.set()
        scraper.join(timeout=5)
        mon.stop()
    prof_report = prof.report()
    dev_report = dtel.report()

    # static baseline: batches of n_slots in submission order, padded to
    # the workload's longest prompt, each decoding its longest budget;
    # every batch runs once untimed before the timed pass
    pad_w = max(len(r.prompt) for r in requests)
    batches = []
    for i in range(0, len(requests), n_slots):
        group = requests[i:i + n_slots]
        while len(group) < n_slots:          # pad rows don't count below
            group.append(group[0])
        toks = np.zeros((n_slots, pad_w), np.int64)
        lens = np.zeros((n_slots,), np.int64)
        for j, r in enumerate(group):
            toks[j, :len(r.prompt)] = r.prompt
            lens[j] = len(r.prompt)
        mn = max(r.max_new_tokens for r in group)
        batches.append((torch.as_tensor(toks, device=eng.device),
                        torch.as_tensor(lens, device=eng.device), mn))

    def _static() -> list:
        with torch.no_grad():
            return [llama.generate(params, toks, cfg, max_new_tokens=mn,
                                   max_len=max_len, prompt_lengths=lens)
                    for toks, lens, mn in batches]

    _static()                                # warm every batch shape
    _wait(eng.device)
    t0 = time.perf_counter()
    outs = _static()
    _wait(eng.device)
    t_static = time.perf_counter() - t0

    result = {
        "serve_tokens_per_sec": n_tokens / t_serve,
        "static_tokens_per_sec": n_tokens / t_static,
        "serve_vs_static_ratio": t_static / t_serve,
        "preemptions": preemptions,
        "serve_ttft_p50_ms": hist["serve.ttft_s"].percentile(0.5) * 1e3,
        "serve_ttft_p99_ms": hist["serve.ttft_s"].percentile(0.99) * 1e3,
        "serve_tpot_p50_ms": hist["serve.tpot_s"].percentile(0.5) * 1e3,
        "serve_queue_wait_p99_ms":
            hist["serve.queue_wait_s"].percentile(0.99) * 1e3,
        "serve_e2e_p99_ms": hist["serve.e2e_s"].percentile(0.99) * 1e3,
        "serve_metrics_overhead_pct":
            (t_serve - t_serve_off) / t_serve_off * 100.0,
        "monitor_overhead_pct":
            (t_serve_mon - t_base) / t_base * 100.0,
        "serve_profiler_overhead_pct":
            (t_serve_prof - t_base) / t_base * 100.0,
        "serve_health_overhead_pct":
            (t_serve_health - t_base) / t_base * 100.0,
        "serve_trace_overhead_pct":
            (t_serve_trace - t_base) / t_base * 100.0,
        "device_telemetry_overhead_pct":
            (t_serve_dev - t_base) / t_base * 100.0,
        # None where no peak is known (the CPU): never coerce it to 0
        "serve_mfu": dev_report["win"]["mfu"],
        "serve_model_flops_per_token": dev_pass_flops / n_tokens,
        "serve_device_flops_per_s": dev_report["win"]["flops_per_s"],
        "serve_overlap_headroom_pct":
            dev_report["win"]["overlap_headroom_pct"],
        "device_peak_flops_known": dev_report["peak_flops_known"],
        "serve_phase_pct": {
            p: prof_report["phases"][p]["pct_of_tick"]
            for p in profiler_mod.PHASES},
        "serve_phase_mean_ms": {
            p: prof_report["phases"][p]["mean_s"] * 1e3
            for p in profiler_mod.PHASES},
        "serve_goodput": eng.slo.goodput(),
        "static_batches": len(batches),
        "tokens": n_tokens,
        "n_requests": len(requests),
        "n_slots": n_slots,
        "max_len": max_len,
        "chunk": chunk,
    }
    if keep_tokens:
        result["serve_tokens"] = serve_tokens
        result["static_tokens"] = [
            out[j, :r.max_new_tokens].tolist()
            for b, out in enumerate(outs)
            for j, r in enumerate(requests[b * n_slots:
                                           (b + 1) * n_slots])]
    return result


def measure_prefix_throughput(
    params: dict, cfg: llama.LlamaConfig, requests: list[Request], *,
    n_slots: int, max_len: int, chunk: int,
    block_size: int | None = None, n_blocks: int | None = None,
) -> dict:
    """Prefix-cache-on vs cache-off throughput on one workload (the
    ``serve_prefix_*`` bench metrics).

    Both engines serve the same queue; the cache-on engine is warmed by
    a full untimed pass (which also populates the radix index — the
    steady state of a server that has seen its system prompt before),
    mirrored by an untimed cache-off warmup, so the timed passes compare
    prefill-skipping against recompute on equal footing.  Outputs are
    asserted token-identical between the two engines (the parity
    guarantee).  Returns ``serve_prefix_tokens_per_sec`` (cache on),
    ``serve_prefix_off_tokens_per_sec``, ``serve_prefix_speedup``,
    ``serve_prefix_hit_rate`` (admissions with >= 1 reused block over
    all admissions, timed pass), ``serve_prefix_tokens_skipped`` and
    workload shape fields.
    """
    if not requests:
        raise ValueError("empty workload")
    kw = dict(n_slots=n_slots, max_len=max_len, chunk=chunk,
              block_size=block_size, n_blocks=n_blocks)
    timings: dict[bool, float] = {}
    outputs: dict[bool, list[RequestResult]] = {}
    hit_rate = 0.0
    tokens_skipped = 0
    n_tokens = 0
    for cache_on in (False, True):
        eng = ServeEngine(params, cfg, prefix_cache=cache_on, **kw)
        warm = eng.run(requests)
        assert all(r.ok for r in warm), [r.status for r in warm]
        n_tokens = sum(len(t) for t in warm)
        hits0 = eng.prefix_counters["hits"]
        skip0 = eng.prefix_counters["tokens_skipped"]
        _wait(eng.device)
        t0 = time.perf_counter()
        out = eng.run(requests)
        _wait(eng.device)
        timings[cache_on] = time.perf_counter() - t0
        outputs[cache_on] = out
        if cache_on:
            hit_rate = ((eng.prefix_counters["hits"] - hits0)
                        / len(requests))
            tokens_skipped = (eng.prefix_counters["tokens_skipped"]
                              - skip0)
    assert [list(a) for a in outputs[True]] == \
        [list(b) for b in outputs[False]], "prefix-cache parity broken"
    return {
        "serve_prefix_tokens_per_sec": n_tokens / timings[True],
        "serve_prefix_off_tokens_per_sec": n_tokens / timings[False],
        "serve_prefix_speedup": timings[False] / timings[True],
        "serve_prefix_hit_rate": hit_rate,
        "serve_prefix_tokens_skipped": tokens_skipped,
        "tokens": n_tokens,
        "n_requests": len(requests),
        "n_slots": n_slots,
        "max_len": max_len,
        "chunk": chunk,
    }


def measure_spec_throughput(
    params: dict, cfg: llama.LlamaConfig, requests: list[Request], *,
    n_slots: int, max_len: int, chunk: int,
    block_size: int | None = None, n_blocks: int | None = None,
    draft_k: int = 4, keep_tokens: bool = False,
) -> dict:
    """Speculation-on vs plain-decode throughput on one workload (the
    ``serve_spec_*`` bench metrics).

    Both engines serve the same queue; each is warmed by a full untimed
    pass, then timed on a second pass.  Outputs are asserted
    token-identical between the two engines — the greedy bit-identity
    guarantee of :func:`llama.spec_verify_paged
    <horovod_tpu_torch.models.llama.spec_verify_paged>` — so the ratio
    prices pure scheduling, never output drift.  Returns
    ``serve_spec_tokens_per_sec`` (spec on),
    ``serve_spec_plain_tokens_per_sec``, ``serve_spec_vs_plain_ratio``,
    ``serve_spec_accepted_per_round`` (mean accepted drafts per decoding
    row per verify round, timed pass), ``serve_spec_rounds`` (timed-pass
    verify ticks), ``draft_k`` and workload shape fields.  The ratio
    beats 1 exactly when acceptance buys more rounds than the wider tick
    costs.

    ``keep_tokens=True`` returns both engines' tokens
    (``serve_spec_tokens``, ``serve_spec_plain_tokens``) instead of
    asserting them equal, for a caller that holds them to a tolerance: on the card, bf16 products
    over the verify tick's ``draft_k + 1`` rows a slot need not round as
    the plain tick's one row does, so a near-tie can flip a token.

    ``measure_tp_throughput``, the reference's tensor-parallel sweep,
    waits for tensor-parallel serving (ROADMAP item 12b).
    """
    if not requests:
        raise ValueError("empty workload")
    kw = dict(n_slots=n_slots, max_len=max_len, chunk=chunk,
              block_size=block_size, n_blocks=n_blocks,
              metrics=metrics_mod.NULL)
    timings: dict[bool, float] = {}
    outputs: dict[bool, list[RequestResult]] = {}
    n_tokens = 0
    accepted_per_round = 0.0
    rounds = 0
    for spec_on in (False, True):
        eng = ServeEngine(params, cfg, spec=spec_on, draft_k=draft_k,
                          **kw)
        warm = eng.run(requests)
        assert all(r.ok for r in warm), [r.status for r in warm]
        n_tokens = sum(len(t) for t in warm)
        acc0 = eng.spec_counters["accepted"]
        rr0 = eng.spec_counters["row_rounds"]
        rounds0 = eng.spec_counters["rounds"]
        _wait(eng.device)
        t0 = time.perf_counter()
        out = eng.run(requests)
        _wait(eng.device)
        timings[spec_on] = time.perf_counter() - t0
        outputs[spec_on] = out
        if spec_on:
            rr = eng.spec_counters["row_rounds"] - rr0
            accepted_per_round = (
                (eng.spec_counters["accepted"] - acc0) / rr if rr
                else 0.0)
            rounds = eng.spec_counters["rounds"] - rounds0
    tokens = {on: [[int(t) for t in r] for r in outputs[on]]
              for on in (False, True)}
    if not keep_tokens:
        assert tokens[True] == tokens[False], "speculation parity broken"
    result = {
        "serve_spec_tokens_per_sec": n_tokens / timings[True],
        "serve_spec_plain_tokens_per_sec": n_tokens / timings[False],
        "serve_spec_vs_plain_ratio": timings[False] / timings[True],
        "serve_spec_accepted_per_round": accepted_per_round,
        "serve_spec_rounds": rounds,
        "draft_k": draft_k,
        "tokens": n_tokens,
        "n_requests": len(requests),
        "n_slots": n_slots,
        "max_len": max_len,
        "chunk": chunk,
    }
    if keep_tokens:
        result["serve_spec_tokens"] = tokens[True]
        result["serve_spec_plain_tokens"] = tokens[False]
    return result
