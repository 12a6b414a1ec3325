"""Per-tick phase profiler for the serving engine.

A copy of ``horovod_tpu/profiler.py`` for the PyTorch port, which may not
import the JAX package (its ``__init__`` pulls in jax); environment
knobs are ``HVD_TORCH_*`` here.  Names of modules the port does not
have yet (the router, the monitor, tracing, ...) are the reference's.

Continuous-batching schedulers hide host-side stalls inside "decode
time": admission bookkeeping, chunked-prefill dispatch, the blocking
token readback, and per-request postprocessing all happen between two
device ticks, and a whole-step latency histogram cannot say which one
got slower.  vLLM and SGLang both ship per-phase step timing for
exactly this reason; :class:`TickProfiler` is that layer here, stdlib
only, threaded through :meth:`ServeEngine.step
<horovod_tpu_torch.serving_scheduler.ServeEngine.step>`.

Design rules (the acceptance criteria of the profiler):

* **Free when disabled.**  The engine holds ``prof = None`` and every
  call site is a single ``is not None`` test — no wrapper objects, no
  no-op method dispatch on the hot path.
* **No new jit signatures when enabled.**  The profiler only reads
  ``time.perf_counter()`` and feeds host-side instruments; it never
  touches a traced value, so ``compile_cache_sizes()`` is unchanged
  (pinned by ``tests/test_profiler.py``).
* **Phases tile the tick.**  ``mark(phase)`` charges the time since the
  previous boundary, so the top-level :data:`PHASES` sum to the
  measured step wall time by construction (the final ``mark`` →
  ``return`` gap is a few statements of python).  :data:`SUB_PHASES`
  are attributed *inside* their parent via explicit ``add()`` intervals
  and are excluded from the coverage arithmetic.

Each tick lands in three sinks: per-phase histograms in the engine's
:class:`~horovod_tpu_torch.metrics.MetricsRegistry` (``serve.phase.*_s``),
closed async spans named ``phase/<name>`` on the timeline (id = step,
aggregated by ``tools/timeline_summary.py``), and one
``serve.profile_tick`` structured event when the registry has a JSONL
sink (replayed by ``tools/profile_report.py``).  ``report()`` summarizes
a rolling window of the last ``HVD_TORCH_PROFILE_WINDOW`` ticks — the
payload of ``metrics_snapshot()["profile"]`` and the monitor's
``/profile`` endpoint.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Any

from horovod_tpu_torch import metrics as metrics_mod

#: Top-level phases in ``step()`` order.  They TILE the tick — each is
#: measured boundary-to-boundary, so their sum equals the tick wall time.
#: Every engine produces exactly these; schema consumers (replay,
#: timeline aggregation, the bench arm) may rely on their presence.
PHASES = ("expire", "admit", "decode_dispatch", "device_sync",
          "sample_postprocess", "bookkeeping")

#: Extra top-level phases that fire only on spec-enabled engines
#: (``draft`` before dispatch, ``verify`` in place of part of
#: ``sample_postprocess``).  They tile the tick exactly like
#: :data:`PHASES` but are surfaced in ``report()`` only once observed,
#: so non-spec engines keep the plain report schema byte-for-byte.
SPEC_PHASES = ("draft", "verify")

#: Nested sub-phases (explicit intervals inside a parent phase).  They
#: overlap their parent, so coverage math skips them.  The
#: ``device_sync`` pair is the device-telemetry split of the readback
#: wait: cost-model-predicted device compute vs host stall (only
#: emitted when the engine runs with ``device_telemetry``).
SUB_PHASES = ("admit.cache_acquire", "admit.prefill_dispatch",
              "device_sync.compute_est", "device_sync.host_stall")

_DEFAULT_WINDOW = 256

#: The timeline track profiler spans live on.
TRACK = "serving.profiler"


def _env_window() -> int:
    raw = os.environ.get("HVD_TORCH_PROFILE_WINDOW", "")
    try:
        return int(raw) if raw else _DEFAULT_WINDOW
    except ValueError:
        return _DEFAULT_WINDOW


class TickProfiler:
    """Mark-based per-tick phase timer.

    The engine thread drives ``begin(step)`` → ``mark(phase)`` /
    ``add(sub_phase, t0, t1)`` → ``end()`` once per ``step()``; the
    monitor thread calls ``report()`` on scrape.  Only the rolling
    window crosses threads — the per-tick scratch state is engine-thread
    private by construction (one ``step()`` at a time)."""

    _GUARDED_BY_LOCK = ("_ring", "_n_ticks")

    def __init__(self, metrics: "metrics_mod.MetricsRegistry",
                 timeline: Any = None, window: int | None = None):
        window = _env_window() if window is None else window
        if window < 1:
            raise ValueError(f"profile window must be >= 1, got {window}")
        self.window = window
        self.metrics = metrics
        self.timeline = timeline
        self._lock = threading.Lock()
        self._ring: collections.deque[dict] = collections.deque(
            maxlen=window)
        self._n_ticks = 0
        # engine-thread scratch (never read off-thread)
        self._cur: dict[str, float] = {}
        self._t0 = 0.0
        self._t_last = 0.0
        self._step = -1
        # Pre-bound histograms, registered by LITERAL name (the HVD005
        # contract) so the snapshot is schema-stable from tick 0 and the
        # hot path never does a registry lookup.
        self._hists = {
            "expire": metrics.histogram("serve.phase.expire_s"),
            "admit": metrics.histogram("serve.phase.admit_s"),
            "admit.cache_acquire":
                metrics.histogram("serve.phase.admit_cache_acquire_s"),
            "admit.prefill_dispatch":
                metrics.histogram("serve.phase.admit_prefill_dispatch_s"),
            "draft": metrics.histogram("serve.phase.draft_s"),
            "decode_dispatch":
                metrics.histogram("serve.phase.decode_dispatch_s"),
            "device_sync": metrics.histogram("serve.phase.device_sync_s"),
            "device_sync.compute_est": metrics.histogram(
                "serve.phase.device_sync_compute_est_s"),
            "device_sync.host_stall": metrics.histogram(
                "serve.phase.device_sync_host_stall_s"),
            "verify": metrics.histogram("serve.phase.verify_s"),
            "sample_postprocess":
                metrics.histogram("serve.phase.sample_postprocess_s"),
            "bookkeeping": metrics.histogram("serve.phase.bookkeeping_s"),
            "tick": metrics.histogram("serve.phase.tick_s"),
        }
        assert set(self._hists) == (set(PHASES) | set(SPEC_PHASES)
                                    | set(SUB_PHASES) | {"tick"})

    # -- hot path (engine thread) ------------------------------------------

    def begin(self, step: int) -> None:
        """Open a tick: resets the scratch dict and both clocks."""
        self._step = step
        self._cur = {}
        self._t0 = self._t_last = time.perf_counter()

    def mark(self, phase: str) -> None:
        """Close the current tiling boundary: charges ``phase`` with the
        time since the previous ``mark``/``begin``."""
        now = time.perf_counter()
        t0, self._t_last = self._t_last, now
        self._cur[phase] = self._cur.get(phase, 0.0) + (now - t0)
        if self.timeline is not None:
            self.timeline.async_span(TRACK, "phase/" + phase,
                                     self._step, t0, now)

    def add(self, phase: str, t0: float, t1: float) -> None:
        """Attribute an explicit ``[t0, t1]`` ``perf_counter`` interval
        to a nested sub-phase WITHOUT moving the tiling boundary (the
        parent phase still covers it)."""
        self._cur[phase] = self._cur.get(phase, 0.0) + (t1 - t0)
        if self.timeline is not None:
            self.timeline.async_span(TRACK, "phase/" + phase,
                                     self._step, t0, t1)

    def end(self) -> None:
        """Close the tick: the trailing time becomes ``bookkeeping``,
        every phase feeds its histogram, the tick joins the rolling
        window, and one ``serve.profile_tick`` event is emitted."""
        self.mark("bookkeeping")
        cur = self._cur
        cur["tick"] = self._t_last - self._t0
        for phase, dt in cur.items():
            h = self._hists.get(phase)
            if h is not None:
                h.observe(dt)
        with self._lock:
            self._ring.append(cur)
            self._n_ticks += 1
        self.metrics.event(
            "serve.profile_tick", step=self._step, tick_s=cur["tick"],
            phases={k: v for k, v in cur.items() if k != "tick"})

    # -- reporting (any thread) --------------------------------------------

    def report(self) -> dict:
        """Rolling-window per-phase summary: for each phase its sample
        count, total/mean/max seconds and share of tick time, plus the
        tick totals and ``coverage`` — the fraction of windowed tick
        wall time the top-level phases account for (≈ 1.0 by the tiling
        construction).  The same schema ``tools/profile_report.py``
        renders and diffs."""
        with self._lock:
            items = list(self._ring)
            n_ticks = self._n_ticks
        n = len(items)
        ticks = [it.get("tick", 0.0) for it in items]
        tick_total = sum(ticks)
        phases: dict[str, dict] = {}
        tiled = 0.0
        # Spec phases (and any future mark names) join the report only
        # once a tick actually recorded them — non-spec engines keep
        # the fixed PHASES schema.
        extra = sorted({k for it in items for k in it}
                       - set(PHASES) - set(SUB_PHASES) - {"tick"})
        for phase in PHASES + tuple(extra) + SUB_PHASES:
            vals = [it[phase] for it in items if phase in it]
            total = sum(vals)
            phases[phase] = {
                "count": len(vals),
                "total_s": total,
                "mean_s": total / len(vals) if vals else 0.0,
                "max_s": max(vals) if vals else 0.0,
                "pct_of_tick": (100.0 * total / tick_total
                                if tick_total else 0.0),
            }
            if phase not in SUB_PHASES:
                tiled += total
        return {
            "window": self.window,
            "n": n,
            "ticks": n_ticks,
            "tick": {
                "count": n,
                "total_s": tick_total,
                "mean_s": tick_total / n if n else 0.0,
                "max_s": max(ticks, default=0.0),
            },
            "phases": phases,
            "coverage": tiled / tick_total if tick_total else 1.0,
        }
