"""Device-side observability for the serving engine: cost model, compile
ledger, HBM accounting, transfer stamps, and live serving MFU.

Port of ``horovod_tpu/device_telemetry.py``.  The report schema, the
metric names and the event-log records are the reference's; what the
instruments read is PyTorch's:

* **Static cost model** — :meth:`DeviceTelemetry.capture` counts one call
  of each of the engine's programs (``tick`` / ``chunk`` / ``set_row`` /
  ``spec_tick``) once, at construction, under ``FakeTensorMode`` on fake
  copies of the live arguments: ``FlopCounterMode`` gives the FLOPs (2
  per multiply-add, every layer counted) and a small dispatch mode sums
  the input and output bytes of every aten op that is not a view, which
  in eager mode is one kernel's traffic.  No kernel runs, the paged pool
  is not written, and the program's signature set is untouched, so
  ``compile_cache_sizes()`` is the same telemetry on and off.  The
  reference reads XLA's ``cost_analysis()``, which counts a scanned
  layer body once; the port's counts equal the analytic ones.
* **Compile ledger** — eager programs compile nothing: every capture
  records ``compile_s`` 0.0, and :meth:`on_retrace` counts the retrace
  sentry's new signatures but charges them 0 s (a captured CUDA graph
  would make them cost something).
* **HBM accounting** — :meth:`on_step` polls the caching allocator at the
  ``HVD_TORCH_DEVICE_POLL_S`` cadence: ``allocated_bytes.all.current`` /
  ``.peak`` of ``torch.cuda.memory_stats`` and the card's total from
  ``torch.cuda.mem_get_info`` feed ``device.bytes_in_use`` /
  ``device.peak_bytes_in_use`` / ``device.hbm_used_fraction``; on the
  CPU there is nothing to poll, the report says ``{"available": false}``
  and no gauge is minted.  :meth:`report` reconciles the bytes in use
  with the engine's own parameter and pool bytes.
* **Transfer + sync split** — the engine stamps the bytes it uploads per
  program call and reads back per tick (``device.h2d_bytes`` /
  ``device.d2h_bytes``), and :meth:`on_sync` splits the measured
  readback wait into the cost model's predicted compute (FLOPs / peak,
  clipped to the wait) and host stall, which feed the profiler's
  ``device_sync.compute_est`` / ``device_sync.host_stall`` sub-phases and
  ``device.overlap_headroom_pct``.

The live MFU (``serve.mfu``) divides the window's counted FLOPs per
second by the card's peak from :data:`PEAK_FLOPS_TABLE` (dense bf16, one
number a card whatever the engine's dtype: an f32 engine is divided by
the bf16 peak too) or ``HVD_TORCH_PEAK_FLOPS``, times ``n_devices``, the
cards one engine spans (its ``tp_size``, as the reference scales its
per-chip peak).  A tensor-parallel engine's capture runs its own rank's
shard of each program (no collective crosses a wire on fake tensors) and
records the counts times ``shards``: every counted product (the
projections, the attention einsums, the MLP and the head) splits evenly
over the ranks, so the FLOPs are the whole program's exactly; the bytes
are the shards' summed.  A device without a known
peak (the CPU) leaves ``device.peak_flops_known`` at 0 and the gauge
absent, never a zero.

Replay: one ``device.capture`` event per program and one ``device.tick``
event per step; :func:`report_from_events` rebuilds the report from those
records alone.  Only :mod:`horovod_tpu_torch.metrics` and torch are
imported at module level; the fake-tensor machinery loads inside
:func:`count_cost`.
"""

from __future__ import annotations

import collections
import os
import time
import warnings
from typing import Any

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from horovod_tpu_torch import metrics as metrics_mod

#: The engine's programs, in capture order (``spec_tick`` only on spec
#: engines).
PROGRAMS = ("tick", "chunk", "set_row", "spec_tick")

#: Dense bf16 peak FLOP/s per card, matched as lowercase substrings of
#: ``torch.cuda.get_device_name``; first match wins, so the PCIe part
#: comes before the SXM one.  No entry matches a CPU: MFU is then not
#: emitted at all.
PEAK_FLOPS_TABLE: tuple[tuple[str, float], ...] = (
    ("h100 pcie", 756e12),
    ("h100", 989e12),
)

_DEFAULT_WINDOW = 256

_DEFAULT_POLL_S = 1.0


def _env_poll_s() -> float:
    raw = os.environ.get("HVD_TORCH_DEVICE_POLL_S", "")
    try:
        return float(raw) if raw else _DEFAULT_POLL_S
    except ValueError:
        return _DEFAULT_POLL_S


def _env_peak_flops() -> float | None:
    """Per-card peak override for hardware the table has not met."""
    raw = os.environ.get("HVD_TORCH_PEAK_FLOPS", "")
    try:
        return float(raw) if raw else None
    except ValueError:
        warnings.warn(
            f"HVD_TORCH_PEAK_FLOPS={raw!r} is not a float; ignoring",
            RuntimeWarning, stacklevel=2)
        return None


def lookup_peak_flops(device_kind: str) -> float | None:
    """Table lookup by device-name substring; None = honest unknown."""
    kind = device_kind.lower()
    for key, peak in PEAK_FLOPS_TABLE:
        if key in kind:
            return peak
    return None


def _identify(device: torch.device | str) -> tuple[str, str]:
    """(platform, kind) of a torch device: its ``type`` and, on the card,
    ``torch.cuda.get_device_name``."""
    device = torch.device(device)
    if device.type == "cuda":
        return "cuda", torch.cuda.get_device_name(device)
    return device.type, device.type


class _ByteCounter(TorchDispatchMode):
    """Sums, for every aten op that makes a tensor and is not a view, the
    bytes of its distinct tensor inputs and of its outputs that are not
    one of them (an in-place op's result is its argument).  Metadata
    queries (``prim.device``, ``aten.sym_size``, ...) return no tensor and
    move nothing."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        if outs and func.namespace == "aten" and not func.is_view:
            seen: set[int] = set()
            for t in pytree.tree_leaves((args, kwargs)) + outs:
                if isinstance(t, torch.Tensor) and id(t) not in seen:
                    seen.add(id(t))
                    self.bytes += t.numel() * t.element_size()
        return out


def count_cost(fn: Any, *args: Any) -> tuple[float, float]:
    """(FLOPs, bytes) of one call ``fn(*args)``, counted on fake copies of
    the tensors in ``args``: nothing runs on the device and nothing the
    arguments hold is written."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    mode = FakeTensorMode(allow_non_fake_inputs=True)
    fake = pytree.tree_map(
        lambda x: mode.from_tensor(x) if isinstance(x, torch.Tensor)
        else x, args)
    flops = FlopCounterMode(display=False)
    nbytes = _ByteCounter()
    with mode, flops, nbytes:
        fn(*fake)
    return float(flops.get_total_flops()), float(nbytes.bytes)


class DeviceTelemetry:
    """Per-engine device observability plane.

    The engine thread drives :meth:`dispatch` / :meth:`on_sync` /
    :meth:`on_step` once per program call / readback / step; the monitor
    thread calls :meth:`report` on scrape.  ``device``: the device the
    engine serves on (the engine binds it with :meth:`bind` when the
    plane is handed in unbound); until then platform and kind read
    ``unknown``.  Every hot-path call is gated at the engine by one
    ``is not None`` test, so telemetry off costs nothing."""

    def __init__(self, registry: "metrics_mod.MetricsRegistry",
                 *, device: torch.device | str | None = None,
                 n_devices: int = 1,
                 window: int | None = None,
                 poll_s: float | None = None,
                 peak_flops: float | None = None):
        self.metrics = registry
        self.n_devices = max(int(n_devices), 1)
        self.window = _DEFAULT_WINDOW if window is None else int(window)
        if self.window < 1:
            raise ValueError(
                f"device window must be >= 1, got {self.window}")
        self.poll_s = _env_poll_s() if poll_s is None else float(poll_s)
        self._peak_arg = peak_flops
        #: per-program cost-model rows: flops / bytes_accessed /
        #: compile_s / dispatches (cumulative).
        self.programs: dict[str, dict] = {}
        # Model-side device bytes for HBM reconciliation (the engine
        # sets these from its own exact accounting).
        self.param_bytes = 0
        self.kv_total_bytes = 0
        self.total_flops = 0.0
        self.total_h2d = 0
        self.total_d2h = 0
        self.dispatch_totals: dict[str, int] = {}
        self.retraces = 0
        self.retrace_compile_est_s = 0.0
        # Rolling window: explicit popleft keeps O(1) running sums.
        self._ring: collections.deque[dict] = collections.deque()
        self._sums = {"dt_s": 0.0, "flops": 0.0, "bytes_accessed": 0.0,
                      "h2d_bytes": 0.0, "d2h_bytes": 0.0, "sync_s": 0.0,
                      "compute_est_s": 0.0, "host_stall_s": 0.0}
        self._ticks = 0
        self._pend = self._fresh_pend()
        self._last_step_ts: float | None = None
        self._last_poll_ts: float | None = None
        self._bytes_limit: int | None = None
        self.last_memory: dict | None = None
        self._c_compiles = registry.counter("device.compiles")
        self._h_compile_s = registry.histogram("device.compile_s")
        self._c_flops = registry.counter("device.model_flops")
        self._c_h2d = registry.counter("device.h2d_bytes")
        self._c_d2h = registry.counter("device.d2h_bytes")
        self._g_headroom = registry.gauge("device.overlap_headroom_pct")
        self.device: torch.device | None = None
        self.platform = self.device_kind = "unknown"
        self._set_peak()
        if device is not None:
            self.bind(device)

    def bind(self, device: torch.device | str) -> None:
        """Serve on ``device``: its identity picks the peak and the memory
        the plane polls."""
        self.device = torch.device(device)
        self.platform, self.device_kind = _identify(self.device)
        self._bytes_limit = None
        self._set_peak()

    def _set_peak(self) -> None:
        per_card = (self._peak_arg if self._peak_arg is not None
                    else _env_peak_flops())
        self.peak_source = "arg" if self._peak_arg is not None else (
            "env" if per_card is not None else "table")
        if per_card is None:
            per_card = lookup_peak_flops(self.device_kind)
        if per_card is None:
            self.peak_source = None
        self.peak_flops = (per_card * self.n_devices
                           if per_card is not None else None)
        self.peak_flops_known = self.peak_flops is not None
        self.metrics.gauge("device.peak_flops_known").set(
            1 if self.peak_flops_known else 0)

    def _fresh_pend(self) -> dict:
        return {"dispatches": {}, "flops": 0.0, "bytes_accessed": 0.0,
                "h2d_bytes": 0, "d2h_bytes": 0, "sync_s": 0.0,
                "compute_est_s": 0.0, "host_stall_s": 0.0}

    # -- cost model + compile ledger (engine construction) -----------------

    def set_model_bytes(self, *, param_bytes: int,
                        kv_total_bytes: int) -> None:
        """Exact model-side device bytes, for HBM reconciliation."""
        self.param_bytes = int(param_bytes)
        self.kv_total_bytes = int(kv_total_bytes)

    def capture(self, name: str, fn: Any, *args: Any,
                shards: int = 1) -> dict:
        """Count one call ``fn(*args)`` of program ``name`` (see
        :func:`count_cost`) and record its row; ``shards``: ``fn`` is one
        of that many equal tensor-parallel shards of the program, whose
        counts are recorded times ``shards``.  ``compile_s`` is 0.0: an
        eager program compiles nothing.  A failed count degrades to a
        zeroed row with an ``error`` and a warning (telemetry never breaks
        serving; callers that must not degrade check the row)."""
        entry = {"flops": 0.0, "bytes_accessed": 0.0, "compile_s": 0.0,
                 "dispatches": 0}
        try:
            flops, nbytes = count_cost(fn, *args)
            entry["flops"], entry["bytes_accessed"] = (flops * shards,
                                                       nbytes * shards)
        except Exception as exc:  # noqa: BLE001 — degrade, don't break serving
            entry["error"] = repr(exc)
            warnings.warn(
                f"device cost capture failed for {name!r} ({exc!r}); "
                "telemetry continues without its cost model",
                RuntimeWarning, stacklevel=2)
        self.programs[name] = entry
        self._c_compiles.inc()
        self._h_compile_s.observe(entry["compile_s"])
        self.metrics.event(
            "device.capture", program=name, flops=entry["flops"],
            bytes_accessed=entry["bytes_accessed"],
            compile_s=entry["compile_s"], platform=self.platform,
            device_kind=self.device_kind, n_devices=self.n_devices,
            peak_flops=self.peak_flops,
            peak_flops_known=self.peak_flops_known)
        return entry

    def on_retrace(self, grew: dict) -> None:
        """Count the retrace sentry's new signatures; each is charged its
        program's ``compile_s``, 0.0 for eager programs."""
        for prog, (before, after) in grew.items():
            n = after - max(before, 1)
            if n <= 0:
                continue
            self.retraces += n
            self._c_compiles.inc(n)
            est = self.programs.get(prog, {}).get("compile_s", 0.0)
            self.retrace_compile_est_s += est * n

    # -- hot path (engine thread) ------------------------------------------

    def dispatch(self, name: str, h2d_bytes: int = 0) -> None:
        """One call of program ``name``, with the bytes the engine
        uploaded for it (its pinned host arrays; the persistent pool and
        logits transfer nothing)."""
        p = self._pend
        p["dispatches"][name] = p["dispatches"].get(name, 0) + 1
        self.dispatch_totals[name] = (
            self.dispatch_totals.get(name, 0) + 1)
        entry = self.programs.get(name)
        if entry is not None:
            p["flops"] += entry["flops"]
            p["bytes_accessed"] += entry["bytes_accessed"]
        p["h2d_bytes"] += h2d_bytes

    def on_sync(self, name: str, t0: float, t1: float,
                d2h_bytes: int = 0) -> tuple[float, float]:
        """Split one measured readback wait ``[t0, t1]`` into (predicted
        device compute, host stall): predicted = FLOPs / peak of program
        ``name``, clipped to the wait.  Without a peak (the CPU) the split
        is all compute: no stall can be proven, so none is claimed."""
        sync_s = max(t1 - t0, 0.0)
        est = sync_s
        if self.peak_flops:
            entry = self.programs.get(name)
            if entry is not None and entry["flops"] > 0.0:
                est = min(entry["flops"] / self.peak_flops, sync_s)
        stall = sync_s - est
        p = self._pend
        p["d2h_bytes"] += d2h_bytes
        p["sync_s"] += sync_s
        p["compute_est_s"] += est
        p["host_stall_s"] += stall
        return est, stall

    def start(self) -> None:
        """Start the window clock if it is not running; the engine calls
        this at the top of every step, so the first step's time counts
        with its FLOPs."""
        if self._last_step_ts is None:
            self._last_step_ts = time.perf_counter()

    def on_step(self, step: int) -> None:
        """Close the step's record: fold it into the rolling window,
        refresh the gauges and counters, poll memory at the configured
        cadence, and emit one ``device.tick`` event.  The step's time runs
        from the previous step's close, or from :meth:`start` for the
        first."""
        now = time.perf_counter()
        dt = (now - self._last_step_ts
              if self._last_step_ts is not None else 0.0)
        self._last_step_ts = now
        p = self._pend
        self._pend = self._fresh_pend()
        rec = {"step": step, "dt_s": dt, "flops": p["flops"],
               "bytes_accessed": p["bytes_accessed"],
               "h2d_bytes": p["h2d_bytes"], "d2h_bytes": p["d2h_bytes"],
               "sync_s": p["sync_s"],
               "compute_est_s": p["compute_est_s"],
               "host_stall_s": p["host_stall_s"],
               "dispatches": p["dispatches"]}
        if len(self._ring) >= self.window:
            old = self._ring.popleft()
            for k in self._sums:
                self._sums[k] -= old[k]
        self._ring.append(rec)
        for k in self._sums:
            self._sums[k] += rec[k]
        self._ticks += 1
        self.total_flops += p["flops"]
        self.total_h2d += p["h2d_bytes"]
        self.total_d2h += p["d2h_bytes"]
        if p["flops"]:
            self._c_flops.inc(int(p["flops"]))
        if p["h2d_bytes"]:
            self._c_h2d.inc(p["h2d_bytes"])
        if p["d2h_bytes"]:
            self._c_d2h.inc(p["d2h_bytes"])
        win = self._sums
        if win["dt_s"] > 0.0:
            self._g_headroom.set(
                100.0 * win["compute_est_s"] / win["dt_s"])
            if self.peak_flops:
                # Minted only here: no honest peak, no MFU gauge.
                self.metrics.gauge("serve.mfu").set(
                    win["flops"] / win["dt_s"] / self.peak_flops)
        if win["bytes_accessed"] > 0.0:
            self.metrics.gauge("serve.arithmetic_intensity").set(
                win["flops"] / win["bytes_accessed"])
        if (self._last_poll_ts is None
                or now - self._last_poll_ts >= self.poll_s):
            self._last_poll_ts = now
            self.poll_memory()
        self.metrics.event("device.tick", **rec)

    def poll_memory(self) -> dict | None:
        """One poll of the caching allocator of the bound card.  A device
        without one (the CPU, or none bound) returns None: the gauges are
        never minted and ``last_memory`` records the absence.  Neither
        call waits for the card."""
        dev = self.device
        if dev is None or dev.type != "cuda":
            self.last_memory = {"available": False}
            return None
        stats = torch.cuda.memory_stats(dev)
        if self._bytes_limit is None:
            self._bytes_limit = int(torch.cuda.mem_get_info(dev)[1])
        mem = {"available": True,
               "bytes_in_use": int(stats.get(
                   "allocated_bytes.all.current", 0)),
               "peak_bytes_in_use": int(stats.get(
                   "allocated_bytes.all.peak", 0)),
               "bytes_limit": self._bytes_limit}
        self.last_memory = mem
        self.metrics.gauge("device.bytes_in_use").set(
            mem["bytes_in_use"])
        self.metrics.gauge("device.peak_bytes_in_use").set(
            mem["peak_bytes_in_use"])
        if mem["bytes_limit"] > 0:
            self.metrics.gauge("device.hbm_used_fraction").set(
                mem["bytes_in_use"] / mem["bytes_limit"])
        self.metrics.event("device.memory", **mem)
        return mem

    # -- reporting (any thread) --------------------------------------------

    def report(self) -> dict:
        """The ``/device`` payload: platform and peak provenance, the
        per-program cost table, the compile ledger, the rolling-window
        numbers (MFU only with a peak), and the HBM reconciliation when
        the device reports memory."""
        ring = list(self._ring)
        return build_report(
            platform=self.platform, device_kind=self.device_kind,
            n_devices=self.n_devices, peak_flops=self.peak_flops,
            peak_flops_known=self.peak_flops_known,
            peak_source=self.peak_source,
            programs={k: dict(v, dispatches=self.dispatch_totals.get(
                k, 0)) for k, v in self.programs.items()},
            compiles=int(self._c_compiles.value),
            compile_total_s=float(self._h_compile_s.sum),
            retraces=self.retraces,
            retrace_compile_est_s=self.retrace_compile_est_s,
            ticks=self._ticks, window=self.window, ring=ring,
            memory=self.last_memory, param_bytes=self.param_bytes,
            kv_total_bytes=self.kv_total_bytes)


def build_report(*, platform: str, device_kind: str, n_devices: int,
                 peak_flops: float | None, peak_flops_known: bool,
                 peak_source: str | None, programs: dict, compiles: int,
                 compile_total_s: float, retraces: int,
                 retrace_compile_est_s: float, ticks: int, window: int,
                 ring: list, memory: dict | None, param_bytes: int,
                 kv_total_bytes: int) -> dict:
    """Assemble the report schema from collected records: the shared shape
    of the live :meth:`DeviceTelemetry.report` and the event-log replay
    (:func:`report_from_events`).  Pure arithmetic over its inputs."""
    sums = {k: 0.0 for k in ("dt_s", "flops", "bytes_accessed",
                             "h2d_bytes", "d2h_bytes", "sync_s",
                             "compute_est_s", "host_stall_s")}
    dispatches: dict[str, int] = {}
    for rec in ring:
        for k in sums:
            sums[k] += rec.get(k, 0.0)
        for prog, n in (rec.get("dispatches") or {}).items():
            dispatches[prog] = dispatches.get(prog, 0) + int(n)
    dt = sums["dt_s"]
    win: dict[str, Any] = {
        "n": len(ring),
        "elapsed_s": dt,
        "flops": sums["flops"],
        "bytes_accessed": sums["bytes_accessed"],
        "h2d_bytes": int(sums["h2d_bytes"]),
        "d2h_bytes": int(sums["d2h_bytes"]),
        "sync_s": sums["sync_s"],
        "compute_est_s": sums["compute_est_s"],
        "host_stall_s": sums["host_stall_s"],
        "dispatches": dict(sorted(dispatches.items())),
        "flops_per_s": sums["flops"] / dt if dt else 0.0,
        "overlap_headroom_pct": (100.0 * sums["compute_est_s"] / dt
                                 if dt else 0.0),
        "arithmetic_intensity": (
            sums["flops"] / sums["bytes_accessed"]
            if sums["bytes_accessed"] else 0.0),
        # no peak, no MFU: the key is present but null
        "mfu": (sums["flops"] / dt / peak_flops
                if peak_flops and dt else None),
    }
    out: dict[str, Any] = {
        "platform": platform,
        "device_kind": device_kind,
        "n_devices": n_devices,
        "peak_flops": peak_flops,
        "peak_flops_known": peak_flops_known,
        "peak_flops_source": peak_source,
        "programs": {k: dict(v) for k, v in sorted(programs.items())},
        "compiles": compiles,
        "compile_total_s": compile_total_s,
        "retraces": retraces,
        "retrace_compile_est_s": retrace_compile_est_s,
        "ticks": ticks,
        "window": window,
        "win": win,
        "memory": memory,
    }
    if memory and memory.get("available"):
        model = param_bytes + kv_total_bytes
        out["reconciliation"] = {
            "param_bytes": param_bytes,
            "kv_total_bytes": kv_total_bytes,
            "model_bytes": model,
            "hbm_bytes_in_use": memory["bytes_in_use"],
            "framework_overhead_bytes":
                memory["bytes_in_use"] - model,
        }
    return out


def report_from_events(events: list[dict],
                       window: int | None = None) -> dict:
    """Rebuild the ``/device`` report from ``device.capture`` /
    ``device.tick`` / ``device.memory`` event-log records alone (no clock,
    no poll), so a replayed report agrees with the live one."""
    captures = [e for e in events if e.get("kind") == "device.capture"]
    ticks = [e for e in events if e.get("kind") == "device.tick"]
    mems = [e for e in events if e.get("kind") == "device.memory"]
    programs: dict[str, dict] = {}
    for e in captures:          # last capture per program wins
        programs[str(e.get("program"))] = {
            "flops": float(e.get("flops", 0.0)),
            "bytes_accessed": float(e.get("bytes_accessed", 0.0)),
            "compile_s": float(e.get("compile_s", 0.0)),
            "dispatches": 0,
        }
    for e in ticks:
        for prog, n in (e.get("dispatches") or {}).items():
            if prog in programs:
                programs[prog]["dispatches"] += int(n)
    head = captures[-1] if captures else {}
    peak = head.get("peak_flops")
    n_ticks = len(ticks)
    win_n = n_ticks if window is None else min(window, n_ticks)
    ring = [{k: e.get(k, 0.0) for k in
             ("step", "dt_s", "flops", "bytes_accessed", "h2d_bytes",
              "d2h_bytes", "sync_s", "compute_est_s", "host_stall_s")}
            | {"dispatches": e.get("dispatches") or {}}
            for e in ticks[-win_n:]] if win_n else []
    memory = None
    if mems:
        m = mems[-1]
        memory = {"available": True,
                  "bytes_in_use": int(m.get("bytes_in_use", 0)),
                  "peak_bytes_in_use": int(
                      m.get("peak_bytes_in_use", 0)),
                  "bytes_limit": int(m.get("bytes_limit", 0))}
    return build_report(
        platform=str(head.get("platform", "unknown")),
        device_kind=str(head.get("device_kind", "unknown")),
        n_devices=int(head.get("n_devices", 1)),
        peak_flops=peak,
        peak_flops_known=bool(head.get("peak_flops_known", False)),
        peak_source="replay" if peak is not None else None,
        programs=programs,
        compiles=len(captures),
        compile_total_s=sum(p["compile_s"] for p in programs.values()),
        retraces=0, retrace_compile_est_s=0.0,
        ticks=n_ticks, window=window if window is not None else win_n,
        ring=ring, memory=memory, param_bytes=0, kv_total_bytes=0)


def maybe_telemetry(registry: "metrics_mod.MetricsRegistry",
                    *, device: torch.device | str | None = None,
                    n_devices: int = 1) -> DeviceTelemetry | None:
    """Env factory: a plane when ``HVD_TORCH_DEVICE_TELEMETRY=1``, else
    None (the engine's ``device_telemetry=None`` default routes here)."""
    if os.environ.get("HVD_TORCH_DEVICE_TELEMETRY", "") != "1":
        return None
    return DeviceTelemetry(registry, device=device, n_devices=n_devices)
