"""Horovod Timeline: a Chrome-trace profile of the eager engine.

Port of ``horovod_tpu/timeline.py`` (the reference's timeline.h/.cc,
docs/timeline.md): with ``HOROVOD_TIMELINE=<path>``, a ``chrome://tracing``
JSON file in which every named tensor is its own "process" (pid), and its
track shows the phases of its collective:

  NEGOTIATE_ALLREDUCE / NEGOTIATE_ALLGATHER / ...
      enqueue until the engine decides to run the op (the fusion queue,
      or negotiation through the native controller).
  NEGOTIATE_TICK_r<k> / NEGOTIATE_TICK_ALL
      rank k's request arriving at rank 0's controller; without a
      controller, one instant for the whole world.
  ALLREDUCE / ALLGATHER / BROADCAST / ...
      the op's span (``fused_with: N``: the bucket's other tensors).
  DISPATCH / WAIT_FOR_OUTPUT
      the fusion copy and collective issue on the engine's stream, and the
      caller's wait in ``synchronize``.

The serving engine writes to the same file: per-step ``SCHED`` /
``LIFECYCLE`` / ``SPEC`` / ``PREFIX`` counters (:meth:`Timeline.counter`),
admit/recycle instants, one async span a request, and, with profiling on,
each tick's ``phase/*`` spans back-dated to the profiler's own clock reads
(:meth:`Timeline.async_span`).

The card's own detail belongs to ``torch.profiler``: ``start_timeline(...,
profiler_dir=...)`` records one over the timeline's window and
``stop_timeline`` writes its Chrome trace into that directory;
:func:`trace_annotation` (``torch.profiler.record_function``) names a
phase in that trace, so that the two can be lined up.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import TextIO

import torch

NEGOTIATE = "NEGOTIATE"
DISPATCH = "DISPATCH"
WAIT_FOR_OUTPUT = "WAIT_FOR_OUTPUT"


class Timeline:
    """Thread-safe Chrome-trace writer (reference timeline.cc:24-188).
    Events are buffered and written at most every second, or on close."""

    def __init__(self, path: str, mark_cycles: bool = False) -> None:
        self._lock = threading.Lock()
        self._path = path
        self.mark_cycles = mark_cycles
        self._file: TextIO = open(path, "w")
        self._file.write("[\n")
        self._start = time.perf_counter()
        self._pids: dict[str, int] = {}
        self._next_pid = 1
        self._buffer: list[str] = []
        self._last_flush = time.monotonic()
        self._closed = False

    def _ts_us(self) -> float:
        return (time.perf_counter() - self._start) * 1e6

    def _pid(self, tensor_name: str) -> int:
        pid = self._pids.get(tensor_name)
        if pid is None:
            pid = self._next_pid
            self._next_pid += 1
            self._pids[tensor_name] = pid
            # Tensor-as-process metadata (reference timeline.cc:51-67).
            self._emit({"name": "process_name", "ph": "M", "pid": pid,
                        "args": {"name": tensor_name}})
            self._emit({"name": "process_sort_index", "ph": "M", "pid": pid,
                        "args": {"sort_index": pid}})
        return pid

    def _emit(self, event: dict) -> None:
        self._buffer.append(json.dumps(event))
        now = time.monotonic()
        if now - self._last_flush > 1.0:
            self._flush_locked()
            self._last_flush = now

    def _flush_locked(self) -> None:
        if self._buffer:
            self._file.write(",\n".join(self._buffer) + ",\n")
            self._buffer.clear()
            self._file.flush()

    def _event(self, tensor_name: str, activity: str, ph: str,
               **fields) -> None:
        with self._lock:
            if self._closed:
                return
            self._emit({"name": activity, "ph": ph, "ts": self._ts_us(),
                        "pid": self._pid(tensor_name), **fields})

    def start(self, tensor_name: str, activity: str,
              args: dict | None = None) -> None:
        self._event(tensor_name, activity, "B", tid=0,
                    **({"args": args} if args else {}))

    def end(self, tensor_name: str, activity: str,
            args: dict | None = None) -> None:
        self._event(tensor_name, activity, "E", tid=0,
                    **({"args": args} if args else {}))

    def instant(self, tensor_name: str, activity: str) -> None:
        """A negotiation tick or an engine cycle (reference
        timeline.cc:118-126): a Chrome instant, ``ph: "i"``, thread scope."""
        self._event(tensor_name, activity, "i", tid=0, s="t")

    def counter(self, tensor_name: str, activity: str,
                values: dict) -> None:
        """A Chrome counter event (``ph: "C"``): a stacked series on the
        track, ``values`` mapping series name to number (the serving
        engine's per-step scheduler and lifecycle totals, speculative
        decoding's acceptance per round)."""
        self._event(tensor_name, activity, "C", args=values)

    def async_start(self, tensor_name: str, activity: str, aid: int) -> None:
        """Begin an async span (``ph: "b"``), matched by id rather than by
        the track's B/E stack, so it cannot mis-nest with a concurrent
        dispatch's spans on the same track."""
        self._event(tensor_name, activity, "b", cat=activity, id=aid, tid=0)

    def async_end(self, tensor_name: str, activity: str, aid: int) -> None:
        self._event(tensor_name, activity, "e", cat=activity, id=aid, tid=0)

    def async_span(self, tensor_name: str, activity: str, aid: int,
                   t0: float, t1: float) -> None:
        """A closed async span with the caller's ``time.perf_counter``
        stamps: its ``b`` and ``e`` events in one lock pass, back-dated
        to ``t0`` and ``t1`` (the serving profiler writes a tick's phases
        after the fact without moving their boundaries)."""
        with self._lock:
            if self._closed:
                return
            pid = self._pid(tensor_name)
            for ph, t in (("b", t0), ("e", t1)):
                self._emit({"name": activity, "ph": ph, "cat": activity,
                            "id": aid, "ts": (t - self._start) * 1e6,
                            "pid": pid, "tid": 0})

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._flush_locked()
            # A closing event after the last comma keeps the file strict JSON.
            self._file.write(json.dumps({"name": "done", "ph": "i",
                                         "ts": self._ts_us(), "pid": 0,
                                         "s": "g"}))
            self._file.write("\n]\n")
            self._file.close()


def trace_annotation(name: str):
    """Name an engine phase in ``torch.profiler``'s trace, so that the
    Chrome timeline and the card's profile line up."""
    return torch.profiler.record_function(name)


def maybe_create(path: str | None,
                 mark_cycles: bool = False) -> Timeline | None:
    """A timeline if one is configured: on rank 0 only (reference
    operations.cc:1614-1618), unless ``path`` holds ``{rank}``, in which
    case every rank writes its own file."""
    from horovod_tpu_torch import basics

    if not path:
        return None
    if "{rank}" in path:
        path = path.replace("{rank}", str(basics.rank()))
    elif basics.rank() != 0:
        return None
    dirname = os.path.dirname(path)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    return Timeline(path, mark_cycles=mark_cycles)


def _start_profiler(device: torch.device | None):
    """A running ``torch.profiler.profile`` of the host and, on the card,
    of CUDA kernels."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device is not None and device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def start_timeline(path: str, mark_cycles: bool = False,
                   profiler_dir: str | None = None) -> None:
    """Start recording a timeline mid-run (``hvd.start_timeline``,
    Horovod 0.20).  ``mark_cycles=True`` adds an instant per engine cycle.
    Rank 0 only unless ``path`` holds ``{rank}``; raises if a timeline is
    already active.

    ``profiler_dir`` also records a ``torch.profiler`` trace (the host
    and, on the card, its kernels) for the same window; ``stop_timeline``
    writes it to ``<profiler_dir>/trace_rank<r>.json``.  A profiler that
    fails to start (one already running, say) closes the new timeline and
    raises."""
    from horovod_tpu_torch import basics

    st = basics._require_init()
    with st.lock:
        if st.timeline is not None:
            raise ValueError(
                "a timeline is already active; call stop_timeline() first")
        tl = maybe_create(path, mark_cycles=mark_cycles)
        if tl is not None and profiler_dir:
            # before st.timeline is set: a failed start must not leave a
            # half-open timeline that later starts would refuse
            try:
                os.makedirs(profiler_dir, exist_ok=True)
                st.profiler = (_start_profiler(st.device), profiler_dir)
            except Exception:
                tl.close()
                raise
        st.timeline = tl
        if st.engine is not None and tl is not None:
            st.engine.timeline = tl
            if st.engine.controller is not None:
                st.engine.controller.enable_tick_trace()


def stop_timeline() -> None:
    """Stop the active timeline and finish its file (``hvd.stop_timeline``).
    Idempotent when none is active."""
    from horovod_tpu_torch import basics

    st = basics._require_init()
    with st.lock:
        tl, st.timeline = st.timeline, None
        profiling, st.profiler = st.profiler, None
        if st.engine is not None:
            st.engine.timeline = None
            if st.engine.controller is not None and tl is not None:
                # Rank 0 buffers arrivals only while a timeline drains them.
                st.engine.controller.enable_tick_trace(False)
    if profiling is not None:
        prof, profiler_dir = profiling
        try:
            prof.stop()
            prof.export_chrome_trace(os.path.join(
                profiler_dir, f"trace_rank{basics.rank()}.json"))
        except Exception as e:
            # a profiler failure must not lose the Chrome timeline below
            import warnings

            warnings.warn(
                f"torch profiler stop failed ({type(e).__name__}: {e}); "
                "the timeline file is still finished",
                RuntimeWarning, stacklevel=2)
    if tl is not None:
        tl.close()
