"""The traced segment of a run, reduced to plain data the readers take.

:func:`summarize` turns a ``torch.profiler`` profile into a JSON-able dict
(times in microseconds of the profiler's clock):

``window``      [start, end] of the ``portbench.window`` range that the
                runner opens around the traced steps and their final
                synchronise;
``kernels``     [start, end, name index] of every device operation
                (kernels, copies, sets), user annotations and the
                profiler's own overhead records left out;
``names``       the names the indices point to;
``ranges``      for each range name asked for, the device time of each
                outermost occurrence: the kernels that ran on behalf of
                the range's host operations and their children (the
                profiler links a kernel to the innermost operation that
                was open when it was launched);
``device_ops``  the ten device operations that took most time;
``idle_gaps``   the longest idle gaps of the device, by the innermost
                host operation open at each gap's midpoint.

The pure functions below are the arithmetic the readers share.
"""

from __future__ import annotations

import bisect

WINDOW_RANGE = "portbench.window"
# Records the profiler (CUPTI) files as device events that are its own
# overhead, not work on the card: a full launch queue, its buffers.
OVERHEAD = ("Command Buffer Full", "Activity Buffer Request", "Buffer Flush",
            "Instrumentation", "Resource", "Driver Compiler",
            "Runtime Triggered Module Loading", "Lazy Function Loading",
            "UVM DMA Fault", "Unknown")
# Idle gaps named by the host's operation: the longest this many.
NAMED_GAPS = 400


def union(intervals) -> list[tuple[float, float]]:
    """Sorted, merged [start, end] intervals."""
    out: list[list[float]] = []
    for a, b in sorted((a, b) for a, b in intervals if b > a):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def length(intervals) -> float:
    return sum(b - a for a, b in union(intervals))


def gaps(busy, start: float, end: float) -> list[tuple[float, float]]:
    """The idle intervals of [start, end] outside ``busy`` (merged)."""
    out, t = [], start
    for a, b in busy:
        if a > t:
            out.append((t, min(a, end)))
        t = max(t, b)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(a, b) for a, b in out if b > a]


def clipped(summary: dict, pick=lambda name: True):
    """The kernels whose name ``pick`` accepts, as intervals clipped to
    the window."""
    a, b = summary["window"]
    names = summary["names"]
    return [(max(s, a), min(e, b)) for s, e, i in summary["kernels"]
            if pick(names[i]) and e > a and s < b]


def busy_us(summary: dict) -> float:
    """Time in the window in which some operation ran on the device."""
    return length(clipped(summary))


def window_us(summary: dict) -> float:
    a, b = summary["window"]
    return b - a


def _device_us(event) -> float:
    """Device time of the kernels linked to ``event`` and its children.
    The profiler links a kernel to every host event that carries its
    operation's id, and its own records (a full launch queue) inside an
    operation carry that id too: each id is counted once."""
    seen, total, stack = set(), 0.0, [event]
    while stack:
        e = stack.pop()
        stack.extend(e.cpu_children)
        if e.id in seen:
            continue
        seen.add(e.id)
        total += sum(k.duration for k in e.kernels if k.name not in OVERHEAD)
    return total


def _has_named_ancestor(event, name: str) -> bool:
    p = event.cpu_parent
    while p is not None:
        if p.name == name:
            return True
        p = p.cpu_parent
    return False


def _name_gaps(idle, host) -> list[list]:
    """Aggregate the longest idle gaps by the innermost host operation
    (latest start) open at each gap's midpoint."""
    host.sort(key=lambda e: e[0])
    starts = [e[0] for e in host]
    by_name: dict[str, float] = {}
    for a, b in sorted(idle, key=lambda g: g[0] - g[1])[:NAMED_GAPS]:
        mid = (a + b) / 2
        name = "no host operation open"
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if host[i][1] >= mid:
                name = host[i][2]
                break
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    return sorted(([n, s] for n, s in by_name.items()),
                  key=lambda x: -x[1])[:10]


def summarize(prof, range_names=()) -> dict:
    """Reduce ``prof`` (a finished ``torch.profiler.profile``) to plain
    data; see the module's docstring."""
    from torch.autograd import DeviceType

    events = prof.events()
    names: dict[str, int] = {}
    kernels, host = [], []
    window = None
    wanted = set(range_names)
    ranges: dict[str, list[float]] = {n: [] for n in wanted}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if not (getattr(e, "is_user_annotation", False)
                    or e.name in OVERHEAD):
                idx = names.setdefault(e.name, len(names))
                kernels.append([e.time_range.start, e.time_range.end, idx])
            continue
        if e.device_type != DeviceType.CPU or e.is_async:
            continue
        if e.name == WINDOW_RANGE:
            window = [e.time_range.start, e.time_range.end]
            continue
        host.append((e.time_range.start, e.time_range.end, e.name))
        if e.name in wanted and not _has_named_ancestor(e, e.name):
            ranges[e.name].append(_device_us(e))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_RANGE!r} range")
    order = sorted(names, key=names.get)
    by_op: dict[str, float] = {}
    for a, b, i in kernels:
        by_op[order[i]] = by_op.get(order[i], 0.0) + (b - a) / 1e6
    busy = union((max(k[0], window[0]), min(k[1], window[1]))
                 for k in kernels)
    return {
        "window": window,
        "kernels": kernels,
        "names": order,
        "ranges": ranges,
        "device_ops": sorted(([n[:160], s] for n, s in by_op.items()),
                             key=lambda x: -x[1])[:10],
        "idle_gaps": _name_gaps(gaps(busy, *window), host),
    }
