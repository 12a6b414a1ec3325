"""Causal distributed tracing: span trees across the serving fleet.

A copy of ``horovod_tpu/tracing.py`` for the PyTorch port, which may not
import the JAX package; its knobs are ``HVD_TORCH_TRACE_SAMPLE`` and
``HVD_TORCH_TRACE_SEED``.  For the same keys and seed it derives the same
sampling decisions, trace ids and span ids as the reference, so spans of
the two engines can be compared one for one.  The fleet hops named below
(router, ``HttpReplica``, loadgen) are the reference's; the port's
``ServeEngine`` joins the plane at submit.

The profiler tiles *aggregate* tick time and ``metrics.Trace`` stamps
flat per-request timestamps, but neither can answer the Dapper-style
question: for THIS slow request, which causal chain of spans — router
admission, failover hops, replica queue, prefill chunks, decode —
actually bounded its latency?  This module is that plane:

* :class:`TraceContext` — a ``(trace_id, span_id)`` pair propagated end
  to end: loadgen client → router HTTP front door (a W3C
  ``traceparent``-style header or a ``trace`` JSON field) →
  ``HttpReplica`` hops → the replica pump →
  ``ServeEngine``.  Child span ids are *derived* (a keyed hash of
  ``trace_id || parent || name || seq``), never drawn from entropy, so
  replaying the same request produces the same tree bit-for-bit.
* **Deterministic head sampling** — :func:`sampled` hashes a seeded key
  (the request id) into [0, 1) and compares against
  ``HVD_TORCH_TRACE_SAMPLE``.  No wall clock, no unseeded entropy: the
  decision is a pure function of ``(seed, key)``, so replays and
  simulated campaigns stay bit-deterministic with tracing enabled.
* :class:`Tracer` — emits ``trace.span`` / ``trace.span_open`` records
  through a :class:`~horovod_tpu_torch.metrics.MetricsRegistry` event sink
  (landing in the rank-stamped, torn-line-tolerant EventLog) and keeps
  a bounded in-memory ring of recent closed spans for the monitor's
  live ``/traces`` endpoint.
* **Reconstruction** — :func:`build_forest` folds span records (event
  log replay or live scrape) into per-trace trees, degrading to
  *labeled* partial trees on damage: an orphaned child (parent record
  torn away) becomes an ``orphan`` root, a ``span_open`` with no close
  (crash) renders ``unclosed``; it never throws on torn input.
* **Critical path** — :func:`critical_path` walks one tree charging
  every instant of the root interval to the deepest span covering it
  (gaps between children are parent self-time), so the entries tile
  the root duration *exactly*; :func:`aggregate_critical_paths` folds
  many trees into a fleet-level "where does p99 time go" breakdown.

Timestamps on spans are ``time.monotonic`` seconds (the same clock the
engine's ``Trace`` stamps and — on Linux — the profiler's
``perf_counter`` intervals use), comparable within one process.  Spans
from different processes share the trace/span *ids* but not a clock
base; reconstruction clips children into their parent's interval so
cross-process trees stay renderable.
"""

from __future__ import annotations

import collections
import hashlib
import os
import threading
from typing import Any, Iterable

__all__ = [
    "SPAN_KIND", "SPAN_OPEN_KIND", "TraceContext", "Tracer",
    "sampled", "trace_id_for", "child_span_id", "env_sample_fraction",
    "env_trace_seed", "build_forest", "critical_path",
    "aggregate_critical_paths",
]

#: Event-log record kinds spans persist under.
SPAN_KIND = "trace.span"
SPAN_OPEN_KIND = "trace.span_open"

_TWO64 = float(2 ** 64)


def _hash64(payload: str) -> int:
    """64-bit keyed hash used for both sampling and id derivation —
    blake2b, never ``hash()`` (PYTHONHASHSEED would break replay)."""
    return int.from_bytes(
        hashlib.blake2b(payload.encode(), digest_size=8).digest(), "big")


def env_sample_fraction() -> float:
    """``HVD_TORCH_TRACE_SAMPLE`` as a fraction in [0, 1] (0 = off)."""
    raw = os.environ.get("HVD_TORCH_TRACE_SAMPLE", "")
    try:
        f = float(raw) if raw else 0.0
    except ValueError:
        return 0.0
    return min(max(f, 0.0), 1.0)


def env_trace_seed() -> int:
    """``HVD_TORCH_TRACE_SEED`` — the sampling/id-derivation seed."""
    raw = os.environ.get("HVD_TORCH_TRACE_SEED", "")
    try:
        return int(raw) if raw else 0
    except ValueError:
        return 0


def sampled(key: Any, fraction: float, seed: int = 0) -> bool:
    """Deterministic head-sampling decision: a pure function of
    ``(seed, key)`` — the same request id samples identically on every
    run, every rank, and every journal replay."""
    if fraction <= 0.0:
        return False
    if fraction >= 1.0:
        return True
    return _hash64(f"{seed}:{key}") / _TWO64 < fraction


def trace_id_for(key: Any, seed: int = 0) -> str:
    """The 32-hex trace id a root keyed on ``key`` gets (derived, so a
    journal replay of the same request rejoins the same trace)."""
    return hashlib.blake2b(f"{seed}:{key}".encode(),
                           digest_size=16).hexdigest()


def child_span_id(trace_id: str, parent_id: str, name: str,
                  seq: int = 0) -> str:
    """16-hex span id derived from the causal position — no entropy, so
    re-deriving the same child (e.g. on a replay) collides on purpose
    and the forest dedupes it into one node."""
    return hashlib.blake2b(f"{trace_id}|{parent_id}|{name}|{seq}".encode(),
                           digest_size=8).hexdigest()


class TraceContext:
    """The propagated pair: which trace, and which span is the current
    causal parent.  Only *sampled* requests carry a context at all —
    unsampled is ``None`` everywhere, so the disabled plane costs one
    attribute test per hop."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"TraceContext({self.trace_id}, {self.span_id})"

    def __eq__(self, other: Any) -> bool:
        return (isinstance(other, TraceContext)
                and other.trace_id == self.trace_id
                and other.span_id == self.span_id)

    def child(self, name: str, seq: int = 0) -> "TraceContext":
        """Context whose span is a derived child of this one."""
        return TraceContext(
            self.trace_id,
            child_span_id(self.trace_id, self.span_id, name, seq))

    # -- wire formats -------------------------------------------------------

    def to_header(self) -> str:
        """W3C ``traceparent``-style header value (flags always 01 —
        an unsampled request has no context to serialize)."""
        return f"00-{self.trace_id}-{self.span_id}-01"

    @classmethod
    def from_header(cls, value: str | None) -> "TraceContext | None":
        """Parse a ``traceparent`` header; malformed or flag-00
        (unsampled) values degrade to ``None``, never raise."""
        if not value or not isinstance(value, str):
            return None
        parts = value.strip().split("-")
        if len(parts) != 4:
            return None
        _ver, tid, sid, flags = parts
        if len(tid) != 32 or len(sid) != 16:
            return None
        try:
            int(tid, 16), int(sid, 16)
        except ValueError:
            return None
        if flags == "00":
            return None
        return cls(tid, sid)

    def to_dict(self) -> dict:
        """The JSON wire field (rides ``request_to_json`` so
        ``HttpReplica`` hops forward it for free)."""
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    @classmethod
    def from_dict(cls, d: Any) -> "TraceContext | None":
        if not isinstance(d, dict):
            return None
        tid, sid = d.get("trace_id"), d.get("span_id")
        if not (isinstance(tid, str) and isinstance(sid, str)
                and len(tid) == 32 and len(sid) == 16):
            return None
        return cls(tid, sid)

    # -- roots --------------------------------------------------------------

    @classmethod
    def root(cls, key: Any, name: str = "request",
             fraction: float | None = None,
             seed: int | None = None) -> "TraceContext | None":
        """Head-sampled root context for a new request keyed on ``key``
        (``None`` when the sampler says no)."""
        if fraction is None:
            fraction = env_sample_fraction()
        if seed is None:
            seed = env_trace_seed()
        if not sampled(key, fraction, seed):
            return None
        tid = trace_id_for(key, seed)
        return cls(tid, child_span_id(tid, "", name))


def count_sampled(metrics: Any) -> None:
    """Bump the root-sampling counter (every plane that mints a root calls
    through here)."""
    metrics.counter("trace.sampled").inc()


class Tracer:
    """Span emitter: persists ``trace.span`` records through a registry
    event sink (→ EventLog when one is attached) and keeps a bounded
    ring of recent closed spans for live scrapes.

    Emission is post-hoc — callers pass monotonic ``t0``/``t1`` stamps
    they already took (router tickets, engine ``Trace`` fields), so the
    tracer adds no clock reads to hot paths and virtual-clock drivers
    (simfleet) stamp spans off their injected clock."""

    _GUARDED_BY_LOCK = ("_ring",)

    def __init__(self, metrics: Any, ring: int = 1024):
        self.metrics = metrics
        self._lock = threading.Lock()
        self._ring: collections.deque[dict] = collections.deque(
            maxlen=ring)
        self._c_spans = metrics.counter("trace.spans")

    def span_open(self, ctx: TraceContext, name: str, t0: float,
                  parent_id: str | None = None, **attrs: Any) -> None:
        """Durable evidence a span STARTED — a crash before the close
        record leaves an ``unclosed`` node in the forest instead of
        nothing."""
        self.metrics.event(
            SPAN_OPEN_KIND, trace_id=ctx.trace_id, span_id=ctx.span_id,
            parent_id=parent_id, name=name, t0=t0, attrs=attrs)

    def span(self, ctx: TraceContext, name: str, t0: float, t1: float,
             parent_id: str | None = None, **attrs: Any) -> None:
        """Emit one closed span ``[t0, t1]`` (monotonic seconds)."""
        rec = {"trace_id": ctx.trace_id, "span_id": ctx.span_id,
               "parent_id": parent_id, "name": name,
               "t0": t0, "t1": t1, "attrs": attrs}
        self._c_spans.inc()
        self.metrics.event(SPAN_KIND, **rec)
        with self._lock:
            self._ring.append(dict(rec, kind=SPAN_KIND))

    def recent(self) -> list[dict]:
        """Recent closed spans, oldest first (the ``/traces`` payload)."""
        with self._lock:
            return list(self._ring)


# ---------------------------------------------------------------------------
# Reconstruction: records -> forest -> critical path.
# ---------------------------------------------------------------------------


def build_forest(records: Iterable[dict]) -> dict[str, list[dict]]:
    """Fold span records into ``{trace_id: [root nodes]}``.

    Accepts the raw event-log record stream (non-span kinds are
    skipped) or a ``/traces`` scrape.  Damage degrades, never throws:

    * a close record supersedes its ``span_open`` (same span id);
      duplicate closes (journal-replay re-derivation) keep the last;
    * a ``span_open`` with no close becomes an ``unclosed`` node whose
      ``t1`` is ``None``;
    * a child whose parent record is missing (torn away, unsampled
      ancestor, foreign incarnation) is promoted to an ``orphan`` root
      of the same trace — the tree renders partial, labeled.

    Node schema: ``trace_id, span_id, parent_id, name, t0, t1, attrs,
    unclosed, orphan, children`` (children sorted by ``t0``).
    """
    nodes: dict[tuple[str, str], dict] = {}
    for rec in records:
        if not isinstance(rec, dict):
            continue
        kind = rec.get("kind")
        if kind not in (SPAN_KIND, SPAN_OPEN_KIND):
            continue
        tid, sid = rec.get("trace_id"), rec.get("span_id")
        if not (isinstance(tid, str) and isinstance(sid, str)):
            continue
        t0 = rec.get("t0")
        if not isinstance(t0, (int, float)):
            continue
        t1 = rec.get("t1")
        closed = kind == SPAN_KIND and isinstance(t1, (int, float))
        prior = nodes.get((tid, sid))
        if prior is not None and not closed and not prior["unclosed"]:
            continue                    # an open never beats a close
        attrs = rec.get("attrs")
        nodes[(tid, sid)] = {
            "trace_id": tid,
            "span_id": sid,
            "parent_id": rec.get("parent_id"),
            "name": str(rec.get("name", "?")),
            "t0": float(t0),
            "t1": float(t1) if closed else None,
            "attrs": attrs if isinstance(attrs, dict) else {},
            "unclosed": not closed,
            "orphan": False,
            "children": [],
        }
    forest: dict[str, list[dict]] = {}
    for (tid, sid), node in sorted(nodes.items(),
                                   key=lambda kv: (kv[0][0],
                                                   kv[1]["t0"])):
        pid = node["parent_id"]
        parent = nodes.get((tid, pid)) if isinstance(pid, str) else None
        if parent is None or parent is node:
            node["orphan"] = parent is None and pid is not None
            forest.setdefault(tid, []).append(node)
        else:
            parent["children"].append(node)
    for roots in forest.values():
        for root in roots:
            stack = [root]
            while stack:
                n = stack.pop()
                n["children"].sort(key=lambda c: c["t0"])
                stack.extend(n["children"])
    return forest


def span_end(node: dict) -> float:
    """A node's effective end: its close stamp, or (unclosed) the
    latest end among descendants, or its own start."""
    best = node["t1"] if node["t1"] is not None else node["t0"]
    for ch in node["children"]:
        best = max(best, span_end(ch))
    return best


def critical_path(root: dict) -> list[dict]:
    """The blocking chain: every instant of the root interval charged
    to the deepest span covering it, so the entries' ``self_s`` sum to
    the root duration EXACTLY (gaps between children are parent
    self-time).  Children are clipped into their parent's interval —
    cross-process clock skew and torn ``t1``s degrade to clipped
    charges, never negative time or a throw.

    Returns ``[{name, span_id, t0, self_s}, ...]`` in time order.
    """
    entries: list[dict] = []

    def _charge(node: dict, lo: float, t: float) -> None:
        if t > lo:
            entries.append({"name": node["name"],
                            "span_id": node["span_id"],
                            "t0": lo, "self_s": t - lo})

    def _walk(node: dict, lo: float, hi: float) -> None:
        cur = lo
        for ch in node["children"]:
            c1 = span_end(ch) if ch["t1"] is None else ch["t1"]
            c0 = min(max(ch["t0"], cur), hi)
            c1 = min(max(c1, c0), hi)
            if c1 <= c0:
                continue
            _charge(node, cur, c0)
            _walk(ch, c0, c1)
            cur = c1
        _charge(node, cur, hi)

    hi = span_end(root)
    _walk(root, root["t0"], hi)
    return entries


def aggregate_critical_paths(roots: Iterable[dict]) -> dict:
    """Fleet-level breakdown: fold many trees' critical paths into
    per-span-name totals and shares — the "p99 requests spend 61% in
    replica_queue" view."""
    by_name: dict[str, dict] = {}
    total = 0.0
    n = 0
    for root in roots:
        n += 1
        for ent in critical_path(root):
            slot = by_name.setdefault(
                ent["name"], {"total_s": 0.0, "count": 0})
            slot["total_s"] += ent["self_s"]
            slot["count"] += 1
            total += ent["self_s"]
    for slot in by_name.values():
        slot["share"] = slot["total_s"] / total if total else 0.0
    return {"n_traces": n, "total_s": total,
            "by_name": dict(sorted(by_name.items(),
                                   key=lambda kv: -kv[1]["total_s"]))}
