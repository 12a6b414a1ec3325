"""Bounded in-process time series over the metrics registry.

A copy of ``horovod_tpu/timeseries.py`` for the PyTorch port (knob
``HVD_TORCH_SAMPLE_S``).  The registry
(:class:`~horovod_tpu_torch.metrics.MetricsRegistry`) and the fleet merge
(:func:`~horovod_tpu_torch.monitor.merge_snapshots`) answer "what is the
value *now*";
nothing in the stack remembers a metric from one moment to the next, so
"is goodput sagging?" or "is p99 TTFT drifting?" needed an offline
bench run.  This module is the memory: a :class:`MetricsSampler` that
is *ticked* by loops the stack already runs (``ServeEngine.step()``
bookkeeping, the router poller — no new threads) and samples the
registry into fixed-size ring-buffer series, Monarch-style (bounded
in-memory series with local aggregation; Adams et al., VLDB 2020):

* **Tiers** — every sample lands in the ``raw`` ring (one point per
  ``sample_s``), and folds into time-aligned ``10s`` and ``60s``
  downsample rings whose bucket timestamps are ``floor(t / step) *
  step`` — aligned buckets are what makes cross-rank merge exact.

* **Counters are stored as rates** — each point carries the increment
  over the sample interval and the derived per-second rate, with the
  delta clamped at zero so a counter that *reset* (a replica respawn)
  yields a zero-rate sample, never a negative one.

* **Histograms are stored as bucket deltas** — each point carries the
  per-bucket count increments for its interval, so any window's
  p50/p90/p99 is recomputed *exactly* (at the fixed bucket resolution)
  by summing deltas and running the very same
  :func:`~horovod_tpu_torch.metrics.percentile_from_buckets` code path the
  live registry and the fleet merge use.

* **Gauges keep last/min/max/mean** per point, so downsampled tiers
  don't hide a spike between samples.

:func:`merge_series` merges per-rank :meth:`MetricsSampler.report`
payloads bucket-for-bucket (rates sum, gauge envelopes combine,
histogram deltas sum) — the series counterpart of
:func:`horovod_tpu_torch.monitor.merge_snapshots`, which calls it when the
snapshots it merges carry a ``timeseries`` section.  A rank missing
from one bucket merges from the ranks that have it (a torn or partial
snapshot degrades coverage, never correctness).

Everything is standard library; only :mod:`horovod_tpu_torch.metrics` and
the tolerant env parsing from :mod:`horovod_tpu_torch.monitor` are imported.
:mod:`horovod_tpu_torch.alerts` evaluates rules over these series and
folds them into capacity advice.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Iterable

from horovod_tpu_torch import metrics as metrics_mod
from horovod_tpu_torch.monitor import env_float

#: Downsample tiers: name -> bucket step in seconds (``None`` = the
#: raw sampling cadence itself).  Order matters: finest first.
TIERS: tuple[tuple[str, float | None], ...] = (
    ("raw", None), ("10s", 10.0), ("60s", 60.0))


def _clamp0(x: float) -> float:
    return x if x > 0 else 0.0


class _Ring:
    """One metric's bounded point ring for one tier."""

    __slots__ = ("kind", "bounds", "points")

    def __init__(self, kind: str, maxlen: int,
                 bounds: list[float] | None = None):
        self.kind = kind                  # "counter" | "gauge" | "histogram"
        self.bounds = bounds              # histogram bucket upper edges
        self.points: collections.deque[dict] = collections.deque(
            maxlen=maxlen)


class _Agg:
    """A tier's in-progress aligned bucket for one metric."""

    __slots__ = ("t", "n", "delta", "dt", "last", "mn", "mx", "total",
                 "count", "sum", "buckets")

    def __init__(self, t: float):
        self.t = t
        self.n = 0
        self.delta = 0.0      # counter increment
        self.dt = 0.0         # counter covered seconds
        self.last = 0.0       # gauge last value
        self.mn = float("inf")
        self.mx = float("-inf")
        self.total = 0.0      # gauge sum (for the mean)
        self.count = 0        # histogram observations
        self.sum = 0.0        # histogram value sum
        self.buckets: list[int] | None = None


class MetricsSampler:
    """Samples a registry into tiered ring-buffer series on ``tick()``.

    ``tick()`` is designed for a hot loop: a clock read and one float
    compare until ``sample_s`` has elapsed, then a single registry
    ``snapshot()`` pass.  It is called by ``ServeEngine.step()`` and by
    ``RouterServer.poll_now()`` — never by a thread of its own.

    ``clock`` defaults to ``time.time`` (wall clock) because the tier
    bucket timestamps must align ACROSS ranks for :func:`merge_series`;
    tests drive a virtual clock through the same parameter.
    """

    _GUARDED_BY_LOCK = ("_series", "_aggs", "_prev_counters",
                        "_prev_hists", "_last_sample")

    def __init__(self,
                 registry: metrics_mod.MetricsRegistry | None = None,
                 *, sample_s: float | None = None,
                 clock: Callable[[], float] | None = None,
                 raw_points: int = 120, mid_points: int = 180,
                 top_points: int = 360):
        self.registry = (registry if registry is not None
                         else metrics_mod.DEFAULT)
        self.sample_s = max(
            sample_s if sample_s is not None
            else env_float("HVD_TORCH_SAMPLE_S", 1.0), 1e-9)
        self.clock = clock if clock is not None else time.time
        self._maxlens = {"raw": raw_points, "10s": mid_points,
                         "60s": top_points}
        self._lock = threading.Lock()
        # tier -> metric name -> ring; tier -> metric name -> open bucket
        self._series: dict[str, dict[str, _Ring]] = {
            name: {} for name, _ in TIERS}
        self._aggs: dict[str, dict[str, _Agg]] = {
            name: {} for name, _ in TIERS if name != "raw"}
        self._prev_counters: dict[str, tuple[float, float]] = {}
        self._prev_hists: dict[str, dict] = {}
        self._last_sample = float("-inf")
        # Registered up front, so snapshots are schema-stable.
        self._samples = self.registry.counter("ts.samples")
        self._n_series = self.registry.gauge("ts.series")

    # -- ingestion ---------------------------------------------------------

    def tick(self, now: float | None = None) -> bool:
        """Sample the registry if ``sample_s`` has elapsed; returns
        whether a sample was taken.  Cheap when it wasn't."""
        now = self.clock() if now is None else now
        if now - self._last_sample < self.sample_s:
            return False
        # Snapshot OUTSIDE our lock (it takes the registry's).
        snap = self.registry.snapshot()
        return self.ingest(now, snap)

    def ingest(self, now: float, snap: dict) -> bool:
        """Fold one registry ``snapshot()`` dict into the series.  The
        public seam ``tick()`` uses — tests (and replayers) feed
        synthetic or degraded snapshots here directly.  Tolerant of
        partial snapshots: missing sections or malformed histogram
        entries are skipped, never fatal."""
        if not isinstance(snap, dict):
            return False
        with self._lock:
            if now - self._last_sample < self.sample_s:
                return False
            self._last_sample = now
            self._ingest_locked(now, snap)
        self._samples.inc()
        return True

    def _ingest_locked(self, now: float, snap: dict) -> None:
        counters = snap.get("counters") or {}
        gauges = snap.get("gauges") or {}
        hists = snap.get("histograms") or {}
        for name, v in counters.items():
            if not isinstance(v, (int, float)):
                continue
            prev = self._prev_counters.get(name)
            self._prev_counters[name] = (now, float(v))
            if prev is None:
                continue                      # no rate from one sample
            t0, v0 = prev
            dt = now - t0
            if dt <= 0:
                continue
            delta = _clamp0(float(v) - v0)    # reset clamps at 0
            self._point(name, "counter", now,
                        {"t": now, "rate": delta / dt,
                         "delta": delta, "dt": dt})
        for name, v in gauges.items():
            if not isinstance(v, (int, float)):
                continue
            v = float(v)
            self._point(name, "gauge", now,
                        {"t": now, "last": v, "min": v, "max": v,
                         "mean": v, "n": 1})
        for name, h in hists.items():
            if not isinstance(h, dict) or "buckets" not in h:
                continue                      # torn/partial snapshot
            buckets = h.get("buckets")
            bounds = h.get("bounds")
            if not isinstance(buckets, list) or not isinstance(
                    bounds, list):
                continue
            prev = self._prev_hists.get(name)
            self._prev_hists[name] = {
                "count": h.get("count", 0), "sum": h.get("sum", 0.0),
                "buckets": list(buckets), "bounds": list(bounds)}
            if prev is None or prev["bounds"] != list(bounds):
                continue
            db = [max(int(b) - int(a), 0)
                  for a, b in zip(prev["buckets"], buckets)]
            self._point(name, "histogram", now,
                        {"t": now,
                         "count": _clamp0(h.get("count", 0)
                                          - prev["count"]),
                         "sum": _clamp0(h.get("sum", 0.0)
                                        - prev["sum"]),
                         "buckets": db},
                        bounds=list(bounds))
        n = sum(len(tier) for tier in self._series.values())
        self._n_series.set(n)

    def _ring(self, tier: str, name: str, kind: str,
              bounds: list[float] | None) -> _Ring:
        ring = self._series[tier].get(name)
        if ring is None:
            ring = self._series[tier][name] = _Ring(
                kind, self._maxlens[tier], bounds)
        return ring

    def _point(self, name: str, kind: str, now: float, pt: dict,
               bounds: list[float] | None = None) -> None:
        self._ring("raw", name, kind, bounds).points.append(pt)
        for tier, step in TIERS:
            if step is None:
                continue
            bucket_t = (now // step) * step
            agg = self._aggs[tier].get(name)
            if agg is not None and bucket_t > agg.t:
                self._flush_agg(tier, name, kind, agg, bounds)
                agg = None
            if agg is None:
                agg = self._aggs[tier][name] = _Agg(bucket_t)
            agg.n += 1
            if kind == "counter":
                agg.delta += pt["delta"]
                agg.dt += pt["dt"]
            elif kind == "gauge":
                agg.last = pt["last"]
                agg.mn = min(agg.mn, pt["min"])
                agg.mx = max(agg.mx, pt["max"])
                agg.total += pt["mean"]
            else:
                agg.count += pt["count"]
                agg.sum += pt["sum"]
                if agg.buckets is None:
                    agg.buckets = list(pt["buckets"])
                else:
                    agg.buckets = [a + b for a, b in
                                   zip(agg.buckets, pt["buckets"])]

    def _flush_agg(self, tier: str, name: str, kind: str, agg: _Agg,
                   bounds: list[float] | None) -> None:
        if kind == "counter":
            pt = {"t": agg.t, "rate": (agg.delta / agg.dt
                                       if agg.dt > 0 else 0.0),
                  "delta": agg.delta, "dt": agg.dt}
        elif kind == "gauge":
            pt = {"t": agg.t, "last": agg.last, "min": agg.mn,
                  "max": agg.mx, "mean": agg.total / max(agg.n, 1),
                  "n": agg.n}
        else:
            pt = {"t": agg.t, "count": agg.count, "sum": agg.sum,
                  "buckets": agg.buckets or []}
        self._ring(tier, name, kind, bounds).points.append(pt)

    # -- queries -----------------------------------------------------------

    def window(self, name: str, window_s: float, *,
               now: float | None = None,
               end_offset_s: float = 0.0) -> list[dict]:
        """Points for ``name`` in ``[now - end_offset_s - window_s,
        now - end_offset_s]``, from the finest tier whose ring still
        reaches back to the window start; when no tier reaches that
        far, the one reaching furthest back.  Coverage is judged from
        the stored points, not ``sample_s`` — a sampler ticked slower
        than its nominal cadence (e.g. once per engine step) holds far
        more wall time in its raw ring than ``raw_points * sample_s``.
        Empty list when the metric was never sampled."""
        now = self.clock() if now is None else now
        hi = now - end_offset_s
        lo = hi - window_s
        with self._lock:
            chosen = None
            for tier, _ in TIERS:
                ring = self._series[tier].get(name)
                if ring is None or not ring.points:
                    continue
                # A ring that never evicted holds the series' complete
                # history — it reaches as far back as any tier can.
                if (ring.points[0]["t"] <= lo
                        or len(ring.points) < ring.points.maxlen):
                    chosen = ring
                    break
                if chosen is None or \
                        ring.points[0]["t"] < chosen.points[0]["t"]:
                    chosen = ring
            if chosen is None:
                return []
            return [p for p in chosen.points if lo <= p["t"] <= hi]

    def gauge_stats(self, name: str, window_s: float, *,
                    now: float | None = None) -> dict:
        """``{n, mean, min, max, last}`` of a gauge over the window."""
        pts = self.window(name, window_s, now=now)
        pts = [p for p in pts if "mean" in p]
        if not pts:
            return {"n": 0, "mean": 0.0, "min": 0.0, "max": 0.0,
                    "last": 0.0}
        return {
            "n": len(pts),
            "mean": sum(p["mean"] for p in pts) / len(pts),
            "min": min(p["min"] for p in pts),
            "max": max(p["max"] for p in pts),
            "last": pts[-1]["last"],
        }

    def counter_rate(self, name: str, window_s: float, *,
                     now: float | None = None) -> dict:
        """``{n, rate, delta}`` of a counter over the window — ``rate``
        is total increment over covered seconds (never negative)."""
        pts = [p for p in self.window(name, window_s, now=now)
               if "delta" in p]
        delta = sum(p["delta"] for p in pts)
        dt = sum(p["dt"] for p in pts)
        return {"n": len(pts), "delta": delta,
                "rate": delta / dt if dt > 0 else 0.0}

    def hist_window(self, name: str, window_s: float, *,
                    now: float | None = None,
                    end_offset_s: float = 0.0) -> dict | None:
        """Summed bucket deltas over the window, in the mergeable
        histogram-snapshot shape, or None without data."""
        pts = [p for p in self.window(name, window_s, now=now,
                                      end_offset_s=end_offset_s)
               if "buckets" in p]
        if not pts:
            return None
        with self._lock:
            ring = (self._series["raw"].get(name)
                    or self._series["10s"].get(name))
            bounds = ring.bounds if ring is not None else None
        if bounds is None:
            return None
        buckets = [0] * len(pts[0]["buckets"])
        for p in pts:
            buckets = [a + b for a, b in zip(buckets, p["buckets"])]
        return {"count": int(sum(p["count"] for p in pts)),
                "sum": sum(p["sum"] for p in pts),
                "buckets": buckets, "bounds": list(bounds)}

    def hist_percentile(self, name: str, window_s: float, q: float, *,
                        now: float | None = None,
                        end_offset_s: float = 0.0) -> float | None:
        """The ``q``-quantile of a histogram over the window, exact at
        bucket resolution via ``percentile_from_buckets`` (the same
        path the live registry and the fleet merge use); None without
        data in the window."""
        h = self.hist_window(name, window_s, now=now,
                             end_offset_s=end_offset_s)
        if h is None or h["count"] == 0:
            return None
        mn, mx = _bucket_envelope(h["bounds"], h["buckets"])
        return metrics_mod.percentile_from_buckets(
            h["bounds"], h["buckets"], h["count"], mn, mx, q)

    def slope_per_s(self, name: str, window_s: float, *,
                    now: float | None = None) -> float | None:
        """Least-squares slope (value/sec) of a gauge over the window;
        None with fewer than 3 points."""
        pts = [p for p in self.window(name, window_s, now=now)
               if "mean" in p]
        if len(pts) < 3:
            return None
        n = len(pts)
        t0 = pts[0]["t"]
        xs = [p["t"] - t0 for p in pts]
        ys = [p["mean"] for p in pts]
        mx = sum(xs) / n
        my = sum(ys) / n
        den = sum((x - mx) ** 2 for x in xs)
        if den <= 0:
            return None
        return sum((x - mx) * (y - my)
                   for x, y in zip(xs, ys)) / den

    # -- export ------------------------------------------------------------

    def report(self, *, points: int | None = None) -> dict:
        """JSON-serializable series dump (the ``/timeseries`` payload
        and the ``timeseries`` section of ``metrics_snapshot()``).
        ``points`` bounds how many trailing points each series carries
        (None = everything in the rings)."""
        with self._lock:
            tiers: dict[str, Any] = {}
            for tier, step in TIERS:
                series = {}
                for name, ring in sorted(self._series[tier].items()):
                    pts = list(ring.points)
                    if points is not None:
                        pts = pts[-points:]
                    entry: dict[str, Any] = {"kind": ring.kind,
                                             "points": pts}
                    if ring.bounds is not None:
                        entry["bounds"] = list(ring.bounds)
                    series[name] = entry
                tiers[tier] = {
                    "step_s": step if step is not None else self.sample_s,
                    "series": series}
            return {"sample_s": self.sample_s,
                    "now": self._last_sample,
                    "tiers": tiers}


def _bucket_envelope(bounds: list[float],
                     buckets: list[int]) -> tuple[float, float]:
    """(min, max) clamp envelope implied by nonzero buckets — windowed
    deltas don't carry observed min/max, so the quantile clamps to the
    resolved buckets' edges instead."""
    lo_i = next((i for i, c in enumerate(buckets) if c), None)
    hi_i = next((i for i in range(len(buckets) - 1, -1, -1)
                 if buckets[i]), None)
    if lo_i is None or hi_i is None:
        return 0.0, 0.0
    mn = bounds[lo_i - 1] if lo_i > 0 else 0.0
    mx = bounds[hi_i] if hi_i < len(bounds) else bounds[-1]
    return mn, mx


def merge_series(reports: Iterable[dict],
                 ranks: Iterable[int] | None = None) -> dict:
    """Merge per-rank :meth:`MetricsSampler.report` payloads into one
    fleet view, bucket-for-bucket on the time-aligned tiers.

    Counter rates/deltas SUM; gauge envelopes combine (min of mins,
    max of maxes, mean of means, last = any rank's last); histogram
    bucket deltas SUM with windowed percentiles recomputable downstream
    via :func:`~horovod_tpu_torch.metrics.percentile_from_buckets`.  A rank
    missing a bucket (torn snapshot, dead rank) merges from the ranks
    that have it — degraded coverage, not an error."""
    reports = [r for r in reports if isinstance(r, dict)
               and "tiers" in r]
    rank_ids = (list(ranks) if ranks is not None
                else list(range(len(reports))))
    out_tiers: dict[str, Any] = {}
    for tier, step in TIERS:
        step_s = step
        if step_s is None:
            step_s = max((r.get("sample_s", 1.0) for r in reports),
                         default=1.0)
        merged: dict[str, dict] = {}
        for r in reports:
            series = (r.get("tiers", {}).get(tier, {})
                      .get("series", {}))
            if not isinstance(series, dict):
                continue
            for name, entry in series.items():
                kind = entry.get("kind")
                dst = merged.setdefault(
                    name, {"kind": kind, "bounds": entry.get("bounds"),
                           "buckets_by_t": {}})
                for pt in entry.get("points", ()):
                    if "t" not in pt:
                        continue
                    key = (pt["t"] // step_s) * step_s
                    cell = dst["buckets_by_t"].get(key)
                    if cell is None:
                        dst["buckets_by_t"][key] = dict(pt, t=key,
                                                        ranks=1)
                        continue
                    cell["ranks"] += 1
                    if kind == "counter":
                        cell["rate"] += pt.get("rate", 0.0)
                        cell["delta"] += pt.get("delta", 0.0)
                        cell["dt"] = max(cell.get("dt", 0.0),
                                         pt.get("dt", 0.0))
                    elif kind == "gauge":
                        cell["min"] = min(cell["min"], pt["min"])
                        cell["max"] = max(cell["max"], pt["max"])
                        n0, n1 = cell.get("n", 1), pt.get("n", 1)
                        cell["mean"] = ((cell["mean"] * n0
                                         + pt["mean"] * n1)
                                        / max(n0 + n1, 1))
                        cell["n"] = n0 + n1
                        cell["last"] = pt["last"]
                    elif "buckets" in pt and "buckets" in cell:
                        cell["count"] += pt.get("count", 0)
                        cell["sum"] += pt.get("sum", 0.0)
                        cell["buckets"] = [
                            a + b for a, b in zip(cell["buckets"],
                                                  pt["buckets"])]
        series_out = {}
        for name, dst in sorted(merged.items()):
            pts = [dst["buckets_by_t"][t]
                   for t in sorted(dst["buckets_by_t"])]
            entry = {"kind": dst["kind"], "points": pts}
            if dst.get("bounds") is not None:
                entry["bounds"] = dst["bounds"]
            series_out[name] = entry
        out_tiers[tier] = {"step_s": step_s, "series": series_out}
    return {"ranks": [int(r) for r in rank_ids[:len(reports)]],
            "tiers": out_tiers}


def maybe_sampler(registry: metrics_mod.MetricsRegistry | None = None,
                  ) -> MetricsSampler | None:
    """A sampler per the env contract: ``HVD_TORCH_SAMPLE_S`` (default
    1.0) is the cadence, ``<= 0`` disables.  A
    :class:`~horovod_tpu_torch.metrics.NullRegistry` gets no sampler —
    there's nothing to remember (and the bench's null arm must not pay
    for one)."""
    if isinstance(registry, metrics_mod.NullRegistry):
        return None
    sample_s = env_float("HVD_TORCH_SAMPLE_S", 1.0)
    if sample_s <= 0:
        return None
    return MetricsSampler(registry, sample_s=sample_s)
