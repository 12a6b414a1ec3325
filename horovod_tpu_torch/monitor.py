"""Cross-rank observability: live exporter, exact distributed metric
merge, straggler detection, and SLO goodput windows.

A copy of ``horovod_tpu/monitor.py`` for the PyTorch port, which may not
import the JAX package.  Four pillars:

* :class:`MonitorServer` / :func:`maybe_start_monitor` — a stdlib-only
  HTTP exporter (one daemon thread per rank, ``ThreadingHTTPServer``)
  serving ``/metrics`` (Prometheus 0.0.4 text), ``/snapshot`` (the
  engine's ``metrics_snapshot()``), ``/healthz`` (liveness + last-step
  age; 503 once the engine's no-progress watchdog would fire),
  ``/state`` (``state_dump()``), ``/profile``, ``/device``,
  ``/timeseries``, ``/alerts``, ``/advice`` and ``/traces``.  Enabled
  per rank by ``HVD_TORCH_MONITOR_PORT`` (the rank offsets the port) or
  by ``ServeEngine(monitor=...)``.  The port's engine keeps its torch
  device at ``engine.device`` and its telemetry plane at
  ``engine.device_telemetry``, which ``/device`` reads.

* :func:`merge_snapshots` / :func:`aggregate_snapshots` — exact
  distributed merge: counters sum, gauges keep per-rank values plus
  min/max/mean, histograms sum their fixed log-bucket counts and
  recompute p50/p90/p99 through
  :func:`~horovod_tpu_torch.metrics.percentile_from_buckets`, so the
  fleet view equals one histogram fed the union of observations.
  :func:`aggregate_snapshots` gathers every rank's snapshot with the
  port's ``allgather_object``.

* :class:`StragglerDetector` — rolling per-rank step times;
  ``check()`` allgathers the reports, publishes ``hvd.step_skew_s``
  (slowest minus median rank) and emits ``monitor.straggler`` past
  ``warn_s`` seconds (``HVD_TORCH_STRAGGLER_WARN_S``).

* :class:`SLOWindow` — the ring of terminal request traces behind
  ``serve.goodput`` and ``ServeEngine.slo_report()``.

Only :mod:`horovod_tpu_torch.metrics` is imported at module level; the
collective plane is imported inside the functions that gather, so this
module imports before ``init()``.
"""

from __future__ import annotations

import collections
import json
import os
import statistics
import threading
import time
import warnings
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Iterable

from horovod_tpu_torch import metrics as metrics_mod


def env_float(name: str, default: float) -> float:
    """Tolerant float env parsing (the ``_negotiate_timeout_s`` idiom):
    an unparsable value warns and falls back instead of crashing a job
    at import time."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        warnings.warn(f"{name}={raw!r} is not a float; using {default}",
                      RuntimeWarning, stacklevel=2)
        return default


# ---------------------------------------------------------------------------
# Pillar 1: live HTTP exporter.
# ---------------------------------------------------------------------------


class _Handler(BaseHTTPRequestHandler):
    """Routes one scrape.  The server object carries the registry and
    (optionally) the engine; handlers read both without extra locks —
    every surface they touch is itself thread-safe."""

    server: "MonitorServer._Server"  # type: ignore[assignment]

    protocol_version = "HTTP/1.1"

    def _reply(self, code: int, body: str, ctype: str) -> None:
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        mon = self.server.monitor
        mon._scrapes.inc()
        path = self.path.split("?", 1)[0]
        hist, errors = mon._scrape_obs(path.strip("/") or "root")
        t0 = time.perf_counter()
        failed = False
        try:
            self._route(mon, path)
        except BrokenPipeError:  # scraper hung up mid-reply
            pass
        except Exception:
            failed = True
            raise
        finally:
            hist.observe(time.perf_counter() - t0)
            if failed:
                errors.inc()

    def _route(self, mon: "MonitorServer", path: str) -> None:
        if path == "/metrics":
            self._reply(200, mon.registry.to_prometheus(),
                        "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/snapshot":
            # With an engine attached, the engine's view — it embeds
            # the SLO report next to the registry snapshot.
            snap = (mon.engine.metrics_snapshot() if mon.engine
                    is not None else mon.registry.snapshot())
            self._reply(200, json.dumps(snap), "application/json")
        elif path == "/healthz":
            code, body = mon.health()
            self._reply(code, json.dumps(body), "application/json")
        elif path == "/state":
            eng = mon.engine
            if eng is None:
                self._reply(404, "no engine attached\n", "text/plain")
            else:
                self._reply(200, eng.state_dump(),
                            "text/plain; charset=utf-8")
        elif path == "/profile":
            prof = getattr(mon.engine, "prof", None)
            if prof is None:
                self._reply(
                    404, "profiling off; construct the engine with "
                         "profile=True or set HVD_TORCH_PROFILE=1\n",
                    "text/plain")
            else:
                self._reply(200, json.dumps(prof.report()),
                            "application/json")
        elif path == "/device":
            dev = getattr(mon.engine, "device_telemetry", None)
            if dev is None:
                self._reply(
                    404, "device telemetry off; construct the engine "
                         "with device_telemetry=True or set "
                         "HVD_TORCH_DEVICE_TELEMETRY=1\n",
                    "text/plain")
            else:
                self._reply(200, json.dumps(dev.report()),
                            "application/json")
        elif path == "/timeseries":
            sampler = getattr(mon.engine, "sampler", None)
            if sampler is None:
                self._reply(
                    404, "no sampler attached; construct the engine "
                         "with sampler=... or set HVD_TORCH_SAMPLE_S\n",
                    "text/plain")
            else:
                self._reply(200, json.dumps(sampler.report()),
                            "application/json")
        elif path == "/alerts":
            alerts = getattr(mon.engine, "alerts", None)
            if alerts is None:
                self._reply(
                    404, "no alert manager attached; construct the "
                         "engine with alerts=... (HVD_TORCH_ALERTS)\n",
                    "text/plain")
            else:
                self._reply(200, json.dumps(alerts.report()),
                            "application/json")
        elif path == "/advice":
            advisor = getattr(mon.engine, "advisor", None)
            if advisor is None:
                self._reply(404, "no capacity advisor attached\n",
                            "text/plain")
            else:
                advisor.recommend()
                self._reply(200, json.dumps(advisor.report()),
                            "application/json")
        elif path == "/traces":
            tracer = getattr(mon.engine, "tracer", None)
            if tracer is None:
                self._reply(404, "no tracer attached "
                                 "(engine off or pre-tracing)\n",
                            "text/plain")
            else:
                self._reply(200, json.dumps(tracer.recent()),
                            "application/json")
        else:
            self._reply(404, "unknown path; try /metrics /snapshot "
                             "/healthz /state /profile /device "
                             "/timeseries /alerts /advice /traces\n",
                        "text/plain")

    def log_message(self, fmt: str, *args: Any) -> None:
        pass  # scrapes must not spam the job's stderr


class MonitorServer:
    """A per-rank HTTP exporter: daemon thread + ``ThreadingHTTPServer``
    bound to ``host:port`` (``port=0`` picks an ephemeral port — read
    ``.port`` after ``start()``).  Stdlib only, so it costs nothing to
    deploy; scrapes never touch the engine's scheduling loop beyond the
    registry's shared lock — one short pass per scrape, with the
    rendered Prometheus text cached against the registry's generation
    counter so an idle registry serves scrapes without re-rendering."""

    class _Server(ThreadingHTTPServer):
        daemon_threads = True
        monitor: "MonitorServer"

    def __init__(self, registry: metrics_mod.MetricsRegistry | None = None,
                 engine: Any = None, port: int = 0,
                 host: str = "127.0.0.1"):
        self.registry = registry if registry is not None else metrics_mod.DEFAULT
        self.engine = engine
        # The scrape odometer writes on every scrape; left on the
        # registry's shared generation it would invalidate the rendered
        # /metrics cache each hit, defeating the cache exactly when it
        # matters.  A private generation cell keeps the counter live in
        # snapshots while letting its rendered value lag one scrape.
        self._scrapes = self.registry.counter("monitor.scrapes")
        self._scrapes._gen = metrics_mod._Gen()
        # Per-endpoint scrape self-observation on the same private-gen
        # trick: monitor.scrape_s.<endpoint> / monitor.scrape_errors.
        # <endpoint> stay live in snapshots without the act of scraping
        # invalidating the rendered /metrics cache it serves.
        self._scrape_instruments: dict[str, tuple[Any, Any]] = {}
        self._httpd = MonitorServer._Server((host, port), _Handler)
        self._httpd.monitor = self
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: threading.Thread | None = None

    _SCRAPE_ENDPOINTS = frozenset(
        {"metrics", "snapshot", "healthz", "state", "profile",
         "device", "timeseries", "alerts", "advice", "traces", "root"})

    def _scrape_obs(self, endpoint: str) -> tuple[Any, Any]:
        """(latency histogram, error counter) for one endpoint, created
        on first hit with private generation cells.  Unknown paths
        share one ``other`` family so request paths can't mint
        unbounded metric names."""
        if endpoint not in MonitorServer._SCRAPE_ENDPOINTS:
            endpoint = "other"
        pair = self._scrape_instruments.get(endpoint)
        if pair is None:
            hist = self.registry.histogram(
                "monitor.scrape_s." + endpoint)
            hist._gen = metrics_mod._Gen()
            errors = self.registry.counter(
                "monitor.scrape_errors." + endpoint)
            errors._gen = metrics_mod._Gen()
            # Benign race: both threads resolve the same registry
            # instruments, so last-write-wins is still correct.
            pair = self._scrape_instruments[endpoint] = (hist, errors)
        return pair

    def attach_engine(self, engine: Any) -> None:
        """Point ``/healthz`` and ``/state`` at a (new) engine."""
        self.engine = engine

    def health(self) -> tuple[int, dict]:
        """Liveness answer: 200 with uptime, plus engine progress when
        one is attached — 503 once the engine's no-progress watchdog
        would fire (``idle_steps >= watchdog_steps``), so an orchestrator
        restarts the rank the same moment the engine would declare the
        gang wedged."""
        body: dict[str, Any] = {
            "ok": True,
            "rank": metrics_mod.current_rank(),
            "pid": os.getpid(),
        }
        eng = self.engine
        if eng is not None:
            idle = getattr(eng, "_idle_steps", 0)
            wd = getattr(eng, "watchdog_steps", 0)
            last = getattr(eng, "_last_step_ts", None)
            body["step"] = getattr(eng, "step_index", 0)
            body["idle_steps"] = idle
            body["watchdog_steps"] = wd
            body["last_step_age_s"] = (
                None if last is None else time.monotonic() - last)
            if wd and idle >= wd:
                body["ok"] = False
                return 503, body
        return 200, body

    def start(self) -> "MonitorServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                name=f"hvd-monitor-:{self.port}", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=5)
            self._thread = None
        self._httpd.server_close()


def maybe_start_monitor(registry: metrics_mod.MetricsRegistry | None = None,
                        engine: Any = None) -> MonitorServer | None:
    """Start an exporter when ``HVD_TORCH_MONITOR_PORT`` is set — bound to
    base port + rank, so N co-hosted ranks expose N distinct scrape
    targets.  Returns None (silently) when the env var is unset, with a
    warning (not a crash) when it is unparsable or the port is taken."""
    raw = os.environ.get("HVD_TORCH_MONITOR_PORT")
    if not raw:
        return None
    try:
        base = int(raw)
    except ValueError:
        warnings.warn(f"HVD_TORCH_MONITOR_PORT={raw!r} is not an int; "
                      "monitor disabled", RuntimeWarning, stacklevel=2)
        return None
    port = base + metrics_mod.current_rank()
    try:
        return MonitorServer(registry, engine, port=port).start()
    except OSError as e:
        warnings.warn(f"monitor port {port} unavailable ({e}); "
                      "monitor disabled", RuntimeWarning, stacklevel=2)
        return None


# ---------------------------------------------------------------------------
# Pillar 2: exact distributed merge.
# ---------------------------------------------------------------------------


def merge_snapshots(snaps: Iterable[dict],
                    ranks: Iterable[int] | None = None) -> dict:
    """Merge per-rank registry ``snapshot()`` dicts into one fleet view.

    Counters SUM.  Gauges (last-value semantics don't sum) become a
    ``per_rank`` map plus min/max/mean.  Histograms merge EXACTLY:
    their fixed log-bucket counts sum element-wise and the merged
    p50/p90/p99 are recomputed from the summed counts via
    :func:`~horovod_tpu_torch.metrics.percentile_from_buckets` — identical to
    a single-process histogram over the union of observations (pinned
    by tests/test_monitor.py).  Metrics absent on some ranks merge from
    the ranks that have them; differing histogram bounds raise (bounds
    are fixed by construction, so a mismatch means skewed code
    versions)."""
    snaps = list(snaps)
    rank_ids = list(ranks) if ranks is not None else list(range(len(snaps)))
    if len(rank_ids) != len(snaps):
        raise ValueError(
            f"{len(snaps)} snapshots but {len(rank_ids)} rank ids")

    counters: dict[str, int] = {}
    gauge_per_rank: dict[str, dict[int, float]] = {}
    hists: dict[str, dict] = {}

    for rid, snap in zip(rank_ids, snaps):
        for name, v in snap.get("counters", {}).items():
            counters[name] = counters.get(name, 0) + v
        for name, v in snap.get("gauges", {}).items():
            gauge_per_rank.setdefault(name, {})[rid] = v
        for name, h in snap.get("histograms", {}).items():
            if "buckets" not in h:
                raise ValueError(
                    f"histogram {name!r} snapshot has no 'buckets' field "
                    "(pre-merge schema?)")
            m = hists.get(name)
            if m is None:
                hists[name] = {
                    "count": h["count"], "sum": h["sum"],
                    "min": h["min"], "max": h["max"],
                    "buckets": list(h["buckets"]),
                    "bounds": list(h["bounds"]),
                }
                continue
            if m["bounds"] != list(h["bounds"]):
                raise ValueError(
                    f"histogram {name!r} bounds differ across ranks")
            if h["count"]:
                if m["count"] == 0:
                    m["min"], m["max"] = h["min"], h["max"]
                else:
                    m["min"] = min(m["min"], h["min"])
                    m["max"] = max(m["max"], h["max"])
            m["count"] += h["count"]
            m["sum"] += h["sum"]
            m["buckets"] = [a + b for a, b in
                            zip(m["buckets"], h["buckets"])]

    for name, m in hists.items():
        if m["count"] == 0:
            m.update(min=0.0, max=0.0, p50=0.0, p90=0.0, p99=0.0)
        else:
            for key, q in (("p50", 0.50), ("p90", 0.90), ("p99", 0.99)):
                m[key] = metrics_mod.percentile_from_buckets(
                    m["bounds"], m["buckets"], m["count"],
                    m["min"], m["max"], q)

    gauges = {}
    for name, per_rank in gauge_per_rank.items():
        vals = list(per_rank.values())
        gauges[name] = {
            "per_rank": {int(r): v for r, v in sorted(per_rank.items())},
            "min": min(vals), "max": max(vals),
            "mean": sum(vals) / len(vals),
        }

    merged = {
        "ranks": [int(r) for r in rank_ids],
        "counters": dict(sorted(counters.items())),
        "gauges": dict(sorted(gauges.items())),
        "histograms": dict(sorted(hists.items())),
    }

    # Snapshots from engines with a sampler attached carry a
    # "timeseries" section; merge those bucket-for-bucket too.  Ranks
    # without one (older code, sampler off) just don't contribute.
    ts_reports = [(rid, s["timeseries"]) for rid, s in
                  zip(rank_ids, snaps)
                  if isinstance(s.get("timeseries"), dict)]
    if ts_reports:
        from horovod_tpu_torch import timeseries as timeseries_mod
        merged["timeseries"] = timeseries_mod.merge_series(
            [r for _, r in ts_reports],
            ranks=[rid for rid, _ in ts_reports])
    return merged


def aggregate_snapshots(
        registry: metrics_mod.MetricsRegistry | None = None) -> dict:
    """Allgather every rank's ``snapshot()`` over the engine's
    negotiation/grouped-allgather plane and merge — every rank returns
    the SAME fleet view (pinned by the multiprocess test).  Requires
    ``hvd.init()``; single-process, it degenerates to merging the one
    local snapshot."""
    from horovod_tpu_torch.optim.distributed_optimizer import allgather_object
    registry = registry if registry is not None else metrics_mod.DEFAULT
    snaps = allgather_object(registry.snapshot())
    merged = merge_snapshots(snaps)
    registry.counter("monitor.aggregations").inc()
    return merged


# ---------------------------------------------------------------------------
# Pillar 3: straggler detection.
# ---------------------------------------------------------------------------


class StragglerDetector:
    """Rolling-window per-rank step-time tracker with fleet skew checks.

    Feed it one ``record_step(dt)`` per training/engine step (it also
    observes ``hvd.step_s`` on the registry) and optionally negotiate
    waits via ``record_negotiate(dt)`` — or let ``check()`` pull the
    deltas of the shared ``hvd.negotiate_s`` histogram automatically.
    ``check()`` allgathers everyone's window report, computes
    ``skew = slowest − median`` of mean step time, publishes it as the
    ``hvd.step_skew_s`` gauge, and emits a ``monitor.straggler`` event
    naming the slowest rank when the skew exceeds ``warn_s`` seconds
    (``HVD_TORCH_STRAGGLER_WARN_S``, default 1.0)."""

    # record_step arrives from the engine/training thread while the
    # monitor thread calls report()/check() — the windows and the
    # delta baseline are cross-thread state.
    _GUARDED_BY_LOCK = ("_steps", "_negotiates",
                        "_neg_seen_count", "_neg_seen_sum")

    def __init__(self, registry: metrics_mod.MetricsRegistry | None = None,
                 window: int = 64, warn_s: float | None = None):
        self.registry = (registry if registry is not None
                         else metrics_mod.DEFAULT)
        self.warn_s = (float(warn_s) if warn_s is not None
                       else env_float("HVD_TORCH_STRAGGLER_WARN_S", 1.0))
        self._lock = threading.Lock()
        self._steps: collections.deque[float] = collections.deque(
            maxlen=window)
        self._negotiates: collections.deque[float] = collections.deque(
            maxlen=window)
        # Delta baseline for pulling hvd.negotiate_s off the registry.
        self._neg_seen_count = 0
        self._neg_seen_sum = 0.0

    def record_step(self, dt_s: float) -> None:
        with self._lock:
            self._steps.append(float(dt_s))
        self.registry.histogram("hvd.step_s").observe(dt_s)

    def record_negotiate(self, dt_s: float) -> None:
        with self._lock:
            self._negotiates.append(float(dt_s))

    def _pull_negotiate_deltas_locked(self) -> None:
        """Fold in whatever ``hvd.negotiate_s`` observed since the last
        check — the eager engine feeds that histogram on every
        negotiated dispatch, so no extra plumbing is needed.  Caller
        holds ``self._lock`` (a plain Lock: re-taking it would wedge)."""
        h = self.registry.histogram("hvd.negotiate_s")
        count, total = h.count, h.sum
        dn = count - self._neg_seen_count
        if dn > 0:
            # The histogram only keeps aggregates; one mean-valued
            # sample per delta keeps the window honest enough for skew.
            mean = (total - self._neg_seen_sum) / dn
            for _ in range(min(dn, self._negotiates.maxlen or dn)):
                self._negotiates.append(mean)
        self._neg_seen_count, self._neg_seen_sum = count, total

    def report(self) -> dict:
        """This rank's window summary (the unit ``check()`` gathers)."""
        with self._lock:
            self._pull_negotiate_deltas_locked()
            steps = list(self._steps)
            negs = list(self._negotiates)
        return {
            "rank": metrics_mod.current_rank(),
            "n_steps": len(steps),
            "step_mean_s": (sum(steps) / len(steps)) if steps else 0.0,
            "step_max_s": max(steps) if steps else 0.0,
            "negotiate_mean_s": (sum(negs) / len(negs)) if negs else 0.0,
        }

    @staticmethod
    def _evaluate(reports: list[dict]) -> dict:
        """Pure skew computation over gathered reports (unit-testable
        with synthetic multi-rank data): slowest minus median of
        per-rank mean step time."""
        means = [r["step_mean_s"] for r in reports]
        med = statistics.median(means)
        slowest = max(reports, key=lambda r: r["step_mean_s"])
        return {
            "skew_s": slowest["step_mean_s"] - med,
            "median_step_s": med,
            "slowest_rank": slowest["rank"],
            "slowest_step_s": slowest["step_mean_s"],
            "reports": reports,
        }

    def check(self) -> dict:
        """Gather all ranks' reports, publish ``hvd.step_skew_s``, and
        flag the slowest rank when the skew exceeds ``warn_s``.  Every
        rank returns the same verdict (it is an allgather).  Collective:
        all ranks must call it together."""
        from horovod_tpu_torch.optim.distributed_optimizer import allgather_object
        verdict = self._evaluate(allgather_object(self.report()))
        self.registry.gauge("hvd.step_skew_s").set(verdict["skew_s"])
        if verdict["skew_s"] > self.warn_s:
            self.registry.event(
                "monitor.straggler",
                straggler_rank=verdict["slowest_rank"],
                skew_s=verdict["skew_s"],
                median_step_s=verdict["median_step_s"],
                slowest_step_s=verdict["slowest_step_s"])
        return verdict


# ---------------------------------------------------------------------------
# Pillar 4: SLO goodput windows.
# ---------------------------------------------------------------------------


def _sample_percentile(sorted_vals: list[float], q: float) -> float:
    """Linear-interpolated quantile over a small sorted sample (the
    window is a few hundred traces — exact beats bucketed here)."""
    if not sorted_vals:
        return 0.0
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    pos = q * (len(sorted_vals) - 1)
    i = int(pos)
    frac = pos - i
    if i + 1 >= len(sorted_vals):
        return sorted_vals[-1]
    return sorted_vals[i] + (sorted_vals[i + 1] - sorted_vals[i]) * frac


class SLOWindow:
    """Ring buffer of terminal request traces answering "are we meeting
    SLOs *now*?" — process-lifetime histograms can't: a latency
    regression 10 minutes into a 10-hour run vanishes in their tails.

    A request is GOOD when it terminated ``OK`` AND met its latency
    target: its own ``Request.slo_s`` when set, else the window default
    (``slo_e2e_s`` / ``HVD_TORCH_SLO_E2E_S``); with neither, OK alone is
    good (pure completion goodput).  ``goodput()`` is the good fraction
    of the last ``window`` terminal requests; ``report()`` adds windowed
    TTFT/TPOT/E2E percentiles."""

    _GUARDED_BY_LOCK = ("_traces",)

    def __init__(self, window: int = 256, slo_e2e_s: float | None = None):
        if window <= 0:
            raise ValueError(f"window must be positive, got {window}")
        self.slo_e2e_s = (slo_e2e_s if slo_e2e_s is not None
                          else (env_float("HVD_TORCH_SLO_E2E_S", 0.0) or None))
        self._lock = threading.Lock()
        self._traces: collections.deque = collections.deque(maxlen=window)

    def add(self, trace: Any, slo_s: float | None = None) -> None:
        """Record one TERMINAL trace (``ServeEngine._finalize_trace``
        calls this); ``slo_s`` is the request's own target, overriding
        the window default."""
        with self._lock:
            self._traces.append((trace, slo_s))

    def __len__(self) -> int:
        """Terminal traces currently in the window (the engine's memory
        accounting sizes the ring with this)."""
        with self._lock:
            return len(self._traces)

    def _good(self, trace: Any, slo_s: float | None) -> bool:
        if trace.status != "OK":
            return False
        target = slo_s if slo_s is not None else self.slo_e2e_s
        if target is None:
            return True
        e2e = trace.e2e_s
        return e2e is not None and e2e <= target

    def goodput(self) -> float:
        """Fraction of windowed terminal requests that were good; 1.0
        when the window is empty (no evidence of badness)."""
        with self._lock:
            items = list(self._traces)
        if not items:
            return 1.0
        return sum(self._good(t, s) for t, s in items) / len(items)

    def report(self) -> dict:
        """Windowed SLO summary: goodput, status mix, and TTFT/TPOT/E2E
        p50/p90/p99 over the last ``window`` terminal requests."""
        with self._lock:
            items = list(self._traces)
        out: dict[str, Any] = {
            "window": self._traces.maxlen,
            "n": len(items),
            "slo_e2e_s": self.slo_e2e_s,
            "goodput": 1.0,
            "statuses": {},
        }
        if not items:
            out.update(ttft_s={}, tpot_s={}, e2e_s={})
            return out
        good = 0
        statuses: dict[str, int] = {}
        series: dict[str, list[float]] = {
            "ttft_s": [], "tpot_s": [], "e2e_s": []}
        for t, s in items:
            good += self._good(t, s)
            statuses[t.status or "?"] = statuses.get(t.status or "?", 0) + 1
            for key in series:
                v = getattr(t, key)
                if v is not None:
                    series[key].append(v)
        out["goodput"] = good / len(items)
        out["statuses"] = dict(sorted(statuses.items()))
        for key, vals in series.items():
            vals.sort()
            out[key] = ({"p50": _sample_percentile(vals, 0.50),
                         "p90": _sample_percentile(vals, 0.90),
                         "p99": _sample_percentile(vals, 0.99),
                         "n": len(vals)} if vals else {})
        return out
