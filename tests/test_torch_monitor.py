"""Port parity: the cross-rank monitor (``horovod_tpu_torch/monitor.py``).

Mirrors tests/test_monitor.py.  ``merge_snapshots`` of the same seeded
per-rank registries equals the JAX module's merge field for field; the
exporter serves every endpoint over a real socket (port 0), scraped while
the port's engine serves; ``SLOWindow`` (moved here from the engine
module) gives the JAX window's reports; ``aggregate_snapshots`` and the
straggler check run on a two-rank gloo world.
"""

from __future__ import annotations

import json
import re
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from horovod_tpu import metrics as jmetrics
from horovod_tpu import monitor as jmonitor
from horovod_tpu_torch import basics
from horovod_tpu_torch import metrics as metrics_mod
from horovod_tpu_torch import serving_scheduler
from horovod_tpu_torch.alerts import AlertManager, rule_names
from horovod_tpu_torch.metrics import EventLog, MetricsRegistry
from horovod_tpu_torch.monitor import (
    MonitorServer, SLOWindow, StragglerDetector, aggregate_snapshots,
    maybe_start_monitor, merge_snapshots,
)
from horovod_tpu_torch.serving import OK, Request
from horovod_tpu_torch.serving_scheduler import ServeEngine
from horovod_tpu_torch.timeseries import MetricsSampler
from torch_engine_twin import tiny_world
from torch_gloo_world import start_world


def _get(server: MonitorServer, path: str):
    url = f"http://{server.host}:{server.port}{path}"
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, r.headers.get("Content-Type", ""), \
                r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read().decode()


_SAMPLE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^{}]*\})? (-?[0-9.eE+\-]+|NaN)"
    r"( # \{.*\} .*)?$")


def parse_prometheus(text: str) -> dict[str, list[tuple[str, float]]]:
    """Parse 0.0.4 text; raises on a malformed line or an untyped sample."""
    assert text.endswith("\n")
    typed: dict[str, str] = {}
    samples: dict[str, list[tuple[str, float]]] = {}
    for ln in text.splitlines():
        if not ln or ln.startswith("# HELP "):
            continue
        if ln.startswith("# TYPE "):
            _, _, name, kind = ln.split(" ", 3)
            assert kind in ("counter", "gauge", "histogram"), ln
            typed[name] = kind
            continue
        m = _SAMPLE.match(ln)
        assert m, f"malformed sample line: {ln!r}"
        name = m.group(1)
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        assert name in typed or base in typed, f"untyped sample {name!r}"
        samples.setdefault(name, []).append(
            (m.group(2) or "", float(m.group(3))))
    return samples


def _dyadic_values(rng, n):
    return [float(k) / 256.0 for k in rng.integers(1, 2 ** 16, n)]


def _seeded_registries(mod, seed):
    """Per-rank registries of module ``mod`` fed the same seeded values:
    histograms, counters and gauges, some only on some ranks."""
    rng = np.random.default_rng(seed)
    n_ranks = int(rng.integers(2, 5))
    regs = [mod.MetricsRegistry(event_log=None) for _ in range(n_ranks)]
    for r, reg in enumerate(regs):
        for v in _dyadic_values(rng, int(rng.integers(0, 200))):
            reg.histogram("serve.e2e_s").observe(v)
        reg.counter("serve.steps").inc(int(rng.integers(0, 50)))
        reg.gauge("serve.queue_depth").set(float(rng.integers(0, 9)))
        if r % 2:
            reg.counter("only.on.odd").inc(r)
            reg.histogram("serve.ttft_s").observe(0.5 + r)
    return regs


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_merge_equals_the_jax_merge_and_the_union(seed):
    regs = _seeded_registries(metrics_mod, seed)
    jregs = _seeded_registries(jmetrics, seed)
    ranks = [3 * i + 1 for i in range(len(regs))]
    got = merge_snapshots([r.snapshot() for r in regs], ranks=ranks)
    want = jmonitor.merge_snapshots([r.snapshot() for r in jregs],
                                    ranks=ranks)
    assert got == want
    # and the merged histogram is the union's, bit for bit
    union = MetricsRegistry(event_log=None)
    rng = np.random.default_rng(seed)
    rng.integers(2, 5)
    for _ in regs:
        for v in _dyadic_values(rng, int(rng.integers(0, 200))):
            union.histogram("serve.e2e_s").observe(v)
        rng.integers(0, 50)
        rng.integers(0, 9)
    assert got["histograms"]["serve.e2e_s"] == \
        union.snapshot()["histograms"]["serve.e2e_s"]
    json.dumps(got)


def test_merge_counters_sum_gauges_per_rank():
    a, b = MetricsRegistry(event_log=None), MetricsRegistry(event_log=None)
    a.counter("serve.steps").inc(3)
    b.counter("serve.steps").inc(4)
    a.counter("only.on.a").inc(1)
    a.gauge("serve.queue_depth").set(2.0)
    b.gauge("serve.queue_depth").set(6.0)
    merged = merge_snapshots([a.snapshot(), b.snapshot()], ranks=[0, 3])
    assert merged["counters"]["serve.steps"] == 7
    assert merged["counters"]["only.on.a"] == 1
    g = merged["gauges"]["serve.queue_depth"]
    assert g["per_rank"] == {0: 2.0, 3: 6.0}
    assert g["min"] == 2.0 and g["max"] == 6.0 and g["mean"] == 4.0


def test_merge_empty_partial_and_rejected():
    a, b = MetricsRegistry(event_log=None), MetricsRegistry(event_log=None)
    a.histogram("h")
    b.histogram("h").observe(0.5)
    h = merge_snapshots([a.snapshot(), b.snapshot()])["histograms"]["h"]
    assert h["count"] == 1 and h["min"] == h["max"] == 0.5
    e1, e2 = MetricsRegistry(event_log=None), MetricsRegistry(event_log=None)
    e1.histogram("z")
    e2.histogram("z")
    z = merge_snapshots([e1.snapshot(), e2.snapshot()])["histograms"]["z"]
    assert z["count"] == 0 and z["p99"] == 0.0 and z["min"] == 0.0
    a, b = MetricsRegistry(event_log=None), MetricsRegistry(event_log=None)
    a.histogram("h", bounds=(1.0, 2.0)).observe(1.5)
    b.histogram("h", bounds=(1.0, 4.0)).observe(1.5)
    with pytest.raises(ValueError, match="bounds differ"):
        merge_snapshots([a.snapshot(), b.snapshot()])
    snap = a.snapshot()
    del snap["histograms"]["h"]["buckets"]
    with pytest.raises(ValueError, match="buckets"):
        merge_snapshots([snap])
    with pytest.raises(ValueError, match="rank ids"):
        merge_snapshots([a.snapshot()], ranks=[0, 1])


def test_aggregate_snapshots_single_process():
    reg = MetricsRegistry(event_log=None)
    reg.counter("serve.steps").inc(5)
    reg.histogram("serve.e2e_s").observe(0.25)
    basics.init("cpu")
    try:
        fleet = aggregate_snapshots(reg)
    finally:
        basics.shutdown()
    assert fleet["counters"]["serve.steps"] == 5
    assert fleet["histograms"]["serve.e2e_s"]["count"] == 1
    assert fleet["ranks"] == [0]
    assert reg.counter("monitor.aggregations").value == 1


def _fleet(rank, world):
    """Rank r: its own counters and histogram, a straggler window where
    rank 1 is slow, then the gathered views."""
    reg = MetricsRegistry(event_log=None)
    reg.counter("serve.steps").inc(10 * (rank + 1))
    for v in range(rank + 2):
        reg.histogram("serve.e2e_s").observe(0.125 * (v + 1))
    own = reg.snapshot()
    fleet = aggregate_snapshots(reg)
    det = StragglerDetector(reg, window=8, warn_s=0.05)
    for _ in range(4):
        det.record_step(0.5 if rank == 1 else 0.01)
    verdict = det.check()
    return own, fleet, verdict, reg.gauge("hvd.step_skew_s").value


def test_aggregate_and_straggler_on_two_ranks():
    join = start_world(_fleet, 2)
    results = join(timeout=120)
    snaps = [r[0] for r in results]
    want = merge_snapshots(snaps)
    for own, fleet, verdict, skew in results:
        assert fleet["counters"] == want["counters"]
        assert fleet["histograms"] == want["histograms"]
        assert fleet["ranks"] == [0, 1]
        assert verdict["slowest_rank"] == 1
        assert verdict["skew_s"] == pytest.approx(0.5 - 0.255)
        assert skew == pytest.approx(verdict["skew_s"])
    assert results[0][2] == results[1][2]
    assert want["counters"]["serve.steps"] == 30


def test_prometheus_help_lines_and_escaping():
    reg = MetricsRegistry(event_log=None)
    reg.counter("monitor.scrapes").inc(2)
    reg.histogram("serve.ttft_s").observe(0.1)
    text = reg.to_prometheus()
    assert ("# HELP monitor_scrapes "
            + metrics_mod.METRIC_HELP["monitor.scrapes"]) in text
    assert text.index("# HELP serve_ttft_s") < text.index(
        "# TYPE serve_ttft_s")
    parse_prometheus(text)
    assert metrics_mod.escape_label_value('a"b\\c\nd') == 'a\\"b\\\\c\\nd'


# ---------------------------------------------------------------------------
# The live exporter.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world():
    return tiny_world(seed=5)


def _reqs(n=4, pl=3, new=4, **kw):
    rng = np.random.default_rng(2)
    return [Request(prompt=[int(t) for t in
                            rng.integers(1, 250, pl + (i % 3))],
                    max_new_tokens=new, **kw)
            for i in range(n)]


def _engine(world, **kw):
    kw.setdefault("metrics", MetricsRegistry(event_log=None))
    kw.setdefault("monitor", False)
    return ServeEngine(world.tp, world.tcfg, n_slots=2, max_len=32,
                       chunk=8, **kw)


def test_exporter_endpoints(world):
    reg = MetricsRegistry(event_log=None)
    eng = _engine(world, metrics=reg)
    mon = MonitorServer(reg, eng, port=0).start()
    try:
        assert mon.port > 0
        code, ctype, text = _get(mon, "/metrics")
        assert code == 200 and "version=0.0.4" in ctype
        parse_prometheus(text)
        code, ctype, body = _get(mon, "/snapshot")
        assert code == 200 and ctype == "application/json"
        snap = json.loads(body)
        assert set(snap) == {"counters", "gauges", "histograms", "slo",
                             "memory", "timeseries", "alerts", "advice"}
        assert snap["counters"]["monitor.scrapes"] >= 1
        assert snap["memory"]["kv"]["block_bytes"] == eng._block_bytes
        code, _, body = _get(mon, "/profile")
        assert code == 404 and "HVD_TORCH_PROFILE" in body
        code, _, body = _get(mon, "/device")
        assert code == 404 and "HVD_TORCH_DEVICE_TELEMETRY" in body
        code, _, body = _get(mon, "/traces")
        assert code == 200 and json.loads(body) == []
        code, _, body = _get(mon, "/healthz")
        hz = json.loads(body)
        assert code == 200 and hz["ok"] is True
        assert hz["rank"] == 0 and hz["pid"] > 0
        assert hz["watchdog_steps"] == eng.watchdog_steps
        code, _, body = _get(mon, "/state")
        assert code == 200 and body.startswith("rank=0 pid=")
        assert _get(mon, "/nope")[0] == 404
        eng._idle_steps = eng.watchdog_steps
        code, _, body = _get(mon, "/healthz")
        assert code == 503 and json.loads(body)["ok"] is False
    finally:
        mon.stop()


def test_exporter_no_engine_paths():
    reg = MetricsRegistry(event_log=None)
    mon = MonitorServer(reg, port=0).start()
    try:
        assert _get(mon, "/state")[0] == 404
        code, _, body = _get(mon, "/timeseries")
        assert code == 404 and "HVD_TORCH_SAMPLE_S" in body
        code, _, body = _get(mon, "/alerts")
        assert code == 404 and "HVD_TORCH_ALERTS" in body
        assert _get(mon, "/advice")[0] == 404
        code, _, body = _get(mon, "/healthz")
        assert code == 200 and json.loads(body)["ok"] is True
        assert reg.counter("monitor.scrapes").value == 5
    finally:
        mon.stop()


def test_exporter_health_plane_endpoints(world):
    reg = MetricsRegistry(event_log=None)
    sampler = MetricsSampler(reg, sample_s=1e-9)
    eng = _engine(world, metrics=reg, sampler=sampler,
                  alerts=AlertManager(sampler, registry=reg),
                  profile=True, device_telemetry=True)
    assert all(r.status == OK for r in eng.run(_reqs()))
    mon = MonitorServer(reg, eng, port=0).start()
    try:
        code, ctype, body = _get(mon, "/timeseries")
        assert code == 200 and ctype == "application/json"
        ts = json.loads(body)
        assert set(ts["tiers"]) == {"raw", "10s", "60s"}
        assert "serve.requests_completed" in ts["tiers"]["raw"]["series"]
        alerts = json.loads(_get(mon, "/alerts")[2])
        assert [r["name"] for r in alerts["rules"]] == list(rule_names())
        assert "goodput_burn_fast" not in alerts["firing"]
        advice = json.loads(_get(mon, "/advice")[2])
        assert advice["last"]["action"] in {"hold", "scale_up",
                                            "scale_down"}
        prof = json.loads(_get(mon, "/profile")[2])
        assert prof["ticks"] == eng.step_index
        dev = json.loads(_get(mon, "/device")[2])
        assert dev["ticks"] == eng.step_index
        snap = json.loads(_get(mon, "/snapshot")[2])
        assert {"timeseries", "alerts", "device", "profile"} <= set(snap)
        assert any(k.startswith("monitor.scrape_s.")
                   for k in snap["histograms"])
        gen = reg._gen.n
        text1 = _get(mon, "/metrics")[2]
        assert text1 == _get(mon, "/metrics")[2]
        assert reg._gen.n == gen
    finally:
        mon.stop()


def test_exporter_live_scrape_during_serve(world):
    reg = MetricsRegistry(event_log=None)
    eng = _engine(world, metrics=reg, monitor=0)
    assert eng.monitor is not None and eng.monitor.port > 0
    scrapes: list[str] = []
    stop = threading.Event()

    def _scraper():
        while not stop.is_set():
            scrapes.append(_get(eng.monitor, "/metrics")[2])
            stop.wait(0.002)

    t = threading.Thread(target=_scraper, daemon=True)
    t.start()
    try:
        out = eng.run(_reqs(6))
    finally:
        stop.set()
        t.join(timeout=10)
    try:
        assert all(r.status == OK for r in out)
        assert scrapes
        for text in scrapes:
            parse_prometheus(text)
        samples = parse_prometheus(_get(eng.monitor, "/metrics")[2])
        snap = eng.metrics_snapshot()
        assert samples["serve_steps"][0][1] == snap["counters"][
            "serve.steps"]
        assert (samples["serve_e2e_s_count"][0][1]
                == snap["histograms"]["serve.e2e_s"]["count"] == 6)
        assert samples["serve_goodput"][0][1] == snap["gauges"][
            "serve.goodput"]
    finally:
        eng.monitor.stop()


def test_maybe_start_monitor_env(monkeypatch, world):
    monkeypatch.delenv("HVD_TORCH_MONITOR_PORT", raising=False)
    assert maybe_start_monitor(MetricsRegistry(event_log=None)) is None
    monkeypatch.setenv("HVD_TORCH_MONITOR_PORT", "not-a-port")
    with pytest.warns(RuntimeWarning, match="not an int"):
        assert maybe_start_monitor(MetricsRegistry(event_log=None)) is None
    probe = MonitorServer(MetricsRegistry(event_log=None), port=0)
    free = probe.port
    probe.stop()
    monkeypatch.setenv("HVD_TORCH_MONITOR_PORT",
                       str(free - metrics_mod.current_rank()))
    eng = _engine(world, monitor=None)     # None reads the environment
    try:
        assert eng.monitor is not None and eng.monitor.port == free
        assert _get(eng.monitor, "/metrics")[0] == 200
    finally:
        eng.monitor.stop()


def test_engine_monitor_arg_validation(world):
    with pytest.raises(ValueError, match="monitor"):
        _engine(world, monitor=True)
    mon = MonitorServer(MetricsRegistry(event_log=None), port=0)
    try:
        eng = _engine(world, monitor=mon)
        assert eng.monitor is mon and mon.engine is eng
    finally:
        mon.stop()


# ---------------------------------------------------------------------------
# Straggler detection.
# ---------------------------------------------------------------------------


def test_straggler_evaluate_synthetic():
    reports = [{"rank": 0, "step_mean_s": 0.10},
               {"rank": 1, "step_mean_s": 0.11},
               {"rank": 2, "step_mean_s": 0.95},
               {"rank": 3, "step_mean_s": 0.10}]
    v = StragglerDetector._evaluate(reports)
    assert v == jmonitor.StragglerDetector._evaluate(reports)
    assert v["slowest_rank"] == 2
    assert v["median_step_s"] == pytest.approx(0.105)
    assert v["skew_s"] == pytest.approx(0.95 - 0.105)


def test_straggler_check_single_process(tmp_path):
    log = EventLog(str(tmp_path / "ev.jsonl"))
    reg = MetricsRegistry(event_log=log)
    det = StragglerDetector(reg, window=8, warn_s=-1.0)
    for dt in (0.01, 0.02, 0.03):
        det.record_step(dt)
    basics.init("cpu")
    try:
        v = det.check()
    finally:
        basics.shutdown()
    assert v["skew_s"] == pytest.approx(0.0)
    assert v["slowest_rank"] == 0 and len(v["reports"]) == 1
    assert reg.gauge("hvd.step_skew_s").value == pytest.approx(0.0)
    assert reg.histogram("hvd.step_s").count == 3
    log.close()
    ev = [e for e in EventLog.read(log.path)
          if e["kind"] == "monitor.straggler"]
    assert len(ev) == 1 and ev[0]["straggler_rank"] == 0


def test_straggler_pulls_negotiate_deltas_and_env(monkeypatch):
    reg = MetricsRegistry(event_log=None)
    det = StragglerDetector(reg, window=8, warn_s=10.0)
    reg.histogram("hvd.negotiate_s").observe(0.2)
    reg.histogram("hvd.negotiate_s").observe(0.4)
    assert det.report()["negotiate_mean_s"] == pytest.approx(0.3)
    n_before = len(det._negotiates)
    det.report()
    assert len(det._negotiates) == n_before
    # the threshold: the argument, else HVD_TORCH_STRAGGLER_WARN_S, else
    # 1 s; the reference's knob does not reach the port
    monkeypatch.setenv("HVD_TPU_STRAGGLER_WARN_S", "2.5")
    assert StragglerDetector(reg).warn_s == 1.0
    monkeypatch.setenv("HVD_TORCH_STRAGGLER_WARN_S", "0.25")
    assert StragglerDetector(reg).warn_s == 0.25
    assert StragglerDetector(reg, warn_s=3.0).warn_s == 3.0


# ---------------------------------------------------------------------------
# SLO goodput windows: moved from the engine module, unchanged.
# ---------------------------------------------------------------------------


def _terminal_trace(mod, rid, e2e, status=OK, n_tokens=3):
    tr = mod.Trace(rid=rid, enqueue_ts=100.0, enqueue_step=0)
    tr.first_token_ts = 100.0 + e2e / 2
    tr.terminal_ts = 100.0 + e2e
    tr.status = status
    tr.n_tokens = n_tokens
    return tr


def _slo_walk(mod, window_cls, monkeypatch):
    monkeypatch.setenv("HVD_TORCH_SLO_E2E_S", "1.0")
    monkeypatch.setenv("HVD_TPU_SLO_E2E_S", "1.0")
    w = window_cls(window=4)
    out = [w.goodput(), w.report()]
    for rid, e2e, status, slo in ((0, 0.5, OK, None), (1, 2.0, OK, None),
                                  (2, 0.5, "TIMEOUT", None),
                                  (3, 2.0, OK, 5.0), (4, 9.0, OK, None)):
        w.add(_terminal_trace(mod, rid, e2e, status), slo_s=slo)
        out += [w.goodput(), len(w)]
    out.append(w.report())
    monkeypatch.setenv("HVD_TORCH_SLO_E2E_S", "0")
    monkeypatch.setenv("HVD_TPU_SLO_E2E_S", "0")
    nt = window_cls(window=8)
    nt.add(_terminal_trace(mod, 0, 100.0))
    nt.add(_terminal_trace(mod, 1, 0.1, "FAILED"))
    out += [nt.slo_e2e_s, nt.goodput(), nt.report()]
    return out


def test_slo_window_equals_the_jax_window(monkeypatch):
    got = _slo_walk(metrics_mod, SLOWindow, monkeypatch)
    assert got == _slo_walk(jmetrics, jmonitor.SLOWindow, monkeypatch)
    assert got[1]["n"] == 0 and got[-3] is None
    rep = got[-4]
    assert rep["n"] == 4 and rep["window"] == 4
    assert rep["goodput"] == pytest.approx(1 / 4)
    assert rep["statuses"]["TIMEOUT"] == 1
    assert rep["e2e_s"]["p50"] == pytest.approx(2.0)
    assert got[-2] == pytest.approx(0.5)
    with pytest.raises(ValueError):
        SLOWindow(window=0)
    # the engine holds the monitor's window, not a copy of its own
    assert serving_scheduler.monitor_mod.SLOWindow is SLOWindow
    assert not hasattr(serving_scheduler, "SLOWindow")


def test_engine_slo_integration(world):
    eng = _engine(world, slo_window=16)
    out = eng.run(_reqs(4, new=3, slo_s=1000.0))
    assert all(r.status == OK for r in out)
    assert isinstance(eng.slo, SLOWindow)
    snap = eng.metrics_snapshot()
    assert snap["slo"]["goodput"] == 1.0
    assert snap["gauges"]["serve.goodput"] == 1.0
    assert snap["slo"]["n"] == 4 and snap["slo"]["e2e_s"]["p99"] > 0.0
    out2 = eng.run(_reqs(2, new=3, slo_s=1e-9))
    assert all(r.status == OK for r in out2)
    rep = eng.slo_report()
    assert rep["n"] == 6 and rep["goodput"] == pytest.approx(4 / 6)
    with pytest.raises(ValueError, match="slo_s"):
        eng.submit(Request(prompt=[1], max_new_tokens=1, slo_s=0.0))
