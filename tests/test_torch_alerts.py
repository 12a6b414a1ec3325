"""Port parity: the health plane (``timeseries.py`` and ``alerts.py``).

Mirrors tests/test_alerts.py's sampler, alert-rule and capacity-advisor
cases.  Each scenario runs twice, once on the JAX package's modules and
once on the port's, with the same virtual clock and the same registry
updates, and returns its reports; the port's equal the JAX package's as
dicts (the same Python arithmetic on the same inputs), and the JAX test's
own assertions hold on the port's.
"""

from __future__ import annotations

import bisect
import json
import types

import pytest

from horovod_tpu import alerts as jalerts
from horovod_tpu import metrics as jmetrics
from horovod_tpu import monitor as jmonitor
from horovod_tpu import timeseries as jts
from horovod_tpu_torch import alerts as talerts
from horovod_tpu_torch import metrics as tmetrics
from horovod_tpu_torch import monitor as tmonitor
from horovod_tpu_torch import timeseries as tts
from torch_engine_twin import Clock

JAX = types.SimpleNamespace(metrics=jmetrics, ts=jts, alerts=jalerts,
                            monitor=jmonitor)
PORT = types.SimpleNamespace(metrics=tmetrics, ts=tts, alerts=talerts,
                             monitor=tmonitor)


def _rules(m, *names):
    picked = [r for r in m.alerts.ALERT_RULES if r["name"] in names]
    assert len(picked) == len(names)
    return picked


def _setup(m, *names, time_scale=0.1):
    reg = m.metrics.MetricsRegistry(event_log=None)
    clk = Clock(0.0)
    s = m.ts.MetricsSampler(reg, sample_s=1.0, clock=clk)
    am = m.alerts.AlertManager(s, rules=_rules(m, *names), registry=reg,
                               time_scale=time_scale, clock=clk)
    return reg, clk, s, am


def _tick(clk, s, am=None):
    clk.t += 1.0
    s.tick()
    if am is not None:
        am.tick()


# ---------------------------------------------------------------------------
# Scenarios: each returns everything the JAX test asserts on.
# ---------------------------------------------------------------------------


def counter_rates_and_tiers(m):
    reg = m.metrics.MetricsRegistry(event_log=None)
    clk = Clock(0.0)
    s = m.ts.MetricsSampler(reg, sample_s=1.0, clock=clk)
    c = reg.counter("serve.requests_completed")
    took = []
    for _ in range(25):
        c.inc(2)
        clk.t += 1.0
        took.append(s.tick())
    return {"took": took,
            "window": s.window("serve.requests_completed", 30.0,
                               now=clk.t),
            "rate": s.counter_rate("serve.requests_completed", 10.0,
                                   now=clk.t),
            "report": s.report(), "snapshot": reg.snapshot()}


def counter_reset(m):
    s = m.ts.MetricsSampler(m.metrics.MetricsRegistry(event_log=None),
                            sample_s=1.0, clock=Clock(0.0))
    for t, v in ((1.0, 100.0), (2.0, 10.0), (3.0, 13.0)):
        s.ingest(t, {"counters": {"supervisor.respawns": v}})
    return s.window("supervisor.respawns", 10.0, now=3.0)


def gauge_envelope_and_slope(m):
    s = m.ts.MetricsSampler(m.metrics.MetricsRegistry(event_log=None),
                            sample_s=1.0, clock=Clock(0.0))
    for i in range(10):
        s.ingest(float(i), {"gauges": {"kv.free_blocks": 100.0 - 10.0 * i}})
    return {"stats": s.gauge_stats("kv.free_blocks", 20.0, now=9.0),
            "slope": s.slope_per_s("kv.free_blocks", 20.0, now=9.0),
            "short": s.slope_per_s("kv.free_blocks", 0.5, now=9.0)}


def hist_deltas(m):
    reg = m.metrics.MetricsRegistry(event_log=None)
    clk = Clock(0.0)
    s = m.ts.MetricsSampler(reg, sample_s=1.0, clock=clk)
    h = reg.histogram("serve.ttft_s")
    clk.t = 1.0
    s.tick()
    for v in (0.004, 0.005, 0.006, 0.2):
        h.observe(v)
    clk.t = 2.0
    s.tick()
    return {"win": s.hist_window("serve.ttft_s", 5.0, now=2.0),
            "p99": s.hist_percentile("serve.ttft_s", 5.0, 0.99, now=2.0),
            "live": reg.snapshot()["histograms"]["serve.ttft_s"]}


def hist_end_offset(m):
    reg = m.metrics.MetricsRegistry(event_log=None)
    clk = Clock(0.0)
    s = m.ts.MetricsSampler(reg, sample_s=1.0, clock=clk)
    h = reg.histogram("serve.ttft_s")
    for t, v in ((1.0, None), (2.0, 0.002), (3.0, 0.3)):
        if v is not None:
            for _ in range(50):
                h.observe(v)
        clk.t = t
        s.tick()
    return {"cur": s.hist_percentile("serve.ttft_s", 0.5, 0.99, now=3.0),
            "base": s.hist_percentile("serve.ttft_s", 0.5, 0.99, now=3.0,
                                      end_offset_s=1.0)}


def torn_snapshots(m):
    s = m.ts.MetricsSampler(m.metrics.MetricsRegistry(event_log=None),
                            sample_s=1.0, clock=Clock(0.0))
    took = [s.ingest(1.0, {"gauges": {"g": 1.0}}),
            s.ingest(1.5, {"gauges": {"g": 2.0}}),
            s.ingest(3.0, "torn"),
            s.ingest(3.5, {"histograms": {"h1": "torn",
                                          "h2": {"count": 3},
                                          "h3": {"buckets": [1],
                                                 "bounds": "x"}},
                           "counters": {"c": "nan?"},
                           "gauges": {"g": 4.0, "g2": None}})]
    before = s.report()
    for t, n, b, bounds in ((5.0, 1, [1, 0], [1.0]),
                            (6.0, 2, [1, 1, 0], [1.0, 2.0]),
                            (7.0, 3, [1, 2, 0], [1.0, 2.0])):
        s.ingest(t, {"histograms": {"h4": {"count": n, "sum": float(n),
                                           "buckets": b,
                                           "bounds": bounds}}})
    return {"took": took, "before": before, "report": s.report(),
            "h4": s.window("h4", 10.0, now=7.0)}


def merge_series_missing_rank(m):
    def feed(s, upto):
        for i in range(upto):
            t = float(i + 1)
            s.ingest(t, {"counters": {"c": 2.0 * t},
                         "gauges": {"g": 10.0 + t}})
    s0 = m.ts.MetricsSampler(m.metrics.MetricsRegistry(event_log=None),
                             sample_s=1.0)
    s1 = m.ts.MetricsSampler(m.metrics.MetricsRegistry(event_log=None),
                             sample_s=1.0)
    feed(s0, 5)
    feed(s1, 3)
    return m.ts.merge_series([s0.report(), "torn", s1.report()],
                             ranks=[0, 1])


def merge_snapshots_timeseries(m):
    s0 = m.ts.MetricsSampler(m.metrics.MetricsRegistry(event_log=None),
                             sample_s=1.0)
    s0.ingest(1.0, {"gauges": {"serve.goodput": 1.0}})
    snaps = [{"counters": {}, "gauges": {}, "histograms": {},
              "timeseries": s0.report()},
             {"counters": {}, "gauges": {}, "histograms": {}}]
    return m.monitor.merge_snapshots(snaps)


def burn_fast(m):
    reg, clk, s, am = _setup(m, "goodput_burn_fast")
    g = reg.gauge("serve.goodput")
    firing = []
    for v in [1.0] * 5 + [0.5] * 4 + [1.0] * 3 + [1.0] * 12:
        g.set(v)
        _tick(clk, s, am)
        firing.append(am.firing())
    return {"firing": firing, "report": am.report(),
            "states": am.states(), "counters": reg.snapshot()["counters"]}


def burn_slow(m):
    reg, clk, s, am = _setup(m, "goodput_burn_slow", time_scale=0.01)
    g = reg.gauge("serve.goodput")
    for i in range(18):
        g.set(0.9 if 12 <= i < 15 else 1.0)
        _tick(clk, s, am)
    return {"states": am.states(), "firing": am.firing()}


def threshold_pending_cancel(m):
    reg, clk, s, am = _setup(m, "straggler_skew")
    g = reg.gauge("hvd.step_skew_s")
    seen = []
    for v in [0.0] * 3 + [5.0, 0.0] + [5.0] * 4:
        g.set(v)
        _tick(clk, s, am)
        seen.append(dict(am.states()["straggler_skew"]))
    clk.t += 50.0
    am.evaluate(clk.t)
    seen.append(dict(am.states()["straggler_skew"]))
    g.set(0.0)
    _tick(clk, s, am)
    return {"seen": seen, "firing": am.firing(), "report": am.report()}


def ttft_drift(m):
    reg, clk, s, am = _setup(m, "ttft_p99_drift")
    h = reg.histogram("serve.ttft_s")
    firing = []
    for v in [0.002] * 11 + [0.3] * 7 + [0.002] * 30:
        for _ in range(20):
            h.observe(v)
        _tick(clk, s, am)
        firing.append(am.firing())
    return {"firing": firing, "states": am.states()}


def kv_exhaustion(m):
    reg, clk, s, am = _setup(m, "kv_exhaustion")
    g = reg.gauge("kv.free_blocks")
    v, firing = 400.0, []
    for dv in [-20.0] * 4 + [0.0] * 20:
        v += dv
        g.set(v)
        _tick(clk, s, am)
        firing.append((am.firing(), am.states()["kv_exhaustion"]["value"]))
    return {"firing": firing, "states": am.states()}


def death_and_flap(m):
    reg, clk, s, am = _setup(m, "replica_death", "replica_flap")
    deaths = reg.counter("router.replica_deaths")
    respawns = reg.counter("supervisor.respawns")
    firing = []
    for i in range(76):
        if i == 3:
            deaths.inc()
        if i in (3, 4, 5):
            respawns.inc()
        _tick(clk, s, am)
        firing.append(am.firing())
    return {"firing": firing, "states": am.states()}


def report_shape(m):
    reg, clk, s, am = _setup(m, "goodput_burn_fast")
    g = reg.gauge("serve.goodput")
    for _ in range(5):
        g.set(1.0)
        _tick(clk, s, am)
    return {"report": am.report(),
            "table": m.alerts.render_alert_table(),
            "rules": m.alerts.ALERT_RULES}


def _advised(m, gauges_by_t, counters_by_t=None, knee=None, **kw):
    reg = m.metrics.MetricsRegistry(event_log=None)
    clk = Clock(0.0)
    s = m.ts.MetricsSampler(reg, sample_s=1.0, clock=clk)
    for t in sorted(gauges_by_t):
        snap = {"gauges": gauges_by_t[t]}
        if counters_by_t:
            snap["counters"] = counters_by_t.get(t, {})
        s.ingest(float(t), snap)
        clk.t = float(t)
    adv = m.alerts.CapacityAdvisor(s, registry=reg, load_report=knee,
                                   window_s=10.0, clock=clk, **kw)
    rec = adv.recommend()
    return {"rec": rec, "report": adv.report(),
            "gauges": reg.snapshot()["gauges"],
            "counters": reg.snapshot()["counters"]}


def advisor_no_goodput(m):
    return _advised(m, {})


def advisor_scale_up_knee(m):
    return _advised(
        m, {i: {"serve.goodput": 0.9, "router.replicas_healthy": 2.0,
                "serve.queue_depth": 2.0 * i} for i in range(1, 7)},
        {i: {"serve.requests_completed": 8.0 * i} for i in range(1, 7)},
        knee={"serve_load_knee_goodput_rps": 2.0})


def advisor_scale_up_no_knee(m, tmp_path):
    return _advised(
        m, {i: {"serve.goodput": 0.5, "router.replicas_healthy": 1.0,
                "serve.queue_depth": 3.0 * i} for i in range(1, 7)},
        knee=str(tmp_path / "missing.json"))


def advisor_scale_down(m):
    return _advised(
        m, {i: {"serve.goodput": 1.0, "router.replicas_healthy": 3.0,
                "serve.queue_depth": 5.0} for i in range(1, 7)},
        {i: {"serve.requests_completed": 0.5 * i} for i in range(1, 7)},
        knee={"serve_load_knee_goodput_rps": 2.0})


def advisor_hold(m):
    return _advised(
        m, {i: {"serve.goodput": 1.0, "router.replicas_healthy": 3.0,
                "serve.queue_depth": 5.0} for i in range(1, 7)},
        {i: {"serve.requests_completed": 3.0 * i} for i in range(1, 7)},
        knee={"serve_load_knee_goodput_rps": 2.0})


def advisor_knee_path_and_alerts(m, tmp_path):
    report = tmp_path / "serve_load_report.json"
    report.write_text(json.dumps({"serve_load_knee_goodput_rps": 4.0}))
    reg, clk, s, am = _setup(m, "goodput_burn_fast")
    g = reg.gauge("serve.goodput")
    for _ in range(8):
        g.set(0.5)
        _tick(clk, s, am)
    adv = m.alerts.CapacityAdvisor(s, alerts=am, registry=reg,
                                   load_report=str(report), window_s=10.0,
                                   clock=clk)
    return {"knee": adv.load_knee(), "rec": adv.recommend()}


SCENARIOS = {f.__name__: f for f in (
    counter_rates_and_tiers, counter_reset, gauge_envelope_and_slope,
    hist_deltas, hist_end_offset, torn_snapshots,
    merge_series_missing_rank, merge_snapshots_timeseries, burn_fast,
    burn_slow, threshold_pending_cancel, ttft_drift, kv_exhaustion,
    death_and_flap, report_shape, advisor_no_goodput,
    advisor_scale_up_knee, advisor_scale_down, advisor_hold)}
WITH_TMP = {f.__name__: f for f in (advisor_scale_up_no_knee,
                                    advisor_knee_path_and_alerts)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_equals_the_jax_planes(name):
    got = SCENARIOS[name](PORT)
    assert got == SCENARIOS[name](JAX)
    json.dumps(got, default=str)


@pytest.mark.parametrize("name", sorted(WITH_TMP))
def test_advisor_file_scenarios_equal_the_jax_planes(name, tmp_path):
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    assert WITH_TMP[name](PORT, tmp_path / "p") == \
        WITH_TMP[name](JAX, tmp_path / "j")


# ---------------------------------------------------------------------------
# The JAX tests' own assertions, on the port's results.
# ---------------------------------------------------------------------------


def test_sampler_assertions_hold_on_the_port():
    r = counter_rates_and_tiers(PORT)
    assert all(r["took"]) and len(r["window"]) == 24
    assert all(p["rate"] == pytest.approx(2.0) for p in r["window"])
    assert r["rate"]["n"] == 11 and r["rate"]["rate"] == pytest.approx(2.0)
    ten = r["report"]["tiers"]["10s"]["series"]["serve.requests_completed"]
    assert all(p["t"] % 10.0 == 0.0 for p in ten["points"])
    assert r["snapshot"]["counters"]["ts.samples"] == 25
    assert [p["delta"] for p in counter_reset(PORT)] == [0.0, 3.0]
    g = gauge_envelope_and_slope(PORT)
    assert g["stats"]["last"] == 10.0 and g["stats"]["max"] == 100.0
    assert g["slope"] == pytest.approx(-10.0) and g["short"] is None
    h = hist_deltas(PORT)
    assert h["win"]["count"] == 4
    assert h["win"]["buckets"] == h["live"]["buckets"]
    i = bisect.bisect_left(h["win"]["bounds"], 0.2)
    assert h["win"]["bounds"][i - 1] <= h["p99"] <= h["win"]["bounds"][i]
    e = hist_end_offset(PORT)
    assert e["base"] < 0.01 < e["cur"]
    t = torn_snapshots(PORT)
    assert t["took"] == [True, False, False, True]
    assert set(t["before"]["tiers"]["raw"]["series"]) == {"g"}
    assert [p["buckets"] for p in t["h4"] if "buckets" in p] == [[0, 1, 0]]
    merged = merge_series_missing_rank(PORT)
    by_t = {p["t"]: p for p in merged["tiers"]["raw"]["series"]["c"][
        "points"]}
    assert by_t[2.0]["ranks"] == 2 and by_t[5.0]["ranks"] == 1
    assert "serve.goodput" in merge_snapshots_timeseries(PORT)[
        "timeseries"]["tiers"]["raw"]["series"]


def test_alert_assertions_hold_on_the_port():
    b = burn_fast(PORT)
    assert b["firing"][4] == [] and b["firing"][8] == ["goodput_burn_fast"]
    assert b["firing"][11] == ["goodput_burn_fast"]
    assert b["firing"][-1] == []
    assert [tr["event"] for tr in b["report"]["history"]] == \
        ["fire", "resolve"]
    assert b["counters"]["alert.fired"] == b["counters"][
        "alert.resolved"] == 1
    assert burn_slow(PORT)["states"]["goodput_burn_slow"]["fired"] == 0
    th = threshold_pending_cancel(PORT)
    assert th["seen"][3]["state"] == "pending"
    assert th["seen"][4]["state"] == "ok"
    assert th["seen"][-1]["state"] == "firing" and th["seen"][-1]["no_data"]
    assert [tr["event"] for tr in th["report"]["history"]] == \
        ["pending", "cancel", "pending", "fire", "resolve"]
    d = ttft_drift(PORT)
    assert d["firing"][10] == [] and d["firing"][17] == ["ttft_p99_drift"]
    assert d["states"]["ttft_p99_drift"]["resolved"] == 1
    kv = kv_exhaustion(PORT)
    assert kv["firing"][3][0] == ["kv_exhaustion"]
    assert kv["firing"][3][1] <= 30.0
    assert kv["states"]["kv_exhaustion"]["resolved"] == 1
    df = death_and_flap(PORT)
    assert df["firing"][3] == ["replica_death"]
    assert df["firing"][5] == ["replica_death", "replica_flap"]
    assert df["firing"][-1] == []
    rep = report_shape(PORT)
    assert rep["report"]["time_scale"] == 0.1
    for name in talerts.rule_names():
        assert f"`{name}`" in rep["table"]
    assert rep["rules"] == jalerts.ALERT_RULES


def test_advisor_assertions_hold_on_the_port(tmp_path):
    assert advisor_no_goodput(PORT)["rec"]["action"] == "hold"
    up = advisor_scale_up_knee(PORT)
    assert up["rec"]["action"] == "scale_up" and up["rec"]["n"] == 3
    assert up["gauges"]["advisor.target_delta"] == 3
    assert up["report"]["last"] == up["rec"]
    one = advisor_scale_up_no_knee(PORT, tmp_path)["rec"]
    assert one["action"] == "scale_up" and one["n"] == 1
    down = advisor_scale_down(PORT)
    assert down["rec"]["action"] == "scale_down" and down["rec"]["n"] == 2
    assert advisor_hold(PORT)["rec"]["reason"] == "within envelope"
    esc = advisor_knee_path_and_alerts(PORT, tmp_path)
    assert esc["knee"] == {"serve_load_knee_goodput_rps": 4.0}
    assert "alerts firing: goodput_burn_fast" in esc["rec"]["reason"]


def test_maybe_sampler_and_maybe_alerts_env_gates(monkeypatch):
    reg = tmetrics.MetricsRegistry(event_log=None)
    monkeypatch.setenv("HVD_TORCH_SAMPLE_S", "0")
    assert tts.maybe_sampler(reg) is None
    monkeypatch.setenv("HVD_TORCH_SAMPLE_S", "0.25")
    s = tts.maybe_sampler(reg)
    assert s is not None and s.sample_s == 0.25
    assert tts.maybe_sampler(tmetrics.NULL) is None
    monkeypatch.setenv("HVD_TORCH_ALERTS", "0")
    assert talerts.maybe_alerts(s) is None
    monkeypatch.delenv("HVD_TORCH_ALERTS")
    am = talerts.maybe_alerts(s, reg)
    assert am is not None and am.rules == tuple(talerts.ALERT_RULES)
    assert talerts.maybe_alerts(None) is None


def test_advisor_without_a_report_reads_no_file(tmp_path, monkeypatch):
    """No ``load_report``: the advisor reads ``serve_load_report.json``
    from ``HVD_TORCH_BENCH_CACHE``, else the working directory (the
    reference's default drop location, where the load harness's report
    goes); with the knob at a directory without a report there is no knee,
    whatever the working directory holds, and the reference's
    ``HVD_TPU_BENCH_CACHE`` does not reach the port."""
    (tmp_path / "serve_load_report.json").write_text(
        json.dumps({"serve_load_knee_goodput_rps": 4.0}))
    cache = tmp_path / "cache"
    cache.mkdir()
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HVD_TPU_BENCH_CACHE", str(tmp_path))
    monkeypatch.setenv("HVD_TORCH_BENCH_CACHE", str(cache))
    reg, clk, s, am = _setup(PORT, "goodput_burn_fast")
    for _ in range(3):
        _tick(clk, s, am)
    adv = talerts.CapacityAdvisor(s, alerts=am, registry=reg, clock=clk)
    assert adv.load_knee() is None
    assert adv.recommend()["evidence"]["knee_goodput_rps"] is None
    (cache / "serve_load_report.json").write_text(
        json.dumps({"serve_load_knee_goodput_rps": 3.0}))
    assert adv.load_knee() == {"serve_load_knee_goodput_rps": 3.0}
    monkeypatch.delenv("HVD_TORCH_BENCH_CACHE")
    assert adv.load_knee() == {"serve_load_knee_goodput_rps": 4.0}
