"""The port's tool twins (``horovod_tpu_torch/tools/``) and the repo's
stdlib readers over the port's files.

``device_report``, ``trace_report``, ``chaos_run``, ``simfleet_run`` and
``perf_gate`` import the JAX package in ``tools/``; their twins read the
port's planes.  The cases mirror ``tests/test_device_telemetry.py``
(the ``--compare`` gate and perf_gate's seventh gate),
``tests/test_tracing.py`` (trace_report's CLI and the folded perf gate),
``tests/test_autoscaler.py`` (health_report's autoscale timeline) and
``tests/test_alerts.py`` (health_report's live scrape against the
event-log replay, and its gate), each on reports the port itself wrote:
a ``llama_tiny`` engine and router of the port with every plane on, a
port autoscale campaign's event log, and the port's alert manager.
``load_report`` is covered in ``test_torch_loadgen.py``.
"""

from __future__ import annotations

import json
import os
import pathlib
import sys
import urllib.request

import pytest

from horovod_tpu_torch import tracing
from horovod_tpu_torch.alerts import ALERT_RULES, AlertManager
from horovod_tpu_torch.device_telemetry import build_report
from horovod_tpu_torch.metrics import EventLog, MetricsRegistry
from horovod_tpu_torch.router import RouterServer
from horovod_tpu_torch.serving import OK, Request
from horovod_tpu_torch.serving_scheduler import ServeEngine
from horovod_tpu_torch.timeseries import MetricsSampler
from horovod_tpu_torch.tools import (chaos_run, device_report, perf_gate,
                                     simfleet_run, trace_report)
from torch_engine_twin import Clock, tiny_world

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

from tools import health_report, profile_report, router_report  # noqa: E402


@pytest.fixture(scope="module")
def world():
    return tiny_world()


@pytest.fixture(scope="module")
def served(world, tmp_path_factory):
    """A port router over one engine with the device plane, the profiler
    and tracing on, all logging to one event log; returns the engine, the
    router's ``/snapshot`` body and the log's path."""
    path = str(tmp_path_factory.mktemp("served") / "events.jsonl")
    log = EventLog(path)
    reg = MetricsRegistry(event_log=log)
    os.environ["HVD_TORCH_TRACE_SAMPLE"] = "1"
    try:
        eng = ServeEngine(world.tp, world.tcfg, n_slots=2, max_len=64,
                          chunk=8, prefix_cache=True, metrics=reg,
                          device_telemetry=True, profile=True,
                          sampler=False)
        router = RouterServer([eng], policy="round_robin",
                              registry=MetricsRegistry(event_log=log),
                              sampler=False).start()
    finally:
        del os.environ["HVD_TORCH_TRACE_SAMPLE"]
    try:
        rids = [router.route(Request(prompt=[3 + i, 5, 7, 9 + i],
                                     max_new_tokens=4)) for i in range(4)]
        assert all(router.result(r, timeout=120).status == OK
                   for r in rids)
        router.poll_now()
        with urllib.request.urlopen(
                f"http://{router.host}:{router.port}/snapshot",
                timeout=60) as r:
            snap = json.loads(r.read())
    finally:
        router.stop()
    return eng, snap, path


# -- device_report -----------------------------------------------------------


def _report_with(peak, flops, stall_s=0.001):
    ring = [{"step": i, "dt_s": 0.01, "flops": flops,
             "bytes_accessed": 2 * flops, "h2d_bytes": 64,
             "d2h_bytes": 8, "sync_s": 0.004 + stall_s,
             "compute_est_s": 0.004, "host_stall_s": stall_s,
             "dispatches": {"tick": 1}} for i in range(10)]
    return build_report(
        platform="cuda", device_kind="NVIDIA H100", n_devices=1,
        peak_flops=peak, peak_flops_known=peak is not None,
        peak_source="arg" if peak else None, programs={}, compiles=3,
        compile_total_s=1.0, retraces=0, retrace_compile_est_s=0.0,
        ticks=10, window=256, ring=ring, memory=None, param_bytes=0,
        kv_total_bytes=0)


def test_device_report_compare_trips_on_mfu_regression(tmp_path):
    old = _report_with(1e12, 1e9)
    good = _report_with(1e12, 0.99e9)
    bad = _report_with(1e12, 0.5e9)
    assert old["win"]["mfu"] == pytest.approx(1e9 / 0.01 / 1e12)
    assert not any(r["regressed"]
                   for r in device_report.compare_reports(old, good))
    rows = device_report.compare_reports(old, bad, threshold_pct=10.0)
    flagged = {r["metric"] for r in rows if r["regressed"]}
    assert "mfu" in flagged and "flops_per_s" in flagged
    rows = device_report.compare_reports(_report_with(None, 1e9), bad)
    assert "mfu" not in {r["metric"] for r in rows}
    worse = _report_with(1e12, 1e9, stall_s=0.003)
    rows = device_report.compare_reports(old, worse)
    assert {r["metric"] for r in rows if r["regressed"]} == \
        {"host_stall_ms_per_tick"}
    po, pb = tmp_path / "old.json", tmp_path / "bad.json"
    po.write_text(json.dumps(old))
    pb.write_text(json.dumps(bad))
    assert device_report.main(["--compare", str(po), str(po)]) == 0
    assert device_report.main(["--compare", str(po), str(pb)]) == 1


def test_device_report_reads_the_port_engine_live_and_replayed(
        served, tmp_path, capsys):
    """A port engine's live report, its ``metrics_snapshot()`` dump and
    the event-log replay render alike and gate clean against each other."""
    eng, _snap, path = served
    live = eng.device_telemetry.report()
    saved = tmp_path / "snap.json"
    saved.write_text(json.dumps(eng.metrics_snapshot()))
    assert device_report.load_report(str(saved)) == json.loads(
        json.dumps(live))
    replay = device_report.load_report(path)
    assert replay["programs"].keys() == live["programs"].keys()
    assert replay["win"]["dispatches"] == live["win"]["dispatches"]
    text = device_report.render(live)
    assert "device report" in text and "tick" in text
    dump = tmp_path / "live.json"
    dump.write_text(json.dumps(live))
    assert device_report.main([str(dump)]) == 0
    assert device_report.main(["--compare", str(dump), str(dump)]) == 0
    capsys.readouterr()


def test_perf_gate_folds_device_as_seventh_gate(tmp_path):
    assert "device" in perf_gate.GATES and len(perf_gate.GATES) == 7
    po, pb = tmp_path / "old.json", tmp_path / "bad.json"
    po.write_text(json.dumps(_report_with(1e12, 1e9)))
    pb.write_text(json.dumps(_report_with(1e12, 0.5e9)))
    assert perf_gate.run_gates({"device": (str(po), str(po))})["ok"]
    bad = perf_gate.run_gates({"device": (str(po), str(pb))})
    assert not bad["ok"]
    assert bad["gates"][0]["gate"] == "device"
    assert any("mfu" in p for p in bad["gates"][0]["problems"])


# -- trace_report + the folded perf gate -------------------------------------


def _synthetic_spans(tid_key, decode_s):
    tid = tracing.trace_id_for(tid_key, 0)
    root = tracing.child_span_id(tid, "", "serve.request")
    dec = tracing.child_span_id(tid, root, "serve.decode")
    return [
        {"kind": tracing.SPAN_KIND, "trace_id": tid, "span_id": root,
         "parent_id": None, "name": "serve.request", "t0": 0.0,
         "t1": 0.2 + decode_s, "attrs": {}},
        {"kind": tracing.SPAN_KIND, "trace_id": tid, "span_id": dec,
         "parent_id": root, "name": "serve.decode", "t0": 0.2,
         "t1": 0.2 + decode_s, "attrs": {}},
    ]


def test_trace_report_cli_render_and_compare_gate(tmp_path, capsys):
    src = tmp_path / "events.jsonl"
    with open(src, "w") as f:
        for rec in _synthetic_spans("a", 0.3) + _synthetic_spans("b", 0.1):
            f.write(json.dumps(rec) + "\n")
        f.write('{"kind": "trace.sp')            # torn tail line
    assert trace_report.main([str(src), "--critical-path"]) == 0
    out = capsys.readouterr().out
    assert "2 traces" in out and "serve.decode" in out
    assert "fleet critical-path breakdown" in out
    old = {k: v for k, v in trace_report.build_report(
        trace_report.load_records([str(src)])).items() if k != "_forest"}
    new = json.loads(json.dumps(old))
    new["mean_critical_s"] = old["mean_critical_s"] * 2.0
    by = new["critical_path"]["by_name"]
    by["serve.decode"]["share"] = min(by["serve.decode"]["share"] + 0.4,
                                      1.0)
    o_p, n_p = tmp_path / "old.json", tmp_path / "new.json"
    o_p.write_text(json.dumps(old))
    n_p.write_text(json.dumps(new))
    assert trace_report.main(["--compare", str(o_p), str(o_p)]) == 0
    capsys.readouterr()
    assert trace_report.main(["--compare", str(o_p), str(n_p)]) == 1
    assert "REGRESSED" in capsys.readouterr().out
    flagged = {r["metric"] for r in trace_report.compare_reports(old, new)
               if r["regressed"]}
    assert "mean_critical_ms" in flagged
    assert "share:serve.decode" in flagged
    perf = tmp_path / "perfetto.json"
    rep = trace_report.build_report(trace_report.load_records([str(src)]))
    n = trace_report.export_perfetto(rep, str(perf))
    events = json.loads(perf.read_text())["traceEvents"]
    assert len(events) == n
    assert {e["name"] for e in events if e["ph"] == "X"} == {
        "serve.request", "serve.decode"}


def test_trace_report_renders_the_port_fleet_log(served, capsys):
    """The port router's spans: one tree a request, rooted at
    ``router.request`` with the engine's ``serve.request`` below."""
    _eng, _snap, path = served
    rep = trace_report.build_report(trace_report.load_records([path]))
    assert rep["n_traces"] == 4
    assert trace_report.main([path, "--critical-path"]) == 0
    out = capsys.readouterr().out
    assert "router.request" in out and "serve.request" in out


def test_perf_gate_folds_compares_into_one_verdict(tmp_path, capsys):
    recs = _synthetic_spans("g", 0.2)
    old = {k: v for k, v in trace_report.build_report(recs).items()
           if k != "_forest"}
    new = json.loads(json.dumps(old))
    new["mean_critical_s"] = old["mean_critical_s"] * 3.0
    ok_p, bad_p = tmp_path / "ok.json", tmp_path / "bad.json"
    ok_p.write_text(json.dumps(old))
    bad_p.write_text(json.dumps(new))
    verdict = perf_gate.run_gates({"trace": (str(ok_p), str(ok_p))})
    assert verdict["ok"] and verdict["n_regressed"] == 0
    assert perf_gate.main(["--trace", str(ok_p), str(ok_p)]) == 0
    capsys.readouterr()
    assert perf_gate.main(["--trace", str(ok_p), str(bad_p)]) == 1
    out = capsys.readouterr().out
    assert "FAIL  trace" in out and "REGRESSION:" in out
    assert "perf gate: FAILED" in out
    junk = tmp_path / "junk.json"
    junk.write_text("not json {")
    verdict = perf_gate.run_gates({"trace": (str(junk), str(ok_p)),
                                   "load": (str(ok_p), str(ok_p))})
    assert not verdict["ok"] and verdict["n_regressed"] == 2
    with pytest.raises(SystemExit):
        perf_gate.main([])


# -- chaos_run and simfleet_run ----------------------------------------------


def test_chaos_run_twin_runs_and_gates(tmp_path, capsys):
    path = tmp_path / "chaos.json"
    assert chaos_run.main(["--seed", "3", "--device", "cpu", "--json",
                           str(path)]) == 0
    out = capsys.readouterr().out
    assert "PASS  bit_identical" in out and "chaos: OK" in out
    report = json.loads(path.read_text())
    assert report["ok"] and report["kills_fired"] >= 1
    worse = dict(report, ok=False,
                 oracles=dict(report["oracles"], healed=False))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(worse))
    assert chaos_run.main(["--compare", str(path), str(path)]) == 0
    assert chaos_run.main(["--compare", str(path), str(bad)]) == 1
    assert perf_gate.run_gates({"chaos": (str(path), str(bad))}) \
        ["n_regressed"] == 1
    capsys.readouterr()


def test_simfleet_run_twin_runs_and_gates(tmp_path, capsys):
    path = tmp_path / "sim.json"
    assert simfleet_run.main(["--seed", "1", "--replicas", "10",
                              "--requests", "500", "--no-poll-scaling",
                              "--json", str(path)]) == 0
    assert "simfleet: OK" in capsys.readouterr().out
    report = json.loads(path.read_text())
    assert report["ok"] and report["n_replicas"] == 10
    worse = dict(report, ok_fraction=report["ok_fraction"] - 0.5)
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(worse))
    assert simfleet_run.main(["--compare", str(path), str(path)]) == 0
    assert simfleet_run.main(["--compare", str(path), str(bad)]) == 1
    assert not perf_gate.run_gates(
        {"simfleet": (str(path), str(bad))})["ok"]
    capsys.readouterr()


# -- the stdlib readers over the port's files --------------------------------


def test_health_report_renders_the_port_autoscale_timeline(world,
                                                           tmp_path):
    """A port autoscale campaign's event log through health_report: the
    scale_up / cordon / retire rows, autoscaler rows outside the alert
    key, and the CLI renders it with exit 0."""
    from horovod_tpu_torch.chaos import run_autoscale_campaign

    log = str(tmp_path / "events.jsonl")
    rep = run_autoscale_campaign(world.tp, world.tcfg, n_replicas=2,
                                 n_groups=2, waves=5, event_log=log,
                                 journal=str(tmp_path / "wal.jsonl"))
    assert rep["ok"], rep["oracles"]
    tl = health_report.timeline_from_events(health_report.read_events(log))
    events = [r["event"] for r in tl if r.get("plane") == "autoscale"]
    assert events.index("scale_up") < events.index("cordon") \
        < events.index("retire")
    assert health_report.timeline_key(tl) == []
    report = health_report.build_report(tl, source="events")
    text = health_report.render(report)
    assert "scale_up" in text and "auto0" in text
    assert health_report.main(["--events", log]) == 0


def test_port_autoscale_campaign_pages_nothing_at_any_sampler_cadence(
        world, tmp_path, monkeypatch):
    """The campaign's router runs without a sampler, so no alert rule can
    read the forced drain's ``router.replica_deaths``, however slowly the
    host runs the campaign.  A sampler ticking at every poll (the slowest
    host) is the case that paged ``replica_death`` when the router took
    the env-driven sampler."""
    from horovod_tpu_torch.chaos import run_autoscale_campaign

    monkeypatch.setenv("HVD_TORCH_SAMPLE_S", "1e-6")
    log = str(tmp_path / "events.jsonl")
    rep = run_autoscale_campaign(world.tp, world.tcfg, n_replicas=2,
                                 n_groups=2, waves=5, event_log=log,
                                 journal=str(tmp_path / "wal.jsonl"))
    assert rep["ok"] and rep["drain_forced"], rep["oracles"]
    events = health_report.read_events(log)
    assert not any(e.get("kind", "").startswith("alert.") for e in events)
    assert health_report.timeline_key(
        health_report.timeline_from_events(events)) == []


def _burn_setup(event_log=None, time_scale=0.1):
    reg = MetricsRegistry(event_log=event_log)
    clk = Clock(0.0)
    s = MetricsSampler(reg, sample_s=1.0, clock=clk)
    am = AlertManager(s, rules=[r for r in ALERT_RULES
                                if r["name"] == "goodput_burn_fast"],
                      registry=reg, time_scale=time_scale, clock=clk)
    g = reg.gauge("serve.goodput")

    def step(v: float) -> None:
        clk.t += 1.0
        g.set(v)
        s.tick()
        am.tick()

    return reg, am, step


def test_health_report_live_scrape_matches_event_log_replay(tmp_path):
    path = str(tmp_path / "events.jsonl")
    _reg, am, step = _burn_setup(event_log=EventLog(path))
    for v in [1.0] * 5 + [0.5] * 4 + [1.0] * 15:
        step(v)
    live = health_report.build_report(
        health_report.timeline_from_alerts(am.report()),
        source="live", alerts=am.report())
    replay = health_report.build_report(
        health_report.timeline_from_events(health_report.read_events(path)),
        source="replay")
    key = health_report.timeline_key(live["timeline"])
    assert key == health_report.timeline_key(replay["timeline"])
    assert key == [("goodput_burn_fast", "fire", "firing"),
                   ("goodput_burn_fast", "resolve", "ok")]
    assert live["fired"] == replay["fired"] == ["goodput_burn_fast"]
    assert live["ok"] and replay["ok"]
    assert all(isinstance(r["t"], float) for r in replay["timeline"])


def test_health_report_cli_renders_and_gates_regressions(tmp_path,
                                                         capsys):
    healed = str(tmp_path / "healed.jsonl")
    _r, _am, step = _burn_setup(event_log=EventLog(healed))
    for v in [1.0] * 5 + [0.5] * 4 + [1.0] * 15:
        step(v)
    burning = str(tmp_path / "burning.jsonl")
    _r2, _am2, step2 = _burn_setup(event_log=EventLog(burning))
    for v in [1.0] * 5 + [0.5] * 4:
        step2(v)
    old_json = str(tmp_path / "old.json")
    new_json = str(tmp_path / "new.json")
    assert health_report.main(["--events", healed, "--out", old_json]) == 0
    assert "resolve" in capsys.readouterr().out
    assert health_report.main(["--events", burning, "--out", new_json,
                               "--json"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert out["firing"] == ["goodput_burn_fast"]
    assert out["unresolved"] == ["goodput_burn_fast"]
    assert health_report.main(["--compare", old_json, new_json]) == 1
    assert "REGRESSION" in capsys.readouterr().out
    assert health_report.main(["--compare", new_json, new_json]) == 0
    assert health_report.main(["--compare", old_json, old_json]) == 0


def test_router_and_profile_reports_read_the_port(served, tmp_path,
                                                  capsys):
    """router_report renders the port router's ``/snapshot`` body and
    its event log; profile_report the port engine's profiler report and
    its replay."""
    eng, snap, path = served
    saved = tmp_path / "snapshot.json"
    saved.write_text(json.dumps(snap))
    rep = router_report.load_report(str(saved))
    assert rep["requests"] == 4
    assert router_report.main([str(saved)]) == 0
    assert router_report.main([path]) == 0
    assert "replica0" in capsys.readouterr().out
    prof = tmp_path / "profile.json"
    prof.write_text(json.dumps(eng.prof.report()))
    text = profile_report.render(profile_report.load_report(str(prof)))
    assert "decode_dispatch" in text
    replay = profile_report.load_report(path)
    assert set(replay["phases"]) == set(eng.prof.report()["phases"])
    assert profile_report.main(["--compare", str(prof), str(prof)]) == 0
    capsys.readouterr()
