"""Port parity: the device telemetry plane (``device_telemetry.py`` and
its wiring into ``ServeEngine``).

Mirrors tests/test_device_telemetry.py.  What differs is what the plane
counts: the port counts each program once on fake tensors, every layer,
so its FLOPs equal the analytic count (2 per multiply-add: the weights
plus attention over ``max_len`` positions) exactly, where the JAX
package's XLA cost model counts a scanned layer body once.  So the FLOPs
are held to the analytic count, and the report's schema, not its
numbers, to the JAX plane's.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from horovod_tpu import alerts as jalerts
from horovod_tpu import metrics as jmetrics
from horovod_tpu import timeseries as jts
from horovod_tpu.serving import Request as JRequest
from horovod_tpu.serving_scheduler import ServeEngine as JaxEngine
from horovod_tpu_torch import alerts as talerts
from horovod_tpu_torch import device_telemetry as dt_mod
from horovod_tpu_torch import metrics as metrics_mod
from horovod_tpu_torch import timeseries as tts
from horovod_tpu_torch.device_telemetry import (
    PROGRAMS, DeviceTelemetry, build_report, lookup_peak_flops,
    maybe_telemetry, report_from_events)
from horovod_tpu_torch.metrics import MetricsRegistry
from horovod_tpu_torch.monitor import MonitorServer
from horovod_tpu_torch.serving import OK, Request
from horovod_tpu_torch.serving_scheduler import ServeEngine
from torch_engine_twin import Clock, tiny_world


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


def analytic_flops_per_token(cfg, positions: int) -> int:
    """2 FLOP per multiply-add: q/k/v/o, the SwiGLU MLP and the LM head,
    plus QKᵀ and PV over ``positions`` keys in every layer."""
    d, qd = cfg.dim, cfg.n_heads * cfg.head_dim
    kvd = cfg.n_kv_heads * cfg.head_dim
    per_layer = (2 * d * qd + 2 * d * kvd + 3 * d * cfg.ffn_dim
                 + 2 * qd * positions)
    return 2 * (cfg.n_layers * per_layer + d * cfg.vocab_size)


# ---------------------------------------------------------------------------
# Unit surfaces: peak table, env knobs.
# ---------------------------------------------------------------------------


def test_peak_table_lookup_and_override(monkeypatch):
    assert lookup_peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert lookup_peak_flops("NVIDIA H100 PCIe") == 756e12
    assert lookup_peak_flops("cpu") is None          # honest unknown
    reg = MetricsRegistry(event_log=None)
    t = DeviceTelemetry(reg, peak_flops=1e12)
    assert t.peak_flops == 1e12 and t.peak_source == "arg"
    assert t.report()["n_devices"] == 1             # one card an engine
    monkeypatch.setenv("HVD_TORCH_PEAK_FLOPS", "2e12")
    t = DeviceTelemetry(MetricsRegistry(event_log=None), device="cpu")
    assert t.peak_flops == 2e12 and t.peak_source == "env"
    monkeypatch.setenv("HVD_TORCH_PEAK_FLOPS", "not-a-float")
    with pytest.warns(RuntimeWarning, match="HVD_TORCH_PEAK_FLOPS"):
        t = DeviceTelemetry(MetricsRegistry(event_log=None), device="cpu")
    assert t.peak_flops is None                      # CPU: no table hit
    assert t.peak_source is None and not t.peak_flops_known
    assert (t.platform, t.device_kind) == ("cpu", "cpu")


def test_poll_and_window_knobs(monkeypatch):
    monkeypatch.setenv("HVD_TORCH_DEVICE_POLL_S", "0.25")
    assert DeviceTelemetry(MetricsRegistry(event_log=None)).poll_s == 0.25
    monkeypatch.setenv("HVD_TORCH_DEVICE_POLL_S", "junk")
    assert DeviceTelemetry(MetricsRegistry(event_log=None)).poll_s == 1.0
    with pytest.raises(ValueError):
        DeviceTelemetry(MetricsRegistry(event_log=None), window=0)


def test_env_factory_and_engine_knob(world, monkeypatch):
    monkeypatch.delenv("HVD_TORCH_DEVICE_TELEMETRY", raising=False)
    assert maybe_telemetry(MetricsRegistry(event_log=None)) is None
    assert _engine(world).device_telemetry is None
    monkeypatch.setenv("HVD_TORCH_DEVICE_TELEMETRY", "1")
    eng = _engine(world)
    assert isinstance(eng.device_telemetry, DeviceTelemetry)
    assert eng.device_telemetry.device == eng.device == torch.device("cpu")
    # explicit argument beats the env
    assert _engine(world, device_telemetry=False).device_telemetry is None


# ---------------------------------------------------------------------------
# The cost capture: every program, the analytic count exactly.
# ---------------------------------------------------------------------------


def test_cost_capture_all_four_programs(world):
    eng = _engine(world, spec=True, device_telemetry=True)
    out = eng.run(_reqs(4))
    assert all(r.status == OK for r in out)
    rep = eng.metrics_snapshot()["device"]
    assert set(rep["programs"]) == set(PROGRAMS)
    for name in PROGRAMS:
        row = rep["programs"][name]
        assert "error" not in row
        assert row["bytes_accessed"] > 0.0
        assert row["compile_s"] == 0.0          # eager: nothing compiles
        assert (row["flops"] > 0.0) == (name != "set_row")
    assert rep["programs"]["chunk"]["dispatches"] > 0
    assert rep["programs"]["set_row"]["dispatches"] > 0
    assert rep["programs"]["spec_tick"]["dispatches"] > 0
    # spec engines never call plain tick: captured, zero dispatches
    assert rep["programs"]["tick"]["dispatches"] == 0
    assert rep["compiles"] == len(PROGRAMS)
    assert rep["compile_total_s"] == 0.0
    assert eng.metrics.counter("device.compiles").value == len(PROGRAMS)
    assert eng.metrics.histogram("device.compile_s").count == len(PROGRAMS)


@pytest.mark.parametrize("n_slots,max_len,chunk,draft_k", [
    (2, 32, 8, 3), (3, 64, 16, 4)])
def test_captured_flops_equal_the_analytic_count(world, n_slots, max_len,
                                                 chunk, draft_k):
    eng = ServeEngine(world.tp, world.tcfg, n_slots=n_slots,
                      max_len=max_len, chunk=chunk, spec=True,
                      draft_k=draft_k, device_telemetry=True,
                      metrics=MetricsRegistry(event_log=None))
    per_token = analytic_flops_per_token(world.tcfg, max_len)
    progs = eng.device_telemetry.programs
    assert progs["tick"]["flops"] == n_slots * per_token
    assert progs["chunk"]["flops"] == chunk * per_token
    assert progs["spec_tick"]["flops"] == (n_slots * (draft_k + 1)
                                           * per_token)
    assert progs["set_row"]["flops"] == 0.0
    if (n_slots, max_len, chunk) == (2, 32, 8):
        # llama_tiny: 90,112 multiply-adds a token for the weights, 8,192
        # for attention over 32 positions
        assert progs["tick"]["flops"] == 393_216
        assert progs["chunk"]["flops"] == 1_572_864


def test_capture_leaves_the_pool_and_signatures_untouched(world):
    off = _engine(world)
    on = _engine(world, device_telemetry=True, spec=True)
    for a, b in zip(on.pcache, off.pcache):
        assert torch.equal(a, b)
    assert torch.equal(on.last_logits, off.last_logits)
    assert on.compile_cache_sizes() == {"tick": 0, "chunk": 0,
                                        "set_row": 0, "spec_tick": 0}
    # the RoPE table the capture primed is a real tensor, not a fake one
    from horovod_tpu_torch.models import llama
    freqs = llama._rope_freqs(world.tcfg.rope_theta,
                              world.tcfg.head_dim // 2, on.device)
    assert type(freqs) is torch.Tensor


# ---------------------------------------------------------------------------
# Free and harmless.
# ---------------------------------------------------------------------------


def test_telemetry_on_off_parity(world):
    reqs = _reqs(6)
    off = _engine(world)
    out_off = off.run(reqs)
    on = _engine(world, device_telemetry=True)
    out_on = on.run(reqs)
    assert [list(a) for a in out_on] == [list(b) for b in out_off]
    assert all(r.status == OK for r in out_on)
    assert on.compile_cache_sizes() == off.compile_cache_sizes() == \
        {"tick": 1, "chunk": 1, "set_row": 1}
    assert on.metrics.counter("serve.retrace").value == 0
    snap = on.metrics_snapshot()
    assert "device" in snap
    assert "device" not in off.metrics_snapshot()
    assert snap["counters"]["device.h2d_bytes"] > 0
    assert snap["counters"]["device.d2h_bytes"] > 0
    assert snap["device"]["win"]["h2d_bytes"] > 0
    assert snap["device"]["ticks"] == on.step_index
    assert "device:" in on.state_dump()
    assert "device:" not in off.state_dump()


def test_retrace_counted_at_no_compile_cost(world):
    eng = _engine(world, device_telemetry=True)
    out = eng.run(_reqs(3))
    assert all(r.status == OK for r in out)
    assert eng.device_telemetry.retraces == 0
    compiles0 = eng.metrics.counter("device.compiles").value
    # a second signature: an int32 row where the engine uploads int64
    eng._set_row(eng.pcache, 0,
                 torch.zeros(eng.blocks_per_slot, dtype=torch.int32), 0)
    eng.step()
    assert eng.metrics.counter("serve.retrace").value == 1
    assert eng.device_telemetry.retraces == 1
    assert eng.device_telemetry.retrace_compile_est_s == 0.0
    assert eng.metrics.counter("device.compiles").value == compiles0 + 1
    assert eng.device_telemetry.report()["retraces"] == 1


# ---------------------------------------------------------------------------
# Honest MFU.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("source", ["arg", "env"])
def test_mfu_arithmetic_with_pinned_peak(world, monkeypatch, source):
    reg = MetricsRegistry(event_log=None)
    peak = 1e15
    if source == "env":
        monkeypatch.setenv("HVD_TORCH_PEAK_FLOPS", str(peak))
        dtel = True
    else:
        dtel = DeviceTelemetry(reg, peak_flops=peak)
    eng = _engine(world, metrics=reg, device_telemetry=dtel)
    out = eng.run(_reqs(5))
    assert all(r.status == OK for r in out)
    rep = eng.device_telemetry.report()
    assert rep["peak_flops"] == peak
    assert rep["peak_flops_source"] == source and rep["peak_flops_known"]
    w = rep["win"]
    assert w["n"] > 0 and w["elapsed_s"] > 0.0 and w["flops"] > 0.0
    assert w["mfu"] == pytest.approx(
        w["flops"] / w["elapsed_s"] / peak, rel=1e-12)
    assert w["flops_per_s"] == pytest.approx(
        w["flops"] / w["elapsed_s"], rel=1e-12)
    snap = reg.snapshot()
    assert snap["gauges"]["serve.mfu"] == pytest.approx(w["mfu"])
    assert snap["gauges"]["device.peak_flops_known"] == 1
    assert snap["gauges"]["serve.arithmetic_intensity"] == \
        pytest.approx(w["flops"] / w["bytes_accessed"])
    assert w["compute_est_s"] + w["host_stall_s"] == pytest.approx(
        w["sync_s"], rel=1e-9)
    assert w["host_stall_s"] >= 0.0
    assert 0.0 <= w["overlap_headroom_pct"] <= 100.0 + 1e-9


def test_sync_split_degenerates_without_peak():
    t = DeviceTelemetry(MetricsRegistry(event_log=None), device="cpu")
    assert not t.peak_flops_known
    t.programs["tick"] = {"flops": 1e9, "bytes_accessed": 1.0,
                          "compile_s": 0.0, "dispatches": 0}
    est, stall = t.on_sync("tick", 0.0, 0.5)
    assert est == 0.5 and stall == 0.0
    t2 = DeviceTelemetry(MetricsRegistry(event_log=None),
                         peak_flops=1e10)
    t2.programs["tick"] = {"flops": 1e9, "bytes_accessed": 1.0,
                           "compile_s": 0.0, "dispatches": 0}
    est, stall = t2.on_sync("tick", 0.0, 0.5)
    assert est == pytest.approx(0.1) and stall == pytest.approx(0.4)
    est, stall = t2.on_sync("tick", 0.0, 0.01)   # wait < prediction
    assert est == pytest.approx(0.01) and stall == 0.0


def test_heavy_first_step_is_timed_in_the_window():
    """The window clock starts with the first step, so a heavy first step
    counts its time beside its FLOPs and the MFU is not inflated."""
    peak = 1e12
    reg = MetricsRegistry(event_log=None)
    t = DeviceTelemetry(reg, peak_flops=peak)
    for name, flops in (("chunk", 1e12), ("tick", 1e6)):
        t.programs[name] = {"flops": flops, "bytes_accessed": 1.0,
                            "compile_s": 0.0, "dispatches": 0}
    t0 = time.perf_counter()
    for step, name in enumerate(("chunk", "tick")):
        t.start()
        t.dispatch(name)
        time.sleep(0.05)
        t.on_step(step)
        if step == 0:
            # minted by the first step already: its time is known
            first = reg.snapshot()["gauges"]["serve.mfu"]
            assert first == pytest.approx(
                1e12 / t._ring[0]["dt_s"] / peak, rel=1e-12)
    wall = time.perf_counter() - t0
    w = t.report()["win"]
    assert [r["dt_s"] > 0.04 for r in t._ring] == [True, True]
    assert 0.1 <= w["elapsed_s"] <= wall
    assert w["mfu"] == pytest.approx((1e12 + 1e6) / w["elapsed_s"] / peak,
                                     rel=1e-12)
    assert w["mfu"] <= (1e12 + 1e6) / 0.1 / peak
    assert reg.snapshot()["gauges"]["serve.mfu"] == pytest.approx(w["mfu"])


def test_engine_times_its_first_step(world):
    eng = _engine(world, device_telemetry=DeviceTelemetry(
        MetricsRegistry(event_log=None), peak_flops=1e15))
    t0 = time.perf_counter()
    assert all(r.status == OK for r in eng.run(_reqs(3)))
    wall = time.perf_counter() - t0
    ring = list(eng.device_telemetry._ring)
    assert ring[0]["flops"] > 0.0 and ring[0]["dt_s"] > 0.0
    assert 0.0 < eng.device_telemetry.report()["win"]["elapsed_s"] <= wall


# ---------------------------------------------------------------------------
# The CPU: absent, never zero.
# ---------------------------------------------------------------------------


def test_cpu_degradation_absent_not_zero(world):
    eng = _engine(world, device_telemetry=True)
    out = eng.run(_reqs(4))
    assert all(r.status == OK for r in out)
    rep = eng.metrics_snapshot()["device"]
    assert rep["platform"] == "cpu"
    assert rep["memory"] == {"available": False}
    assert rep["peak_flops"] is None and not rep["peak_flops_known"]
    assert rep["win"]["mfu"] is None
    assert "reconciliation" not in rep
    gauges = eng.metrics.snapshot()["gauges"]
    assert "serve.mfu" not in gauges
    assert "device.bytes_in_use" not in gauges
    assert "device.peak_bytes_in_use" not in gauges
    assert "device.hbm_used_fraction" not in gauges
    assert gauges["device.peak_flops_known"] == 0
    assert "device.overlap_headroom_pct" in gauges
    assert eng.device_telemetry.poll_memory() is None
    # the model-side bytes are exact even where memory is not polled
    tel = eng.device_telemetry
    assert tel.param_bytes == sum(
        x.numel() * x.element_size()
        for x in torch.utils._pytree.tree_leaves(world.tp))
    assert tel.kv_total_bytes == eng.memory_report()["kv"]["total_bytes"]


def test_report_reconciles_hbm_when_available():
    rep = build_report(
        platform="cuda", device_kind="NVIDIA H100 80GB HBM3", n_devices=1,
        peak_flops=989e12, peak_flops_known=True, peak_source="table",
        programs={}, compiles=0, compile_total_s=0.0, retraces=0,
        retrace_compile_est_s=0.0, ticks=0, window=256, ring=[],
        memory={"available": True, "bytes_in_use": 1000,
                "peak_bytes_in_use": 1200, "bytes_limit": 2000},
        param_bytes=600, kv_total_bytes=300)
    rec = rep["reconciliation"]
    assert rec["model_bytes"] == 900
    assert rec["framework_overhead_bytes"] == 100
    assert rep["win"]["mfu"] is None


def test_report_schema_equals_the_jax_planes(world):
    """The same requests through both engines with telemetry on: the
    reports and their window and program rows carry the same keys."""
    jreg = jmetrics.MetricsRegistry(event_log=None)
    jeng = JaxEngine(world.jp, world.jcfg, n_slots=2, max_len=32, chunk=8,
                     metrics=jreg, monitor=False, device_telemetry=True)
    jeng.run([JRequest(prompt=list(r.prompt), max_new_tokens=4)
              for r in _reqs(3)])
    eng = _engine(world, device_telemetry=True)
    eng.run(_reqs(3))
    want, got = jeng.device.report(), eng.device_telemetry.report()
    assert set(got) == set(want)
    assert set(got["win"]) == set(want["win"])
    assert set(got["programs"]) == set(want["programs"])
    for name, row in want["programs"].items():
        assert set(got["programs"][name]) == set(row)
        assert got["programs"][name]["dispatches"] == row["dispatches"]
    assert got["win"]["dispatches"] == want["win"]["dispatches"]
    assert got["ticks"] == want["ticks"]
    assert got["compiles"] == want["compiles"]


# ---------------------------------------------------------------------------
# The serving surface.
# ---------------------------------------------------------------------------


def test_device_endpoint_over_socket(world):
    eng = _engine(world, device_telemetry=True)
    mon = MonitorServer(eng.metrics, eng, port=0).start()
    try:
        eng.run(_reqs(3))
        url = f"http://{mon.host}:{mon.port}/device"
        with urllib.request.urlopen(url, timeout=5) as r:
            assert r.status == 200
            assert r.headers["Content-Type"] == "application/json"
            rep = json.loads(r.read())
        assert rep["ticks"] == eng.device_telemetry.report()["ticks"]
        assert set(rep["programs"]) == {"tick", "chunk", "set_row"}
    finally:
        mon.stop()
    off = _engine(world)
    mon = MonitorServer(off.metrics, off, port=0).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(
                f"http://{mon.host}:{mon.port}/device", timeout=5)
        assert exc.value.code == 404
        assert b"HVD_TORCH_DEVICE_TELEMETRY" in exc.value.read()
    finally:
        mon.stop()


def test_event_log_replay_matches_live_report(world, tmp_path):
    log = str(tmp_path / "events.jsonl")
    reg = MetricsRegistry(event_log=metrics_mod.EventLog(log))
    eng = _engine(world, metrics=reg, device_telemetry=True)
    eng.run(_reqs(4))
    live = eng.device_telemetry.report()
    records = [json.loads(ln) for ln in open(log)]
    replay = report_from_events(records)
    assert replay["platform"] == live["platform"]
    assert replay["device_kind"] == live["device_kind"]
    assert replay["ticks"] == live["ticks"]
    assert set(replay["programs"]) == set(live["programs"])
    for name, row in live["programs"].items():
        rrow = replay["programs"][name]
        assert rrow["flops"] == row["flops"]
        assert rrow["bytes_accessed"] == row["bytes_accessed"]
        assert rrow["dispatches"] == row["dispatches"]
    for k in ("n", "flops", "bytes_accessed", "h2d_bytes", "d2h_bytes",
              "dispatches"):
        assert replay["win"][k] == live["win"][k]
    for k in ("elapsed_s", "sync_s", "compute_est_s", "host_stall_s"):
        assert replay["win"][k] == pytest.approx(live["win"][k],
                                                 rel=1e-9)
    assert replay["win"]["mfu"] is None is live["win"]["mfu"]
    tail = report_from_events(records, window=2)
    assert tail["win"]["n"] == 2


def test_sync_split_feeds_nested_profiler_phases(world):
    eng = _engine(world, profile=True, device_telemetry=True)
    out = eng.run(_reqs(4))
    assert all(r.status == OK for r in out)
    rep = eng.prof.report()
    assert rep["phases"]["device_sync.compute_est"]["count"] > 0
    split = (rep["phases"]["device_sync.compute_est"]["total_s"]
             + rep["phases"]["device_sync.host_stall"]["total_s"])
    assert split == pytest.approx(
        eng.device_telemetry.report()["win"]["sync_s"], rel=1e-6)
    assert 0.0 < split <= rep["phases"]["device_sync"]["total_s"]
    assert rep["phases"]["device_sync.host_stall"]["total_s"] == 0.0
    assert 0.9 <= rep["coverage"] <= 1.0 + 1e-9


# ---------------------------------------------------------------------------
# The HBM exhaustion alert rule, against the JAX plane on one clock.
# ---------------------------------------------------------------------------


def _hbm_rule(metrics, ts_mod, alerts_mod):
    rules = [r for r in alerts_mod.ALERT_RULES
             if r["name"] == "device_hbm_exhaustion"]
    reg = metrics.MetricsRegistry(event_log=None)
    clk = Clock(0.0)
    s = ts_mod.MetricsSampler(reg, sample_s=1.0, clock=clk)
    am = alerts_mod.AlertManager(s, rules=rules, registry=reg,
                                 time_scale=0.1, clock=clk)
    g = reg.gauge("device.hbm_used_fraction")
    seen = []
    for v in [0.5] * 4 + [0.97] * 5 + [0.5] * 10:
        clk.t += 1.0
        g.set(v)
        s.tick()
        am.tick()
        seen.append(am.firing())
    return seen, am.report()


def test_device_hbm_exhaustion_rule_fires_and_resolves():
    seen, rep = _hbm_rule(metrics_mod, tts, talerts)
    assert (seen, rep) == _hbm_rule(jmetrics, jts, jalerts)
    assert ["device_hbm_exhaustion"] in seen and seen[-1] == []
    (rule,) = rep["rules"]
    assert rule["fired"] == 1 and rule["resolved"] == 1


def test_counted_bytes_cover_the_pool_reads():
    """The byte count of one matrix product is its operands and result,
    and a view costs nothing."""
    a, b = torch.ones(64, 32), torch.ones(32, 16)
    flops, nbytes = dt_mod.count_cost(lambda x, y: x.t().t() @ y, a, b)
    assert flops == 2 * 64 * 32 * 16
    assert nbytes == 4 * (64 * 32 + 32 * 16 + 64 * 16)
    # the real arguments are never written
    flops, _ = dt_mod.count_cost(lambda x: x.add_(1.0), a)
    assert flops == 0.0 and torch.equal(a, torch.ones(64, 32))
