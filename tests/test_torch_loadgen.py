"""The port's open-loop load harness (``horovod_tpu_torch/loadgen.py``).

Mirrors ``tests/test_loadgen.py`` case for case on the port's modules and
engines (``llama_tiny`` in f32, the JAX weights carried over), and holds
the pure parts to the JAX module: at the same seeds the arrival times,
request mixes, schedules, digests and percentiles are equal bit for bit
(both draw from stdlib ``random`` keyed by strings).  No assertion waits
on a wall-clock limit; the drivers run on a ``VirtualClock``.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import sys
import time

import pytest

from horovod_tpu import loadgen as jloadgen
from horovod_tpu_torch import tracing
from horovod_tpu_torch.loadgen import (
    ATTR_PHASES, Bursty, DEFAULT_TENANTS, FixedRate, Poisson,
    RequestMix, TenantSpec, VirtualClock, WallClock, attribute,
    build_schedule, measure_saturation, percentile, resolve_process,
    run_open_loop, schedule_digest, summarize_rung,
)
from horovod_tpu_torch.metrics import MetricsRegistry
from horovod_tpu_torch.router import RouterServer
from horovod_tpu_torch.serving import OK, REJECTED, Request
from horovod_tpu_torch.serving_scheduler import ServeEngine
from torch_engine_twin import tiny_world

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

pytestmark = pytest.mark.load


@pytest.fixture(scope="module")
def world():
    return tiny_world()


def _engines(world, n, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", 96)
    kw.setdefault("chunk", 8)
    kw.setdefault("prefix_cache", True)
    return [ServeEngine(world.tp, world.tcfg, **kw) for _ in range(n)]


def _same_as_jax(sched, jsched) -> None:
    assert len(sched) == len(jsched)
    for a, b in zip(sched, jsched):
        assert (a.t, a.tenant, a.poison, a.req.prompt, a.req.max_new_tokens,
                a.req.slo_s, a.req.deadline_s) == (
            b.t, b.tenant, b.poison, b.req.prompt, b.req.max_new_tokens,
            b.req.slo_s, b.req.deadline_s)
    assert schedule_digest(sched) == jloadgen.schedule_digest(jsched)


# -- arrival processes: pure, seeded, no engine ------------------------------


def test_fixed_rate_is_evenly_spaced():
    ts = FixedRate(10.0).times(1.0)
    assert len(ts) == 10
    assert ts == tuple(i / 10.0 for i in range(10))
    assert all(b > a for a, b in zip(ts, ts[1:]))
    assert ts == jloadgen.FixedRate(10.0).times(1.0)


def test_poisson_is_deterministic_and_rate_accurate():
    a = Poisson(50.0, seed=7).times(20.0)
    b = Poisson(50.0, seed=7).times(20.0)
    assert a == b                       # pure function of (rate, seed)
    assert a != Poisson(50.0, seed=8).times(20.0)
    assert all(0.0 <= t < 20.0 for t in a)
    assert all(y > x for x, y in zip(a, a[1:]))
    assert len(a) == pytest.approx(50.0 * 20.0, rel=0.15)
    assert a == jloadgen.Poisson(50.0, seed=7).times(20.0)


def test_bursty_same_mean_rate_but_clumpier():
    dur, rate = 60.0, 40.0
    p = Poisson(rate, seed=3).times(dur)
    q = Bursty(rate, seed=3).times(dur)
    assert q == Bursty(rate, seed=3).times(dur)
    assert q == jloadgen.Bursty(rate, seed=3).times(dur)
    assert len(q) == pytest.approx(rate * dur, rel=0.2)

    def dispersion(ts, bin_s=0.25):
        counts = [0] * int(dur / bin_s)
        for t in ts:
            counts[min(int(t / bin_s), len(counts) - 1)] += 1
        m = statistics.mean(counts)
        return statistics.pvariance(counts) / m if m else 0.0

    assert dispersion(q) > dispersion(p) + 0.5


def test_resolve_process_names_and_errors():
    assert isinstance(resolve_process("poisson", 5.0, 1), Poisson)
    assert isinstance(resolve_process("bursty", 5.0, 1), Bursty)
    assert isinstance(resolve_process("fixed", 5.0, 1), FixedRate)
    inst = Poisson(2.0, 0)
    assert resolve_process(inst, 99.0) is inst   # passthrough
    with pytest.raises(ValueError, match="unknown arrival process"):
        resolve_process("lognormal", 5.0, 1)
    with pytest.raises(ValueError):
        Poisson(0.0)


# -- request mixes + schedules ----------------------------------------------


def test_schedule_is_bit_reproducible():
    mix = RequestMix(DEFAULT_TENANTS, seed=5)
    proc = Poisson(30.0, seed=9)
    s1 = build_schedule(proc, mix, 2.0, seed=9)
    s2 = build_schedule(Poisson(30.0, seed=9),
                        RequestMix(DEFAULT_TENANTS, seed=5), 2.0, seed=9)
    assert schedule_digest(s1) == schedule_digest(s2)
    assert [a.req.prompt for a in s1] == [a.req.prompt for a in s2]
    assert schedule_digest(s1) != schedule_digest(
        build_schedule(proc, mix, 2.0, seed=10))


@pytest.mark.parametrize("process", ["poisson", "bursty", "fixed"])
@pytest.mark.parametrize("seed", [0, 5, 1234])
def test_schedules_equal_the_jax_module(process, seed):
    """The default mix (and a poisoned one) through each process: the
    port's schedule is the JAX module's, arrival for arrival."""
    for tenants, jtenants in (
            (DEFAULT_TENANTS, jloadgen.DEFAULT_TENANTS),
            ((TenantSpec("risky", poison=0.3, prompt_len=(2, 6),
                         new_tokens=(2, 5), slo_s=1.0),),
             (jloadgen.TenantSpec("risky", poison=0.3, prompt_len=(2, 6),
                                  new_tokens=(2, 5), slo_s=1.0),))):
        sched = build_schedule(resolve_process(process, 40.0, seed),
                               RequestMix(tenants, seed), 1.5, seed)
        jsched = jloadgen.build_schedule(
            jloadgen.resolve_process(process, 40.0, seed),
            jloadgen.RequestMix(jtenants, seed), 1.5, seed)
        assert sched
        _same_as_jax(sched, jsched)


def test_mix_respects_weights_prefixes_and_slos():
    tenants = (TenantSpec("hot", weight=3.0, prompt_len=(2, 4),
                          new_tokens=(2, 4), shared_prefixes=3,
                          prefix_len=8, slo_s=1.5),
               TenantSpec("cold", weight=1.0, prompt_len=(5, 9),
                          new_tokens=(2, 4)))
    mix = RequestMix(tenants, seed=2)
    sched = build_schedule(FixedRate(400.0), mix, 1.0, seed=2)
    hot = [a for a in sched if a.tenant == "hot"]
    cold = [a for a in sched if a.tenant == "cold"]
    assert len(hot) / len(sched) == pytest.approx(0.75, abs=0.08)
    heads = {tuple(a.req.prompt[:8]) for a in hot}
    assert len(heads) == 3
    assert all(a.req.slo_s == 1.5 for a in hot)
    assert all(a.req.slo_s is None for a in cold)
    assert all(8 + 2 <= len(a.req.prompt) <= 8 + 4 for a in hot)
    assert all(5 <= len(a.req.prompt) <= 9 for a in cold)
    jmix = jloadgen.RequestMix(
        tuple(jloadgen.TenantSpec(**vars(t)) for t in tenants), seed=2)
    assert mix._corpus == jmix._corpus


def test_poison_blend_marks_malformed_requests():
    tenants = (TenantSpec("risky", poison=0.5, prompt_len=(2, 4),
                          new_tokens=(2, 3)),)
    sched = build_schedule(FixedRate(200.0), RequestMix(tenants, seed=4),
                           1.0, seed=4)
    poisoned = [a for a in sched if a.poison]
    assert 0.3 < len(poisoned) / len(sched) < 0.7
    assert all(a.req.prompt == [] for a in poisoned)
    assert all(a.req.prompt for a in sched if not a.poison)


# -- clocks + exact percentiles ---------------------------------------------


def test_virtual_clock_never_sleeps():
    clk = VirtualClock()
    clk.start()
    for i in range(1000):
        clk.sleep_until(i * 10.0)
    assert clk.now() == 9990.0
    clk.sleep_until(5.0)                # never goes backwards
    assert clk.now() == 9990.0


def test_wall_clock_sleeps_to_offset():
    clk = WallClock()
    clk.start()
    t0 = time.monotonic()
    clk.sleep_until(0.05)
    assert time.monotonic() - t0 >= 0.045
    assert clk.now() >= 0.05


def test_percentile_exact_samples():
    assert percentile([], 0.99) == 0.0
    assert percentile([7.0], 0.5) == 7.0
    vals = [1.0, 2.0, 3.0, 4.0]
    assert percentile(vals, 0.0) == 1.0
    assert percentile(vals, 1.0) == 4.0
    assert percentile(vals, 0.5) == pytest.approx(2.5)
    assert percentile(list(range(101)), 0.99) == pytest.approx(99.0)
    import random
    rng = random.Random(3)
    for n in (2, 3, 17, 100):
        xs = [rng.random() for _ in range(n)]
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            assert percentile(xs, q) == jloadgen.percentile(xs, q)


# -- open-loop driver against a real routed fleet ----------------------------


def test_open_loop_drive_traces_poison_and_reply_shape(world):
    """One 2-replica port fleet, three oracles: (a) every record's phase
    split tiles its client e2e; (b) a poison blend is contained to its
    tenant; (c) the ``/v1/generate`` reply body carries the merged trace
    and the ``router.*`` span histograms observed every request.  The
    tokens of the OK requests equal the port's solo engine's."""
    engines = _engines(world, 2)
    router = RouterServer(engines, policy="least_loaded")
    try:
        mix = RequestMix(DEFAULT_TENANTS, seed=1, vocab_hi=60)
        sched = build_schedule(Poisson(40.0, seed=1), mix, 0.25, seed=1)
        records = run_open_loop(router, sched, clock=VirtualClock(),
                                timeout_s=120.0)
        assert len(records) == len(sched)
        assert all(r["status"] == OK for r in records)
        for r in records:
            assert set(r["attr"]) == set(ATTR_PHASES)
            tiled = sum(v for v in r["attr"].values() if v is not None)
            assert tiled == pytest.approx(r["e2e_s"], rel=0.05)
            assert r["ttft_s"] is not None and r["ttft_s"] <= r["e2e_s"]
        summary = attribute(records)
        assert summary["n"] == len(records)
        assert summary["coverage"] == pytest.approx(1.0, abs=0.05)
        solo = _engines(world, 1, sampler=False)[0].run(
            [Request(prompt=list(a.req.prompt),
                     max_new_tokens=a.req.max_new_tokens) for a in sched])
        assert [r["n_tokens"] for r in records] == [len(s) for s in solo]

        tenants = (TenantSpec("ok", weight=1.0, prompt_len=(2, 5),
                              new_tokens=(2, 4)),
                   TenantSpec("bad", weight=1.0, poison=1.0),)
        sched2 = build_schedule(FixedRate(40.0), RequestMix(tenants, 3),
                                0.25, seed=3)
        by: dict[str, list] = {}
        for r in run_open_loop(router, sched2, clock=VirtualClock(),
                               timeout_s=120.0):
            by.setdefault(r["tenant"], []).append(r)
        assert all(r["status"] == REJECTED for r in by["bad"])
        assert all(r["status"] == OK for r in by["ok"])

        code, body = router.handle_generate(
            Request(prompt=[5, 6, 7], max_new_tokens=3))
        assert code == 200 and body["status"] == OK
        tr = body["trace"]
        rt = tr["router"]
        assert rt["failovers"] == 0 and rt["shed"] is None
        assert rt["accept_to_submit_s"] >= 0.0
        assert rt["route_decision_s"] >= 0.0
        assert rt["e2e_s"] >= tr["ttft_s"] >= 0.0
        assert rt["replica_queue_s"] >= 0.0
        assert rt["recv_ts"] <= rt["submit_ts"] <= rt["done_ts"]
        json.dumps(body)

        rid = router.route(Request(prompt=[9, 8, 7], max_new_tokens=2))
        assert router.result(rid, timeout=120.0) is not None
        assert router.request_trace(rid)["status"] == OK
        with pytest.raises(KeyError):
            router.request_trace(rid + 999)
        hists = router.metrics.snapshot()["histograms"]
        for name in ("router.route_decision_s", "router.admission_s",
                     "router.journal_append_s", "router.e2e_s",
                     "router.failover_hops", "router.replica_queue_s"):
            assert name in hists, name
        for name in ("router.route_decision_s", "router.admission_s",
                     "router.e2e_s", "router.failover_hops",
                     "router.replica_queue_s"):
            assert hists[name]["count"] >= 1, name
    finally:
        router.stop()


# -- the saturation sweep ----------------------------------------------------


@pytest.fixture(scope="module")
def sweep_pair(world):
    """Two identical 2-rung sweeps of the port (the reproducibility
    witness), shared by every sweep-consuming test."""

    def _sweep():
        return measure_saturation(
            world.tp, world.tcfg, seed=6, ladder=(16.0, 96.0),
            duration_s=0.2, n_replicas=2, n_slots=2, chunk=8,
            clock=VirtualClock(), timeout_s=120.0)

    return _sweep(), _sweep()


def test_measure_saturation_schema_and_reproducibility(sweep_pair):
    r1, r2 = sweep_pair
    assert [x["schedule_digest"] for x in r1["rungs"]] == \
        [x["schedule_digest"] for x in r2["rungs"]]
    assert [x["n"] for x in r1["rungs"]] == [x["n"] for x in r2["rungs"]]
    assert r1["serve_load_rungs"] == 2
    assert r1["serve_load_requests"] == sum(x["n"] for x in r1["rungs"])
    assert 0 <= r1["knee_index"] < 2
    knee = r1["rungs"][r1["knee_index"]]
    assert r1["serve_load_knee_rps"] == knee["offered_rps"]
    assert knee["goodput_rps"] == max(
        x["goodput_rps"] for x in r1["rungs"])
    for rung in r1["rungs"]:
        assert rung["ok_rate"] == 1.0
        assert set(rung["attribution"]["phases"]) == set(ATTR_PHASES)
    assert r1["serve_load_attr_coverage_knee"] >= 0.9
    json.dumps(r1)


def test_rung_seeds_differ_per_rung_and_per_sweep_seed(sweep_pair):
    r1, _ = sweep_pair
    digests = [x["schedule_digest"] for x in r1["rungs"]]
    assert len(set(digests)) == len(digests)
    mix = RequestMix(DEFAULT_TENANTS, 6)
    s6 = build_schedule(Poisson(16.0, 6 * 8191 + 1000003), mix, 0.2,
                        6 * 8191 + 1000003)
    s7 = build_schedule(Poisson(16.0, 7 * 8191 + 1000003), mix, 0.2,
                        7 * 8191 + 1000003)
    assert digests[0] == schedule_digest(s6)
    assert schedule_digest(s6) != schedule_digest(s7)


def test_sweep_digests_equal_the_jax_rebuilt_schedules(sweep_pair):
    """Every rung's digest equals the JAX module's schedule rebuilt from
    the same seed, rung index, rate and duration: the same offered
    workload in both packages (the ``serve load`` card phase pins its
    own rungs the same way)."""
    r1, _ = sweep_pair
    jmix = jloadgen.RequestMix(jloadgen.DEFAULT_TENANTS, 6)
    for i, rung in enumerate(r1["rungs"]):
        rs = 6 * 8191 + 1000003 * (i + 1)
        jsched = jloadgen.build_schedule(
            jloadgen.resolve_process("poisson", rung["offered_rps"], rs),
            jmix, 0.2, rs)
        assert rung["schedule_digest"] == jloadgen.schedule_digest(jsched)
        assert rung["n"] == len(jsched)


def test_summarize_rung_counts_lost_as_timeout():
    recs = [
        {"status": OK, "good": True, "e2e_s": 0.05, "ttft_s": 0.01,
         "tpot_s": 0.002, "sched_t": 0.0, "n_tokens": 4, "attr": None},
        {"status": "LOST", "good": False, "e2e_s": None, "ttft_s": None,
         "tpot_s": None, "sched_t": 0.1, "n_tokens": 0, "attr": None},
    ]
    rung = summarize_rung(recs, offered_rps=2.0, duration_s=1.0)
    assert rung["timeout_rate"] == 0.5
    assert rung["ok_rate"] == 0.5
    assert rung["p99_ttft_s"] == 0.01
    assert rung == jloadgen.summarize_rung(recs, offered_rps=2.0,
                                           duration_s=1.0)


# -- tools/load_report.py reads the port's report ----------------------------


def test_load_report_render_and_compare_gate(sweep_pair, tmp_path, capsys):
    from tools.load_report import compare_reports, load_report, main, render
    report, _ = sweep_pair
    old = tmp_path / "old.json"
    old.write_text(json.dumps(report))
    text = render(load_report(str(old)))
    assert "saturation sweep" in text and "<< knee" in text
    for phase in ATTR_PHASES:
        assert phase in text

    assert main([str(old)]) == 0
    capsys.readouterr()
    assert main(["--compare", str(old), str(old)]) == 0
    capsys.readouterr()

    worse = json.loads(json.dumps(report))
    worse["serve_load_knee_goodput_rps"] *= 0.5
    for rung in worse["rungs"]:
        rung["p99_ttft_s"] = rung["p99_ttft_s"] * 3 + 0.05
    new = tmp_path / "new.json"
    new.write_text(json.dumps(worse))
    rows = compare_reports(report, worse)
    assert any(r["regressed"] for r in rows)
    assert main(["--compare", str(old), str(new)]) == 1
    out = capsys.readouterr().out
    assert "REGRESSED" in out
    assert main(["--compare", str(new), str(old)]) == 0
    capsys.readouterr()


# -- tracing: trace ids on records, exemplars at the knee --------------------


def test_loadgen_stamps_trace_ids_and_rung_exemplars(world, monkeypatch):
    """The port twin of ``tests/test_tracing.py``'s loadgen case."""
    monkeypatch.setenv("HVD_TORCH_TRACE_SAMPLE", "1")
    monkeypatch.setenv("HVD_TORCH_TRACE_SEED", "3")
    router = RouterServer(
        _engines(world, 1, metrics=MetricsRegistry(event_log=None),
                 sampler=False, max_len=128),
        policy="round_robin", sampler=False)
    try:
        mix = RequestMix(DEFAULT_TENANTS, seed=2, vocab_hi=60)
        sched = build_schedule(FixedRate(20.0), mix, 0.25, seed=2)
        records = run_open_loop(router, sched, clock=VirtualClock(),
                                timeout_s=120.0)
        assert records
        assert all(isinstance(r["trace_id"], str) and r["trace_id"]
                   for r in records)
        for idx, (a, r) in enumerate(zip(sched, records)):
            assert r["trace_id"] == tracing.trace_id_for(
                f"client:{idx}:{a.t!r}:{a.tenant}", 3)
        ring = router.tracer.recent()
        assert sum(s["name"] == "client" for s in ring) == len(records)
    finally:
        router.stop()

    rung = summarize_rung(records, offered_rps=20.0, duration_s=0.25)
    ex = rung["exemplar_trace_ids"]
    assert 1 <= len(ex) <= 3
    ranked = sorted((r for r in records if r["e2e_s"] is not None),
                    key=lambda r: r["e2e_s"], reverse=True)
    assert ex == [r["trace_id"] for r in ranked[:len(ex)]]

    from tools import load_report
    fake = {"rungs": [rung], "knee_index": 0,
            "knee_exemplar_trace_ids": ex}
    text = load_report.render(fake)
    assert "knee exemplar traces" in text
    assert ex[0] in text
