"""The port's fleet-scale simulation (``horovod_tpu_torch/simfleet.py``).

Mirrors ``tests/test_simfleet.py`` on the port's router, supervisor,
autoscaler and alert plane: ``SimReplica``'s latency and chaos model, the
virtual-time driver, and the chaos-at-scale campaign.  The campaign runs
no framework code, so the oracle is exact: at the same seed and scale the
port's ``run_sim_campaign`` report equals the JAX module's field for
field, wall-clock fields aside.  The fleet-scale case runs here at 20
replicas × 5,000 requests; the full 200 × 100,000 runs in
``chip_smoke.py``'s ``fleet simfleet``.  No assertion waits on a
wall-clock limit.
"""

from __future__ import annotations

import time

import pytest

from horovod_tpu import simfleet as jsimfleet
from horovod_tpu_torch.router import RouterServer
from horovod_tpu_torch.serving import OK, REJECTED, Request
from horovod_tpu_torch.simfleet import (
    PhaseProfile, SimClock, SimFleet, SimReplica, crash_storm,
    measure_poll_scaling, run_sim_campaign, sim_tokens)

pytestmark = pytest.mark.sim


def _req(prompt_len=8, new=4, **kw):
    return Request(prompt=list(range(1, prompt_len + 1)),
                   max_new_tokens=new, **kw)


# ---------------------------------------------------------------------------
# SimReplica: the latency model behind the real handle interface.
# ---------------------------------------------------------------------------


def test_sim_replica_serves_deterministic_tokens():
    clk = SimClock()
    r = SimReplica("s0", clk, seed=3)
    got = []
    req = _req()
    r.submit(req, got.append)
    assert got == []                      # queued, not served yet
    clk.advance(10.0)
    assert r.advance_to(clk()) == 1
    assert got[0].status == OK
    assert list(got[0]) == sim_tokens(req)
    # A twin replica (same seed, different name) replays the same
    # request to the same bits — the failover-replay contract.
    clk2 = SimClock()
    twin = SimReplica("s1", clk2, seed=3)
    got2 = []
    twin.submit(req, got2.append)
    clk2.advance(10.0)
    twin.advance_to(clk2())
    assert list(got2[0]) == list(got[0])


def test_sim_replica_jitter_is_seeded_per_replica():
    def finish_time(name, seed):
        clk = SimClock()
        r = SimReplica(name, clk, seed=seed)
        r.submit(_req(), lambda res: None)
        return r._running[0][0]

    assert finish_time("a", 1) == finish_time("a", 1)
    assert finish_time("a", 1) != finish_time("b", 1)


def test_sim_replica_poison_and_dead_on_arrival():
    clk = SimClock()
    r = SimReplica("s0", clk, seed=0)
    got = []
    r.submit(Request(prompt=[], max_new_tokens=4), got.append)
    assert got and got[0].status == REJECTED   # poison: load-shed
    r.kill()
    r.submit(_req(), got.append)
    assert got[1] is None                      # dead: failover signal
    r.kill()                                   # idempotent


def test_sim_replica_kill_fails_over_everything_aboard():
    clk = SimClock()
    r = SimReplica("s0", clk, seed=0, n_slots=2)
    got = []
    for _ in range(5):                      # 2 running + 3 queued
        r.submit(_req(), got.append)
    assert got == []
    r.kill()
    assert got == [None] * 5


def test_sim_replica_kv_pressure_and_leak():
    clk = SimClock()
    # 4 blocks of 16 tokens: one 33-token request takes 3 blocks, so
    # a second one must wait for the first to free them.
    r = SimReplica("s0", clk, seed=0, n_slots=4, kv_blocks=4,
                   tokens_per_block=16)
    got = []
    r.submit(_req(prompt_len=30, new=3), got.append)
    r.submit(_req(prompt_len=30, new=3), got.append)
    assert len(r._running) == 1 and len(r._queue) == 1
    clk.advance(10.0)
    r.advance_to(clk())                     # first frees, second admits
    assert len(got) == 1 and len(r._running) == 1
    clk.advance(10.0)
    r.advance_to(clk())
    assert len(got) == 2
    # A leak swallows capacity until healed.
    assert r.leak_kv(0.9) == 3
    r.submit(_req(prompt_len=30, new=3), got.append)
    clk.advance(10.0)
    r.advance_to(clk())
    assert len(got) == 2                    # starved by the leak
    r.heal_kv()
    r.advance_to(clk())
    clk.advance(10.0)
    r.advance_to(clk())
    assert len(got) == 3


def test_sim_replica_straggler_and_slow_start():
    clk = SimClock()
    fast = SimReplica("f", clk, seed=0, jitter=0.0)
    slow = SimReplica("s", clk, seed=0, jitter=0.0)
    slow.set_slow(8.0)
    fast.submit(_req(), lambda r: None)
    slow.submit(_req(), lambda r: None)
    assert slow._running[0][0] == pytest.approx(
        8.0 * fast._running[0][0])
    assert slow.probe()["goodput"] == pytest.approx(1 / 8.0)
    warm = SimReplica("w", clk, seed=0, jitter=0.0, slow_start_s=5.0)
    warm.submit(_req(), lambda r: None)
    assert warm._running[0][0] == pytest.approx(
        3.0 * fast._running[0][0])          # default 3x while warming


# ---------------------------------------------------------------------------
# The clock seam and the poller's fleet instrumentation.
# ---------------------------------------------------------------------------


def test_router_default_clock_is_wall():
    clk = SimClock()
    router = RouterServer([SimReplica("s0", clk, seed=0)])
    try:
        assert router.clock is time.monotonic
    finally:
        router.stop()


def test_partition_marks_dead_then_revives_without_respawn():
    clk = SimClock()
    reps = [SimReplica(f"s{i}", clk, seed=0) for i in range(3)]
    router = RouterServer(reps, probe_fails=2, clock=clk)
    try:
        reps[0].partition(5.0)
        for _ in range(2):                  # debounce: two failed probes
            router.poll_now()
            clk.advance(1.0)
        assert router.health()[1]["healthy"] == 2
        clk.advance(5.0)                    # heal window passes
        router.poll_now()                   # can_revive: probe revival
        assert router.health()[1]["healthy"] == 3
        assert router.metrics.counter(
            "router.replica_revives").value == 1
    finally:
        router.stop()


def test_poll_pass_metrics():
    clk = SimClock()
    reps = [SimReplica(f"s{i}", clk, seed=0) for i in range(5)]
    router = RouterServer(reps, clock=clk)
    try:
        router.poll_now()
        assert router.metrics.gauge("router.fleet_size").value == 5
        hist = router.metrics.histogram("router.poll_s").snapshot()
        assert hist["count"] == 1 and hist["max"] < 1.0
    finally:
        router.stop()


def test_shadow_byte_ceiling_evicts():
    clk = SimClock()
    reps = [SimReplica(f"s{i}", clk, seed=0) for i in range(4)]
    router = RouterServer(reps, shadow_max_bytes=4096, clock=clk)
    try:
        for i in range(64):                 # distinct 2-block prompts
            prompt = [i * 100 + j for j in range(33)]
            router.route(Request(prompt=prompt, max_new_tokens=2))
        for r in reps:
            r.advance_to(clk.advance(10.0))
        router.poll_now()
        assert router._shadow_bytes() <= 4096
        assert router.metrics.counter(
            "router.shadow_evictions").value > 0
    finally:
        router.stop()


def test_shadow_ceiling_disabled_when_nonpositive():
    clk = SimClock()
    router = RouterServer([SimReplica("s0", clk, seed=0)],
                          shadow_max_bytes=0, clock=clk)
    try:
        assert router._enforce_shadow_bound(10 ** 9) == 10 ** 9
        assert router.metrics.counter(
            "router.shadow_evictions").value == 0
    finally:
        router.stop()


# ---------------------------------------------------------------------------
# SimFleet driver: real control plane on virtual time.
# ---------------------------------------------------------------------------


def test_fleet_crash_storm_failover_keeps_every_request():
    fleet = SimFleet(8, seed=5)
    try:
        arrivals = []
        t = 0.0
        for i in range(200):
            t += 0.01
            arrivals.append(type("A", (), {
                "t": t, "req": _req(prompt_len=6 + i % 4)})())
        stats = fleet.run(arrivals,
                          events=crash_storm(5, n_kills=3, t0=0.3,
                                             t1=1.5),
                          settle_s=5.0, max_virtual_s=120.0)
        assert stats["delivered"] == stats["submitted"] == 200
        assert stats["mismatches"] == 0
        assert fleet.router.metrics.counter(
            "supervisor.respawns").value >= 1
        assert fleet.router.memory_report()["tickets"] == 0
    finally:
        fleet.close()


def test_campaign_report_is_deterministic():
    kw = dict(n_replicas=25, n_requests=2000, poll_scaling=False)
    drop = ("wall_s", "poll_scaling")
    a = run_sim_campaign(seed=11, **kw)
    b = run_sim_campaign(seed=11, **kw)
    assert {k: v for k, v in a.items() if k not in drop} \
        == {k: v for k, v in b.items() if k not in drop}
    assert a["ok"], a["oracles"]
    c = run_sim_campaign(seed=12, **kw)
    assert c["ok"], c["oracles"]
    assert {k: v for k, v in c.items() if k not in drop} \
        != {k: v for k, v in a.items() if k not in drop}


def test_poll_scaling_measure_shape():
    m = measure_poll_scaling(n_small=5, n_big=20, polls=4)
    assert m["poll_s_small"] > 0 and m["poll_s_big"] > 0
    assert m["per_replica_ratio"] > 0


def _without_wall(report: dict) -> dict:
    return {k: v for k, v in report.items()
            if k not in ("wall_s", "poll_scaling")}


def test_sim_tokens_and_profile_equal_the_jax_module():
    from horovod_tpu.serving import Request as JRequest
    for n, new in ((1, 1), (8, 4), (33, 16)):
        prompt = [(7 * i + 3) % 50000 for i in range(n)]
        assert sim_tokens(Request(prompt=prompt, max_new_tokens=new)) == \
            jsimfleet.sim_tokens(JRequest(prompt=prompt,
                                          max_new_tokens=new))
    assert PhaseProfile() == PhaseProfile(**vars(jsimfleet.PhaseProfile()))
    assert PhaseProfile().service_s(25, 8) == \
        jsimfleet.PhaseProfile().service_s(25, 8)


@pytest.mark.parametrize("seed", [0, 11])
def test_fleet_scale_campaign_equals_the_jax_one(seed):
    """The fleet-scale campaign at reduced scale (20 replicas × 5,000
    requests, the same storms, epoch bumps and oracles): the port's
    report is the JAX module's, field for field, ``wall_s`` and the
    wall-timed ``poll_scaling`` aside."""
    kw = dict(seed=seed, n_replicas=20, n_requests=5000,
              poll_scaling=False)
    got = run_sim_campaign(**kw)
    want = jsimfleet.run_sim_campaign(**kw)
    assert _without_wall(got) == _without_wall(want)
    assert set(got) == set(want)
    failed = {k: v for k, v in got["oracles"].items() if not v}
    assert not failed, (failed, got)
    assert got["n_requests"] >= 5000
    assert got["respawns"] >= 1 and got["failovers"] >= 1
    assert got["alerts"]["fired"] and not got["alerts"]["unresolved"]
    assert got["epoch"] >= 2
    assert got["journal_dedups"] >= got["keyed"] > 0


def test_measure_simfleet_keys_equal_the_jax_arm():
    from horovod_tpu_torch.simfleet import measure_simfleet
    got = measure_simfleet(seed=2, n_replicas=10, n_requests=500)
    want = jsimfleet.measure_simfleet(seed=2, n_replicas=10,
                                      n_requests=500)
    assert set(got) == set(want)
    drop = ("serve_simfleet_wall_s",)
    assert {k: v for k, v in got.items() if k not in drop} == \
        {k: v for k, v in want.items() if k not in drop}
