"""The port's chaos campaigns (``horovod_tpu_torch/chaos.py``).

Mirrors the chaos-only cases of ``tests/test_chaos.py`` (the schedule,
``compare_campaigns``, the campaign smoke test and the alert-oracle
campaign; the journal and supervisor cases are mirrored in
``test_torch_router.py`` and ``test_torch_supervisor.py``) on the port's
engines (``llama_tiny`` in f32, the JAX weights carried over), and holds
the port to the JAX module: equal schedules at the same seed, equal gate
verdicts, and one campaign through both packages with the same oracle
verdicts, tokens and counts.  Campaigns wait on results with generous
timeouts, never on a wall-clock limit of their own.
"""

from __future__ import annotations

import os

import pytest

from horovod_tpu import chaos as jchaos
from horovod_tpu.serving_scheduler import ServeEngine as JaxEngine
from horovod_tpu_torch import metrics
from horovod_tpu_torch.chaos import (
    KILL_SITE, STORM_SITES, ChaosRule, ChaosSchedule, _workload,
    compare_campaigns, run_campaign,
)
from horovod_tpu_torch.faults import FaultRegistry
from horovod_tpu_torch.metrics import EventLog
from horovod_tpu_torch.serving_scheduler import ServeEngine
from torch_engine_twin import tiny_world

pytestmark = pytest.mark.chaos

NAMES = ["replica0", "replica1", "replica2"]


@pytest.fixture(scope="module")
def world():
    return tiny_world()


# -- schedules and the regression gate: no engine ----------------------------


def test_chaos_schedule_deterministic_and_covering():
    a = ChaosSchedule.generate(7, replica_names=NAMES)
    b = ChaosSchedule.generate(7, replica_names=NAMES)
    assert a.to_json() == b.to_json()           # seed IS the schedule
    assert ChaosSchedule.generate(8, replica_names=NAMES).to_json() \
        != a.to_json()
    assert {r.site for r in a.rules} == set(STORM_SITES)
    assert set(a.sites()) == set(STORM_SITES) | {KILL_SITE}
    for k in a.kills:
        assert k.site == KILL_SITE and k.key in NAMES
        assert 2 <= k.on_hit <= 8 and k.count == 1
    fr = FaultRegistry()
    ChaosRule(site="serve.tick", on_hit=2).arm(fr)
    fr.check("serve.tick")
    with pytest.raises(Exception):
        fr.check("serve.tick")
    assert fr.log == [("serve.tick", None, 2)]


@pytest.mark.parametrize("seed", [0, 3, 7, 42, 2**31 - 1])
@pytest.mark.parametrize("n_faults,n_kills", [(6, 1), (12, 3), (2, 0)])
def test_chaos_schedule_equals_the_jax_one(seed, n_faults, n_kills):
    got = ChaosSchedule.generate(seed, replica_names=NAMES,
                                 n_faults=n_faults, n_kills=n_kills)
    want = jchaos.ChaosSchedule.generate(seed, replica_names=NAMES,
                                         n_faults=n_faults, n_kills=n_kills)
    assert got.to_json() == want.to_json()
    assert got.sites() == want.sites()


def test_compare_campaigns_gate():
    old = {"oracles": {"bit_identical": True, "healed": True},
           "ok": True, "ok_fraction": 1.0}
    same = {"oracles": {"bit_identical": True, "healed": True},
            "ok": True, "ok_fraction": 0.95}
    ok, problems = compare_campaigns(old, same)
    assert ok and not problems
    broken = {"oracles": {"bit_identical": True, "healed": False},
              "ok": False, "ok_fraction": 0.5}
    ok, problems = compare_campaigns(old, broken)
    assert not ok
    assert any("healed" in p for p in problems)
    assert any("ok_fraction" in p for p in problems)
    soak_old, soak_new = ({"min_ok_fraction": 1.0, "ok": True},
                          {"min_ok_fraction": 0.7, "ok": True})
    ok, problems = compare_campaigns(soak_old, soak_new)
    assert not ok and "min_ok_fraction" in problems[0]
    for pair in ((old, same), (old, broken), (soak_old, soak_new),
                 (broken, old)):
        assert compare_campaigns(*pair) == jchaos.compare_campaigns(*pair)


# -- campaigns on the port's fleet -------------------------------------------


def test_chaos_campaign_smoke(world):
    """One seeded storm — every STORM_SITE armed plus a replica kill —
    passes every invariant oracle."""
    report = run_campaign(world.tp, world.tcfg, seed=3)
    assert report["ok"], report
    assert all(report["oracles"].values()), report["oracles"]
    assert len(report["sites_fired"]) >= 3
    assert report["kills_fired"] >= 1
    assert report["respawns"] >= 1
    assert report["ok_fraction"] > 0.0
    again = ChaosSchedule.generate(
        3, replica_names=[f"replica{i}" for i in range(3)])
    assert report["schedule"] == again.to_json()
    assert "HVD_TORCH_EVENT_LOG" not in os.environ


def test_chaos_campaign_alert_oracle(world):
    """A consecutive-prefill fault rule exhausts retry budgets (FAILED
    requests, a goodput dip) on a one-replica fleet with one kill:
    replica_death and goodput_burn_fast fire during the storm and resolve
    after heal and recovery traffic."""
    report = run_campaign(
        world.tp, world.tcfg, seed=7, n_replicas=1, n_kills=1,
        extra_rules=[ChaosRule("serve.prefill", on_hit=2, count=12)],
        alert_oracle=True, recovery_waves=8,
        alert_time_scale=0.005, alert_drain_s=30.0)
    assert report["ok"], report
    assert report["oracles"]["alerts_covered"], report["alerts"]
    fired = set(report["alerts"]["fired"])
    assert "replica_death" in fired
    assert "goodput_burn_fast" in fired
    assert fired <= set(report["alerts"]["resolved"])
    assert not report["alerts"]["still_firing"]
    assert report["ok_fraction"] < 1.0
    kinds = {e["kind"] for e in EventLog.read(report["event_log"])}
    assert "alert.fire" in kinds and "alert.resolve" in kinds
    assert report["alerts"]["transitions"] >= 4


def test_event_log_knob_restored_after_a_failed_campaign(world,
                                                         monkeypatch):
    """The campaign sets ``HVD_TORCH_EVENT_LOG`` for its fleet and puts
    the caller's value back in a ``finally``, also when it fails."""
    from horovod_tpu_torch import chaos

    def _refuse(*a, **k):
        raise RuntimeError("router refused")

    monkeypatch.setenv("HVD_TORCH_EVENT_LOG", "caller.jsonl")
    monkeypatch.setattr(chaos, "RouterServer", _refuse)
    for campaign in (chaos.run_campaign, chaos.run_autoscale_campaign):
        with pytest.raises(RuntimeError, match="router refused"):
            campaign(world.tp, world.tcfg, n_replicas=1)
    assert os.environ["HVD_TORCH_EVENT_LOG"] == "caller.jsonl"


def test_campaign_matches_the_jax_campaign(world):
    """One campaign at seed 3 through both packages: the same workload and
    fault-free tokens, the same schedule, oracle verdicts (all held) and
    storm counts.  ``n_ok`` / ``ok_fraction`` (whether a request's retry
    budget ran out depends on how the pump threads batched its inbox) and
    the ``alerts`` section (rules judged on the wall clock) differ between
    two runs of one package, so they are not compared; nor is
    ``event_log``, a temporary path."""
    jw = _workload(4, 4)
    assert [r.prompt for r in jw] == [r.prompt for r in
                                      jchaos._workload(4, 4)]
    kw = dict(n_slots=2, max_len=64, chunk=8, prefix_cache=True,
              monitor=False, sampler=False)
    port_ref = ServeEngine(world.tp, world.tcfg, metrics=metrics.NULL,
                           **kw).run(jw)
    jax_ref = JaxEngine(world.jp, world.jcfg, **kw).run(
        jchaos._workload(4, 4))
    assert [list(map(int, r)) for r in port_ref] == \
        [list(map(int, r)) for r in jax_ref]

    got = run_campaign(world.tp, world.tcfg, seed=3)
    want = jchaos.run_campaign(world.jp, world.jcfg, seed=3)
    assert got["oracles"] == want["oracles"]
    assert all(got["oracles"].values())
    for key in ("seed", "schedule", "sites_fired", "n_requests",
                "faults_fired", "kills_fired", "respawns",
                "permanent_deaths", "failovers", "leaked_tickets",
                "leaked_blocks", "block_errors", "counter_regressions",
                "unlogged_faults", "mismatched_requests", "ok"):
        assert got[key] == want[key], key
    assert set(got) == set(want)
