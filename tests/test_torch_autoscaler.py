"""The port's elastic fleet (``horovod_tpu_torch/autoscaler.py``): the
advisor → actuator loop, epoch'd membership and the zero-drop drain.

Mirrors ``tests/test_autoscaler.py`` on the port's router, supervisor seam
and alert plane: everything but the end-to-end campaign runs on fake
replica handles and explicit ``now=`` timestamps, no engines and no
wall clock in any guard assertion.  Beside the mirror: a scripted
actuation sequence gives the same decision records in both packages, the
two fleet-scale clamp cases of ``tests/test_alerts.py`` run on the port's
``SimFleet``, and the campaign drives the port's engines (``llama_tiny``
in f32, the JAX weights carried over).
"""

from __future__ import annotations

import importlib.util
import json
import os

import pytest

from horovod_tpu import autoscaler as jautoscaler
from horovod_tpu import router as jrouter
from horovod_tpu import serving as jserving
from horovod_tpu_torch import faults as faults_mod
from horovod_tpu_torch.alerts import ALERT_RULES, AlertManager
from horovod_tpu_torch.autoscaler import (
    FleetAutoscaler, FleetEpoch, LeastLocalityVictim, VictimPolicy,
    maybe_autoscaler)
from horovod_tpu_torch.metrics import MetricsRegistry
from horovod_tpu_torch.router import ReplicaHandle, RouterServer
from horovod_tpu_torch.serving import OK, Request, RequestResult
from horovod_tpu_torch.timeseries import MetricsSampler
from torch_engine_twin import tiny_world

pytestmark = pytest.mark.autoscale


@pytest.fixture(scope="module")
def health_mod():
    spec = importlib.util.spec_from_file_location(
        "health_report",
        os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "tools", "health_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Clock:
    """Mutable virtual clock passed as ``clock=``."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


class _Echo(ReplicaHandle):
    """Completes every submission instantly with a deterministic
    function of the prompt — the same function ``_Hold`` answers with,
    so failover replay is bit-comparable across handle types."""

    block_size = 8

    def __init__(self, name: str):
        self.name = name
        self.stopped = False

    def submit(self, req, done_cb):
        done_cb(RequestResult([t + 1 for t in req.prompt], OK))

    def probe(self):
        return {"healthy": True, "inflight": 0, "queue_depth": 0,
                "goodput": 1.0, "free_kv_frac": 1.0}

    def stop(self):
        self.stopped = True


class _Hold(ReplicaHandle):
    """Parks every submission until ``release()`` (answering exactly
    like ``_Echo``) or ``_die()`` (firing the ``None`` failover signal
    — the crash path the forced drain takes)."""

    block_size = 8

    def __init__(self, name: str):
        self.name = name
        self.pending = []
        self.dead = False

    def submit(self, req, done_cb):
        self.pending.append((req, done_cb))

    def release(self):
        pending, self.pending = self.pending, []
        for req, cb in pending:
            cb(RequestResult([t + 1 for t in req.prompt], OK))

    def _die(self):
        self.dead = True
        pending, self.pending = self.pending, []
        for _req, cb in pending:
            cb(None)

    def probe(self):
        return {"healthy": not self.dead,
                "inflight": len(self.pending), "queue_depth": 0,
                "goodput": 1.0, "free_kv_frac": 1.0}


class _Spawner:
    """The supervisor factory seam, faked: spawns ``_Echo`` replicas
    and records what the autoscaler asked it to forget."""

    def __init__(self, fail: bool = False):
        self.spawned = []
        self.forgotten = []
        self.fail = fail

    def spawn_replica(self, name, template=None):
        if self.fail:
            raise RuntimeError("factory down")
        self.spawned.append(name)
        return _Echo(name)

    def forget(self, name):
        self.forgotten.append(name)


class _Pick(VictimPolicy):
    name = "pick"

    def __init__(self, target: str):
        self.target = target

    def choose(self, candidates, views, shadows):
        assert self.target in candidates
        return self.target


def _fleet(handles, *, journal=None, faults=None, **asc_kw):
    router = RouterServer(handles, policy="round_robin",
                          journal=journal, faults=faults)
    sup = _Spawner()
    kw = dict(supervisor=sup, enabled=True, cooldown_s=0.0,
              stable_s=0.0, min_replicas=1, max_replicas=8, step=1,
              drain_s=5.0, eval_s=1.0)
    kw.update(asc_kw)
    asc = FleetAutoscaler(router, **kw)
    return router, sup, asc


def test_grow_respects_cooldown_and_max_bound():
    router, sup, asc = _fleet([_Echo("r0")], cooldown_s=10.0,
                              max_replicas=3)
    up = {"action": "scale_up", "n": 1, "reason": "backlog"}
    d = asc.actuate(up, now=0.0)
    assert d["action"] == "scale_up" and d["replicas"] == ["auto0"]
    assert asc.epoch.generation == 1
    assert "auto0" in asc.epoch.members and sup.spawned == ["auto0"]
    # Within the cooldown nothing actuates, however loud the advice.
    d = asc.actuate({**up, "n": 4}, now=5.0)
    assert d["action"] == "hold" and "cooldown" in d["why"]
    assert len(router.replicas) == 2
    # Past the cooldown the step cap still adds one at a time.
    d = asc.actuate({**up, "n": 4}, now=20.0)
    assert d["action"] == "scale_up" and d["replicas"] == ["auto1"]
    assert len(router.replicas) == 3 and asc.epoch.generation == 2
    # At max_replicas growth holds.
    d = asc.actuate(up, now=40.0)
    assert d["action"] == "hold" and "max_replicas" in d["why"]
    # The joined replicas serve routed traffic.
    for i in range(3):
        rid = router.route(Request(prompt=[2, 3 + i],
                                   max_new_tokens=2))
        assert router.result(rid, timeout=5).status == OK
    with router._lock:
        assert router._routed.get("auto0", 0) >= 1
    snap = router.metrics.snapshot()["counters"]
    assert snap["autoscaler.scale_ups"] == 2
    assert snap["autoscaler.actions"] == 2
    assert snap["autoscaler.holds"] == 2
    router.stop()


def test_grow_holds_when_factory_fails():
    router, _sup, asc = _fleet([_Echo("r0")])
    asc._explicit_supervisor = _Spawner(fail=True)
    d = asc.actuate({"action": "scale_up", "n": 1, "reason": "x"},
                    now=0.0)
    assert d["action"] == "hold" and "no replica" in d["why"]
    assert len(router.replicas) == 1 and asc.epoch.generation == 0
    router.stop()


def test_scale_down_stabilization_window_suppresses_flaps():
    handles = [_Echo(f"r{i}") for i in range(3)]
    router, sup, asc = _fleet(handles, stable_s=30.0, min_replicas=2)
    down = {"action": "scale_down", "n": 1, "reason": "idle"}
    d = asc.actuate(down, now=0.0)
    assert d["action"] == "hold" and "stabilizing" in d["why"]
    d = asc.actuate(down, now=29.0)
    assert d["action"] == "hold"            # 29 s < 30 s, still held
    # A hold in between resets the window: flap suppression.
    asc.actuate({"action": "hold", "n": 0, "reason": "recovered"},
                now=30.0)
    d = asc.actuate(down, now=31.0)
    assert d["action"] == "hold" and "stabilizing" in d["why"]
    # Sustained shrink advice finally cordons (window restarted @31).
    d = asc.actuate(down, now=62.0)
    assert d["action"] == "scale_down" and d["replicas"] == ["r0"]
    # Cordoned state is visible on every surface while draining.
    assert router.cordoned() == ["r0"]
    _, body = router.health()
    assert body["cordoned"] == ["r0"] and "epoch" in body
    rows = {r["name"]: r for r in router.replicas_report()}
    assert rows["r0"]["cordoned"] and not rows["r1"]["cordoned"]
    assert "CORDONED" in router.state_dump()
    # An idle echo drains instantly: the next tick retires it.
    asc.tick(now=63.0)
    assert len(router.replicas) == 2 and asc.epoch.generation == 1
    assert router.cordoned() == [] and sup.forgotten == ["r0"]
    assert handles[0].stopped
    # At min_replicas further shrink advice holds (after its window).
    asc.actuate(down, now=100.0)
    d = asc.actuate(down, now=131.0)
    assert d["action"] == "hold" and "min_replicas" in d["why"]
    assert len(router.replicas) == 2
    router.stop()


def test_drain_retire_zero_drop_exactly_once_across_epoch(tmp_path):
    a, b = _Echo("a"), _Hold("b")
    router, _sup, asc = _fleet(
        [a, b], journal=str(tmp_path / "wal.jsonl"),
        victim_policy=_Pick("b"))
    # Round-robin: request 0 lands on a (answers instantly), request 1
    # parks on b — in flight across the whole cordon.  Prompts span a
    # full shadow block so the survivor's index has paths to keep.
    reqs = [Request(prompt=list(range(2, 12)), max_new_tokens=2),
            Request(prompt=list(range(12, 22)), max_new_tokens=2)]
    rids = [router.route(r, idempotency_key=f"k{i}")
            for i, r in enumerate(reqs)]
    d = asc.actuate({"action": "scale_down", "n": 1, "reason": "idle"},
                    now=0.0)
    assert d["action"] == "scale_down" and d["replicas"] == ["b"]
    assert router.cordoned() == ["b"] and asc.draining() == ["b"]
    _, body = router.health()
    assert body["draining"] == ["b"]
    # The drain waits for the in-flight request (deadline not hit).
    asc.tick(now=1.0)
    assert len(router.replicas) == 2
    # Zero drop: the parked request completes normally, then the next
    # tick retires the drained victim and bumps the epoch.
    b.release()
    results = [router.result(rid, timeout=5) for rid in rids]
    assert [r.status for r in results] == [OK, OK]
    asc.tick(now=2.0)
    assert [r.name for r in router.replicas] == ["a"]
    assert asc.epoch.generation == 1 and asc.draining() == []
    # The shadow prefix index of the survivor outlives the bump.
    with router._lock:
        assert len(router._shadows["a"]) > 0
    # Exactly-once: resubmitting every key after the membership change
    # answers from the journal, bit-identically, with no new serving.
    dup_rids = [router.route(r, idempotency_key=f"k{i}")
                for i, r in enumerate(reqs)]
    for rid, orig in zip(dup_rids, results):
        dup = router.result(rid, timeout=5)
        assert dup.status == OK and list(dup) == list(orig)
    snap = router.metrics.snapshot()["counters"]
    assert snap["router.journal_dedups"] == 2
    assert snap["autoscaler.scale_downs"] == 1
    router.stop()


def test_forced_drain_fails_open_and_replays_bit_identical():
    a, b = _Echo("a"), _Hold("b")
    router, _sup, asc = _fleet([a, b], drain_s=0.0,
                               victim_policy=_Pick("b"))
    rid_a = router.route(Request(prompt=[5, 6], max_new_tokens=2))
    rid_b = router.route(Request(prompt=[7, 8], max_new_tokens=2))
    assert router.result(rid_a, timeout=5).status == OK
    asc.actuate({"action": "scale_down", "n": 1, "reason": "idle"},
                now=0.0)
    # Past the (zero) drain deadline the victim is killed through the
    # crash path: its callback fires None and the router replays on
    # the survivor — cordoned b is never a failover candidate.
    asc.tick(now=1.0)
    assert b.dead
    res = router.result(rid_b, timeout=5)
    assert res.status == OK and list(res) == [8, 9]
    snap = router.metrics.snapshot()["counters"]
    assert snap["router.failovers"] == 1
    # Drained (by force) means retirable: the next tick completes it.
    asc.tick(now=2.0)
    assert [r.name for r in router.replicas] == ["a"]
    assert asc.epoch.generation == 1
    router.stop()


def test_serve_autoscale_fault_degrades_to_hold_never_drops():
    fr = faults_mod.FaultRegistry()
    fr.inject("serve.autoscale", on_hit=1, count=1)
    router, _sup, asc = _fleet([_Echo("r0")], faults=fr)
    rid = router.route(Request(prompt=[2, 3], max_new_tokens=2))
    d = asc.actuate({"action": "scale_up", "n": 1, "reason": "x"},
                    now=0.0)
    # Quarantine: the faulted actuation becomes a hold; membership and
    # the in-flight request are untouched.
    assert d["action"] == "hold" and "actuation fault" in d["why"]
    assert len(router.replicas) == 1 and asc.epoch.generation == 0
    assert router.result(rid, timeout=5).status == OK
    snap = router.metrics.snapshot()["counters"]
    assert snap["autoscaler.hold_faults"] == 1
    assert fr.hits("serve.autoscale") == 1
    # The transient rule cleared: the retry actuates.
    d = asc.actuate({"action": "scale_up", "n": 1, "reason": "x"},
                    now=1.0)
    assert d["action"] == "scale_up"
    router.stop()


def test_tick_consumes_advisor_at_eval_cadence():
    class _Adv:
        def __init__(self):
            self.calls = []

        def recommend(self, now=None):
            self.calls.append(now)
            return {"action": "scale_up", "n": 1, "reason": "demand"}

    adv = _Adv()
    router, _sup, asc = _fleet([_Echo("r0")], advisor=adv, eval_s=1.0)
    d = asc.tick(now=0.0)
    assert d["action"] == "scale_up" and len(router.replicas) == 2
    # Inside the eval cadence the advisor is not even consulted.
    assert asc.tick(now=0.5) is None and adv.calls == [0.0]
    # Disabled keeps the loop advisory: drains advance, advice doesn't.
    asc.enabled = False
    assert asc.tick(now=2.0) is None and adv.calls == [0.0]
    router.stop()


def test_autoscaler_flap_rule_fires_and_resolves():
    # 0.01 scale: window 6 s / clear 3 s (min_delta 3).
    reg = MetricsRegistry(event_log=None)
    clk = Clock(0.0)
    s = MetricsSampler(reg, sample_s=1.0, clock=clk)
    rules = [r for r in ALERT_RULES if r["name"] == "autoscaler_flap"]
    assert len(rules) == 1
    am = AlertManager(s, rules=rules, registry=reg, time_scale=0.01,
                      clock=clk)
    actions = reg.counter("autoscaler.actions")

    def step():
        clk.t += 1.0
        s.tick()
        am.tick()

    for _ in range(3):
        step()
    assert am.firing() == []
    actions.inc()
    actions.inc()
    step()
    assert am.firing() == []                # two actions: not a flap
    actions.inc()
    step()
    assert am.firing() == ["autoscaler_flap"]
    for _ in range(15):                     # window drains + clears
        step()
    assert am.firing() == []
    st = am.states()["autoscaler_flap"]
    assert st["fired"] == 1 and st["resolved"] == 1


def test_least_locality_victim_ordering():
    class _Lens:
        def __init__(self, n):
            self._n = n

        def __len__(self):
            return self._n

    p = LeastLocalityVictim()
    shadows = {"a": _Lens(5), "b": _Lens(2), "c": _Lens(2)}
    views = {"b": {"goodput": 0.9}, "c": {"goodput": 0.5}}
    # Fewest paths first; among ties the worst goodput goes.
    assert p.choose(["a", "b", "c"], views, shadows) == "c"
    assert p.choose(["a", "b"], views, shadows) == "b"
    # No shadow data at all: deterministic by name.
    assert p.choose(["y", "x"], {}, {}) == "x"


def test_epoch_history_and_report_serialize():
    ep = FleetEpoch(["a", "b"], history=2)
    assert ep.generation == 0 and ep.members == ("a", "b")
    ep.bump(["a", "b", "c"], "scale_up", 1.0)
    ep.bump(["a", "c"], "scale_down", 2.0)
    ep.bump(["a"], "scale_down", 3.0)
    snap = ep.snapshot()
    assert snap["generation"] == 3 and snap["members"] == ["a"]
    assert len(snap["history"]) == 2        # bounded
    json.dumps(snap)

    router, _sup, asc = _fleet([_Echo("r0")])
    rep = asc.report()
    json.dumps(rep)                         # the /autoscaler payload
    assert rep["enabled"] and rep["size"] == 1
    assert rep["victim_policy"] == "least_locality"
    assert rep["last_action"] is None
    asc.actuate({"action": "scale_up", "n": 1, "reason": "x"},
                now=0.0)
    rep = asc.report()
    assert rep["last_action"]["action"] == "scale_up"
    assert "autoscaler: epoch=1" in router.state_dump()
    router.stop()


def test_maybe_autoscaler_env_gate(monkeypatch):
    monkeypatch.delenv("HVD_TORCH_AUTOSCALE", raising=False)
    router = RouterServer([_Echo("r0")], policy="round_robin",
                          sampler=False)
    assert router.autoscaler is None
    # Truthy env but no advisor (sampler disabled): still off, silently.
    monkeypatch.setenv("HVD_TORCH_AUTOSCALE", "1")
    assert router.advisor is None
    assert maybe_autoscaler(router) is None
    # With an advisor attached the env turns the loop on.
    router.advisor = object()
    asc = maybe_autoscaler(router)
    assert asc is not None and asc.enabled
    assert router.autoscaler is asc
    router.stop()


def test_health_report_renders_autoscale_timeline(health_mod):
    events = [
        {"kind": "alert.fire", "ts": 1.0, "rule": "queue_growth",
         "state": "firing", "severity": "page", "value": 2.0},
        {"kind": "autoscaler.scale_up", "ts": 2.0, "replica": "auto0",
         "epoch": 1},
        {"kind": "autoscaler.cordon", "ts": 3.0, "replica": "replica1"},
        {"kind": "autoscaler.retire", "ts": 4.0, "replica": "replica1",
         "epoch": 2},
        {"kind": "alert.resolve", "ts": 5.0, "rule": "queue_growth",
         "state": "ok", "severity": "page", "value": 0.0},
    ]
    tl = health_mod.timeline_from_events(events)
    assert [r["event"] for r in tl] == [
        "fire", "scale_up", "cordon", "retire", "resolve"]
    # Autoscaler rows stay out of the live≡replay equivalence key.
    assert health_mod.timeline_key(tl) == [
        ("queue_growth", "fire", "firing"),
        ("queue_growth", "resolve", "ok")]
    rep = health_mod.build_report(tl, source="events")
    assert rep["ok"] and rep["fired"] == ["queue_growth"]
    text = health_mod.render(rep)
    assert "scale_up" in text and "auto0" in text




def _script(asc, router, now0: float = 0.0) -> list[dict]:
    """A fixed actuation sequence over every guard and action; returns the
    decision records without their timestamps."""
    seq = [("scale_up", 1), ("scale_up", 3), ("hold", 0),
           ("scale_down", 1), ("scale_down", 2), ("scale_down", 1),
           ("scale_up", 5), ("scale_down", 1), ("scale_down", 3)]
    out = []
    for i, (action, n) in enumerate(seq):
        now = now0 + 10.0 * i
        d = asc.actuate({"action": action, "n": n, "reason": f"s{i}"},
                        now=now)
        asc.tick(now=now + 1.0)
        with router._lock:
            names = sorted(r.name for r in router.replicas)
        out.append(({k: v for k, v in d.items() if k != "t"}, names,
                    asc.epoch.generation))
    return out


class _JEcho(jrouter.ReplicaHandle):
    """``_Echo`` on the reference's handle interface."""

    block_size = 8

    def __init__(self, name: str):
        self.name = name

    def submit(self, req, done_cb):
        done_cb(jserving.RequestResult([t + 1 for t in req.prompt],
                                       jserving.OK))

    def probe(self):
        return {"healthy": True, "inflight": 0, "queue_depth": 0,
                "goodput": 1.0, "free_kv_frac": 1.0}


class _JSpawner(_Spawner):
    def spawn_replica(self, name, template=None):
        self.spawned.append(name)
        return _JEcho(name)


def test_scripted_actuations_decide_as_the_jax_autoscaler():
    """The same advice, timestamps and fleet give the same decisions,
    members and epochs in both packages (guards, victim choice, drains)."""
    kw = dict(enabled=True, cooldown_s=5.0, stable_s=15.0,
              min_replicas=2, max_replicas=4, step=2, drain_s=5.0,
              eval_s=1.0)
    router = RouterServer([_Echo(f"r{i}") for i in range(3)],
                          policy="round_robin", sampler=False)
    jr = jrouter.RouterServer([_JEcho(f"r{i}") for i in range(3)],
                              policy="round_robin", sampler=False)
    try:
        asc = FleetAutoscaler(router, supervisor=_Spawner(), **kw)
        jasc = jautoscaler.FleetAutoscaler(jr, supervisor=_JSpawner(),
                                           **kw)
        got = _script(asc, router)
        want = _script(jasc, jr)
        assert got == want
        assert {d[0]["action"] for d in got} == {"scale_up", "scale_down",
                                                 "hold"}
        rep, jrep = asc.report(), jasc.report()
        assert rep["epoch"] == jrep["epoch"]
        assert set(rep) == set(jrep)
    finally:
        router.stop()
        jr.stop()


def test_autoscaler_step_cap_then_max_bound_clamp_advice():
    """The port twin of ``tests/test_alerts.py``'s clamp case: a +50
    recommendation against a 200-replica SimFleet; the step cap admits 8
    per action, and max_replicas truncates even that."""
    from horovod_tpu_torch.simfleet import SimFleet

    fleet = SimFleet(200, seed=0, max_replicas=204)
    try:
        d = fleet.autoscaler.actuate({"action": "scale_up", "n": 50,
                                      "reason": "demand"})
        assert d["action"] == "scale_up"
        assert len(fleet.router.replicas) == 204
        fleet.clock.advance(3.0)            # past the cooldown guard
        d2 = fleet.autoscaler.actuate({"action": "scale_up", "n": 50,
                                       "reason": "demand"})
        assert d2["action"] == "hold" and "max_replicas" in d2["why"]
        assert len(fleet.router.replicas) == 204
    finally:
        fleet.close()


def test_autoscaler_step_cap_alone_rations_big_advice():
    from horovod_tpu_torch.simfleet import SimFleet

    fleet = SimFleet(50, seed=0, max_replicas=200)
    try:
        d = fleet.autoscaler.actuate({"action": "scale_up", "n": 50,
                                      "reason": "demand"})
        assert d["action"] == "scale_up"
        assert len(fleet.router.replicas) == 58     # 50 + step cap 8
    finally:
        fleet.close()


# ---------------------------------------------------------------------------
# End-to-end: the port's engines under the scripted campaign.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world():
    return tiny_world()


def test_autoscale_campaign_end_to_end(world, tmp_path):
    from horovod_tpu_torch.chaos import run_autoscale_campaign
    rep = run_autoscale_campaign(
        world.tp, world.tcfg, n_replicas=2, n_groups=2, waves=5,
        event_log=str(tmp_path / "events.jsonl"),
        journal=str(tmp_path / "wal.jsonl"), timeout_s=240.0)
    assert rep["ok"], rep["oracles"]
    assert rep["oracles"]["zero_dropped"]
    assert rep["oracles"]["exactly_once"] and rep["dedups"] == 2
    assert rep["oracles"]["fault_degraded_to_hold"]
    assert rep["grown_replicas"] == ["auto0"]
    assert rep["epoch"]["generation"] == 2
    assert rep["scale_ups"] == 1 and rep["scale_downs"] == 1
    kinds = {json.loads(line).get("kind")
             for line in (tmp_path / "events.jsonl").read_text()
             .splitlines() if line.strip()}
    assert "autoscaler.scale_up" in kinds
    assert "autoscaler.cordon" in kinds
    assert "autoscaler.retire" in kinds
    assert "HVD_TORCH_EVENT_LOG" not in os.environ

