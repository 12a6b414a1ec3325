"""The port's replica supervisor (``horovod_tpu_torch/supervisor.py``).

Mirrors the supervisor cases of ``tests/test_chaos.py`` that need no
``chaos.py``: backoff, budget and circuit breaker; the ``serve.supervisor``
fault site; a warm-up that survives a bad prompt; a local replica killed
mid-stream and respawned through ``clone_engine`` with tokens equal to the
solo oracle; and the SIGKILL drill against a real replica process
(``tests/torch_supervisor_worker.py``, the twin of
``tests/multiprocess_supervisor_worker.py``) healed out of band.  Adds what
the port promises of ``clone_engine``: the clone holds the same weight
tensors and the same KV geometry.

Engines are ``llama_tiny`` in f32 from seed 11; the port's solo
``generate`` is the oracle.  Tolerance: none (greedy tokens, exact).
No assertion waits on a wall-clock limit tighter than the reference's.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest
import torch

from horovod_tpu_torch.faults import FaultRegistry
from horovod_tpu_torch.models import llama
from horovod_tpu_torch.router import (HttpReplica, LocalReplica,
                                      ReplicaHandle, RouterServer)
from horovod_tpu_torch.serving import OK, Request
from horovod_tpu_torch.serving_scheduler import ServeEngine
from horovod_tpu_torch.supervisor import (ReplicaSupervisor, clone_engine,
                                          supervise)

HERE = os.path.dirname(os.path.abspath(__file__))
SUP_WORKER = os.path.join(HERE, "torch_supervisor_worker.py")


@pytest.fixture(scope="module")
def world():
    cfg = llama.llama_tiny(dtype=torch.float32)
    return cfg, llama.init_params(cfg, 11, device="cpu")


def _engines(world, n, **kw):
    cfg, params = world
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("chunk", 8)
    kw.setdefault("prefix_cache", True)
    kw.setdefault("sampler", False)
    return [ServeEngine(params, cfg, **kw) for _ in range(n)]


def _solo(world, prompt, n_new, max_len=64):
    cfg, params = world
    return llama.generate(params, torch.tensor([prompt]), cfg,
                          max_new_tokens=n_new, max_len=max_len)[0].tolist()


class _BlackHole(ReplicaHandle):
    name = "hole"
    block_size = 8

    def __init__(self):
        self.cbs = []

    def submit(self, req, done_cb):
        self.cbs.append(done_cb)

    def probe(self):
        return {"healthy": True, "inflight": len(self.cbs),
                "queue_depth": 0, "goodput": 1.0, "free_kv_frac": 1.0}


def test_supervisor_backoff_budget_circuit_breaker(world):
    router = RouterServer(_engines(world, 2), policy="round_robin",
                          sampler=False)
    clk = [0.0]
    boom = []

    def bad_factory():
        boom.append(1)
        raise RuntimeError("factory exploded")

    sup = ReplicaSupervisor(router, max_restarts=2, backoff_s=1.0,
                            factories={"replica0": bad_factory},
                            clock=lambda: clk[0])
    try:
        with router._lock:
            router._dead.add("replica0")
        assert not sup.degraded()
        assert sup.tick() == 0 and len(boom) == 1
        assert sup.tick() == 0 and len(boom) == 1   # inside the backoff
        clk[0] = 1.5
        assert sup.tick() == 0 and len(boom) == 2
        clk[0] = 10.0
        sup.tick()                                  # budget gone
        st = sup.state()["replica0"]
        assert st["restarts"] == 2 and st["permanent_dead"]
        assert [h["ok"] for h in st["history"]] == [False, False]
        assert "factory exploded" in st["history"][0]["error"]
        clk[0] = 100.0
        sup.tick()
        assert len(boom) == 2
        counters = router.metrics.snapshot()["counters"]
        assert counters["supervisor.respawn_failures"] == 2
        assert counters["supervisor.permanent_deaths"] == 1
        assert counters["supervisor.respawns"] == 0
        assert sup.degraded() and router.health()[1]["degraded"]
        dump = router.state_dump()
        assert "supervisor replica0" in dump and "PERMANENT-DEAD" in dump
    finally:
        router.stop()


def test_supervisor_fault_site_burns_budget(world):
    fr = FaultRegistry()
    fr.inject("serve.supervisor", on_hit=1, key="replica0")
    router = RouterServer(_engines(world, 2), policy="round_robin",
                          faults=fr, sampler=False)
    clk = [0.0]
    sup = ReplicaSupervisor(router, max_restarts=3, backoff_s=1.0,
                            factories={"replica0": lambda: None},
                            clock=lambda: clk[0])
    try:
        with router._lock:
            router._dead.add("replica0")
        assert sup.tick() == 0
        assert fr.log == [("serve.supervisor", "replica0", 1)]
        clk[0] = 2.0
        assert sup.tick() == 0          # out of band: nothing rejoins here
        st = sup.state()["replica0"]
        assert [h["ok"] for h in st["history"]] == [False, True]
        counters = router.metrics.snapshot()["counters"]
        assert counters["supervisor.respawn_failures"] == 1
        assert counters["supervisor.respawns"] == 1
    finally:
        router.stop()


def test_supervisor_warm_continues_past_bad_prompt():
    hole = _BlackHole()
    router = RouterServer([hole], sampler=False)
    sup = ReplicaSupervisor(router, warm_prefixes=4)
    try:
        bad, good = tuple(range(8)), tuple(range(100, 108))
        for p in (good, bad):
            sup._observe_route("hole", Request(prompt=list(p),
                                               max_new_tokens=1))
            with router._lock:
                router._shadows["hole"].observe(list(p))

        class _Eng:
            prefix = object()
            ran: list = []

            def run(self, reqs):
                if tuple(reqs[0].prompt) == bad:
                    raise RuntimeError("poisoned warm prompt")
                self.ran.append(tuple(reqs[0].prompt))

        eng = _Eng()
        sup._warm(eng, "hole")
        assert eng.ran == [good]
        assert router.metrics.snapshot()["counters"][
            "supervisor.warm_prefixes"] == 1
    finally:
        router.stop()


def test_supervisor_respawns_local_replica_bit_identical(world):
    fr = FaultRegistry()
    fr.inject("serve.router", on_hit=3, key="replica0")
    engines = (_engines(world, 1, faults=fr, device_telemetry=True)
               + _engines(world, 1, faults=fr))
    router = RouterServer(engines, policy="round_robin", faults=fr,
                          sampler=False)
    sup = ReplicaSupervisor(router, max_restarts=3, backoff_s=0.0,
                            warm_prefixes=4)
    try:
        dead_engine = router.replicas[0].engine
        assert router.device_report()["without_telemetry"] == ["replica1"]
        stem = list(range(10, 26))
        reqs = [Request(prompt=stem + [40 + i], max_new_tokens=4)
                for i in range(4)]
        rids = [router.route(r) for r in reqs]
        deadline = time.monotonic() + 120
        for rid, req in zip(rids, reqs):
            while True:
                res = router.result(rid, timeout=0.05)
                if res is not None:
                    break
                router.poll_now()
                assert time.monotonic() < deadline, "fleet stalled"
            assert res.status == OK
            assert list(res) == _solo(world, req.prompt, 4)
        while True:
            router.poll_now()
            _code, health = router.health()
            if health["healthy"] == 2:
                break
            assert time.monotonic() < deadline, "replica0 never healed"
        st = sup.state()["replica0"]
        assert st["restarts"] == 1 and not st["permanent_dead"]
        assert [h["ok"] for h in st["history"]] == [True]
        counters = router.metrics.snapshot()["counters"]
        assert counters["supervisor.respawns"] == 1
        assert counters["router.failovers"] >= 1
        assert counters["supervisor.warm_prefixes"] >= 1
        assert health["degraded"]
        clone = router.replicas[0].engine
        assert clone is not dead_engine
        assert clone.params is dead_engine.params   # no second weights copy
        # the respawned replica reports to the fleet's /device view again
        assert clone.device_telemetry is not None
        assert clone.sampler is None and clone.alerts is None
        dev = router.device_report()
        assert dev["summary"]["n_reporting"] == 1
        assert dev["without_telemetry"] == ["replica1"]
        extra = Request(prompt=stem + [77], max_new_tokens=4)
        res = router.result(router.route(extra), timeout=120)
        assert res.status == OK
        assert list(res) == _solo(world, extra.prompt, 4)
    finally:
        router.stop()


def test_clone_engine_shares_weights_and_keeps_the_geometry(world):
    (eng,) = _engines(world, 1, n_blocks=20, spec=True, draft_k=3)
    clone = clone_engine(eng)
    assert clone.params is eng.params
    from torch.utils import _pytree as pytree

    mine = pytree.tree_leaves(eng.params)
    assert [t.data_ptr() for t in pytree.tree_leaves(clone.params)] == \
        [t.data_ptr() for t in mine] and len(mine) > 4
    assert clone.pcache.k.shape == eng.pcache.k.shape
    assert clone.pcache.k.shape[1] == 20
    assert clone.pcache.k.data_ptr() != eng.pcache.k.data_ptr()
    for attr in ("n_slots", "max_len", "chunk", "block_size", "spec",
                 "draft_k", "max_retries", "watchdog_steps"):
        assert getattr(clone, attr) == getattr(eng, attr), attr
    assert (clone.prefix is None) == (eng.prefix is None)
    assert type(clone.policy) is type(eng.policy)
    assert clone.device_telemetry is None and clone.sampler is None
    # the measurement planes carry over: a new device plane, the same
    # sampler and alert rules
    (watched,) = _engines(world, 1, device_telemetry=True, sampler=None)
    twin = clone_engine(watched)
    assert twin.device_telemetry is not None
    assert twin.device_telemetry is not watched.device_telemetry
    assert twin.sampler is watched.sampler is not None
    assert twin.alerts is watched.alerts
    reqs = [Request(prompt=list(range(3, 14)), max_new_tokens=5),
            Request(prompt=[7, 7, 2, 9], max_new_tokens=6)]
    a = [list(r) for r in eng.run([Request(prompt=r.prompt,
                                           max_new_tokens=r.max_new_tokens)
                                   for r in reqs])]
    b = [list(r) for r in clone.run(reqs)]
    assert a == b == [_solo(world, r.prompt, r.max_new_tokens) for r in reqs]


def test_spawn_replica_clones_a_live_template_warm(world):
    router = RouterServer(_engines(world, 1), policy="prefix_affinity",
                          sampler=False)
    sup = supervise(router, warm_prefixes=2)
    try:
        assert router.supervisor is sup
        stem = list(range(20, 37))
        res = router.result(router.route(
            Request(prompt=stem + [3], max_new_tokens=2)), timeout=60)
        assert res.status == OK
        handle = sup.spawn_replica("grown")
        assert isinstance(handle, LocalReplica) and handle.name == "grown"
        assert handle.engine.params is router.replicas[0].engine.params
        assert handle.engine.prefix_counters["hits"] == 0
        assert router.metrics.snapshot()["counters"][
            "supervisor.warm_prefixes"] == 1
        router.add_replica(handle)
        res = router.result(router.route(
            Request(prompt=stem + [4], max_new_tokens=2)), timeout=60)
        assert res.status == OK and list(res) == _solo(world, stem + [4], 2)
        sup.forget("grown")
    finally:
        router.stop()


@pytest.mark.parametrize("attr,name", [("max_restarts", "MAX_RESTARTS"),
                                       ("backoff_s", "BACKOFF_S")])
def test_supervisor_knobs(attr, name):
    """The budget and backoff are constructor arguments with the
    reference's knob defaults (the port has no env knob for them)."""
    from horovod_tpu import knobs as jknobs

    want = float({k.name: k.default for k in jknobs.knobs()}[
        f"HVD_TPU_SUPERVISE_{name}"])
    router = RouterServer([_BlackHole()], sampler=False)
    try:
        assert getattr(ReplicaSupervisor(router), attr) == want
        assert getattr(ReplicaSupervisor(router, **{attr: 7}), attr) == 7
    finally:
        router.stop()


# -- the SIGKILL drill against a real replica process -------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_healthy(url: str, deadline: float) -> None:
    while True:
        try:
            with urllib.request.urlopen(url + "/healthz", timeout=2) as r:
                if json.loads(r.read()).get("ok"):
                    return
        except OSError:
            pass
        assert time.monotonic() < deadline, f"{url} never came up"
        time.sleep(0.2)


def test_multiprocess_supervisor_sigkill_respawn(world):
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    env = dict(os.environ)
    env["REPLICA_PORT"] = str(port)
    procs: list[subprocess.Popen] = []

    def launch_worker() -> subprocess.Popen:
        p = subprocess.Popen([sys.executable, SUP_WORKER], env=env,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        procs.append(p)
        return p

    def respawn_worker():
        if procs and procs[-1].poll() is None:
            return None
        launch_worker()
        return None

    launch_worker()
    deadline = time.monotonic() + 300
    _wait_healthy(url, deadline)
    remote = HttpReplica("w", url, monitor_url=url, block_size=8,
                         timeout_s=120.0)
    router = RouterServer(_engines(world, 1) + [remote],
                          policy="round_robin", probe_fails=1,
                          max_failovers=5, sampler=False).start()
    sup = ReplicaSupervisor(router, max_restarts=5, backoff_s=1.0,
                            factories={"w": respawn_worker})
    try:
        stem = list(range(2, 19))
        reqs = [Request(prompt=stem + [30 + i], max_new_tokens=4)
                for i in range(6)]
        rids = [router.route(r) for r in reqs]
        time.sleep(0.2)
        procs[-1].kill()                        # SIGKILL, mid-stream
        for rid, req in zip(rids, reqs):
            res = router.result(rid, timeout=180)
            assert res is not None and res.status == OK
            assert list(res) == _solo(world, req.prompt, 4)
        # Heal: the poller marks w dead, ticks the supervisor, the
        # relaunched worker boots, probes revive it.  The results can all
        # be in (by failover) before the poller has probed w since the
        # kill, so wait for the respawn itself, not only for two healthy.
        while True:
            _code, health = router.health()
            restarts = sup.state().get("w", {}).get("restarts", 0)
            if restarts >= 1 and health["healthy"] == 2:
                break
            assert time.monotonic() < deadline, router.state_dump()
            time.sleep(0.2)
        st = sup.state()["w"]
        assert st["restarts"] >= 1 and not st["permanent_dead"]
        assert sup.degraded() and health["degraded"]
        assert "supervisor w" in router.state_dump()
        post = Request(prompt=stem + [50], max_new_tokens=4)
        res = router.result(router.route(post), timeout=180)
        assert res.status == OK and list(res) == _solo(world, post.prompt, 4)
    finally:
        router.stop()
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGKILL)
            try:
                p.communicate(timeout=10)
            except subprocess.TimeoutExpired:
                pass
