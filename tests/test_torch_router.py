"""The port's fleet front door (``horovod_tpu_torch/router.py``) against the
JAX package's.

Mirrors ``tests/test_router.py`` (placement, failover, the wire), the
journal cases of ``tests/test_chaos.py`` (accept / terminal records,
idempotency, drain, replay), the router's telemetry cases of
``tests/test_device_telemetry.py`` (the fleet ``/device`` view) and
``tests/test_tracing.py`` (a failover's one trace tree, a journal replay
rejoining its original trace).  The pure pieces (shadow index, policies,
request JSON, journal parsing) are held output-equal to the JAX module's
on the same inputs, and the same workload through the JAX router over JAX
engines and the port's router over port engines gives the same tokens and
the same replica choices.  Engines are ``llama_tiny`` in f32 with the JAX
weights carried over by ``params_from_jax``; the port's solo ``generate``
is the token oracle.

Tolerance: none.  Routing moves no numbers, and greedy decode on the CPU
in f32 gives the same tokens through any replica, so every comparison is
exact.  No assertion waits on a wall-clock limit tighter than the
reference's; results are waited on with generous timeouts.
"""

from __future__ import annotations

import http.server
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from torch_engine_twin import solo, tiny_world

from horovod_tpu_torch import tracing
from horovod_tpu_torch.faults import FaultRegistry
from horovod_tpu_torch.metrics import EventLog, MetricsRegistry
from horovod_tpu_torch.prefix_cache import chunk_path_digests
from horovod_tpu_torch.router import (
    HttpReplica, LeastLoadedPolicy, PrefixAffinityPolicy, ReplicaHandle,
    RoundRobinPolicy, RouterServer, RoutingContext, ShadowPrefixIndex,
    compact_journal, load_journal, maybe_start_router, request_from_json,
    request_to_json, resolve_routing_policy,
)
from horovod_tpu_torch.serving import (FAILED, OK, REJECTED, Request,
                                       RequestResult)
from horovod_tpu_torch.serving_scheduler import ServeEngine

HERE = os.path.dirname(os.path.abspath(__file__))
ROUTER_WORKER = os.path.join(HERE, "multiprocess_router_worker.py")


@pytest.fixture(scope="module")
def world():
    return tiny_world(11)


def _engines(w, n, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("chunk", 8)
    kw.setdefault("prefix_cache", True)
    kw.setdefault("sampler", False)
    return [ServeEngine(w.tp, w.tcfg, **kw) for _ in range(n)]


def _want(w, prompt, n_new, max_len=64):
    return solo(w, prompt, n_new, max_len)


# -- shadow index + policies: no engine, no socket ---------------------------


def test_shadow_prefix_index_matching():
    idx = ShadowPrefixIndex(block_size=4)
    toks = list(range(10, 23))
    idx.observe(toks)
    assert len(idx) == 3
    assert idx.match_tokens(toks) == 12
    assert idx.match_tokens(toks[:9]) == 8
    assert idx.match_tokens(toks[:4] + [99] * 8) == 4
    assert idx.match_tokens([99, 98, 97, 96]) == 0
    cold = ShadowPrefixIndex()
    assert cold.match_tokens(toks) == 0
    cold.load({"block_size": 4, "paths": chunk_path_digests(toks, 4)})
    assert cold.block_size == 4
    assert cold.match_tokens(toks) == 12
    assert cold.approx_footprint_bytes() > 0


def test_shadow_prefix_index_fifo_bound():
    idx = ShadowPrefixIndex(block_size=2, max_paths=4)
    for i in range(8):
        idx.observe([i * 10, i * 10 + 1])
    assert len(idx) == 4
    assert idx.match_tokens([0, 1]) == 0
    assert idx.match_tokens([70, 71]) == 2


def _ctx(inflight, shadows=None, views=None, imbalance=4.0):
    return RoutingContext(views or {}, shadows or {}, inflight, imbalance)


def test_round_robin_and_least_loaded_policies():
    rr = RoundRobinPolicy()
    names = [rr.choose(["a", "b", "c"], None, _ctx({}))[0]
             for _ in range(5)]
    assert names == ["a", "b", "c", "a", "b"]
    ll = LeastLoadedPolicy()
    assert ll.choose(["a", "b"], None, _ctx({"a": 3, "b": 1}))[0] == "b"
    views = {"a": {"goodput": 0.4}, "b": {"goodput": 0.9}}
    assert ll.choose(["a", "b"], None,
                     _ctx({"a": 2, "b": 2}, views=views))[0] == "b"


def test_prefix_affinity_policy_and_imbalance_fallback():
    stem = list(range(10, 27))
    hot, cold = ShadowPrefixIndex(8), ShadowPrefixIndex(8)
    hot.observe(stem)
    shadows = {"hot": hot, "cold": cold}
    pol = PrefixAffinityPolicy()
    req = Request(prompt=stem + [99], max_new_tokens=2)
    name, info = pol.choose(["hot", "cold"], req,
                            _ctx({"hot": 0, "cold": 0}, shadows))
    assert name == "hot"
    assert info == {"affinity_hit_tokens": 16, "fallback": False}
    name, info = pol.choose(["hot", "cold"],
                            Request(prompt=[99, 98], max_new_tokens=2),
                            _ctx({"hot": 2, "cold": 0}, shadows))
    assert name == "cold" and info["affinity_hit_tokens"] == 0
    name, info = pol.choose(["hot", "cold"], req,
                            _ctx({"hot": 5, "cold": 0}, shadows))
    assert name == "cold" and info["fallback"] is True


def test_resolve_routing_policy(monkeypatch):
    assert resolve_routing_policy("round_robin").name == "round_robin"
    inst = LeastLoadedPolicy()
    assert resolve_routing_policy(inst) is inst
    monkeypatch.setenv("HVD_TORCH_ROUTER_POLICY", "least_loaded")
    assert resolve_routing_policy(None).name == "least_loaded"
    monkeypatch.delenv("HVD_TORCH_ROUTER_POLICY")
    assert resolve_routing_policy(None).name == "prefix_affinity"
    with pytest.raises(ValueError, match="unknown routing policy"):
        resolve_routing_policy("best_effort")


def test_request_json_roundtrip():
    req = Request(prompt=[1, 2, 3], max_new_tokens=5, priority=2, slo_s=1.5)
    back = request_from_json(request_to_json(req))
    assert back.prompt == [1, 2, 3] and back.max_new_tokens == 5
    assert back.priority == 2 and back.slo_s == 1.5
    with pytest.raises(ValueError, match="list of token ids"):
        request_from_json({"prompt": "abc", "max_new_tokens": 2})
    with pytest.raises(ValueError, match="max_new_tokens"):
        request_from_json({"prompt": [1], "max_new_tokens": "2"})
    with pytest.raises(ValueError, match="JSON object"):
        request_from_json([1, 2])
    assert request_from_json({"prompt": [1], "max_new_tokens": 1,
                              "priority": None}).priority == 0


def test_request_json_lifecycle_field_validation():
    ok = request_from_json({"prompt": [1], "max_new_tokens": 2,
                            "deadline_s": 1.5, "slo_s": 2,
                            "max_queue_steps": 3, "eos_id": 7})
    assert ok.deadline_s == 1.5 and ok.slo_s == 2
    assert ok.max_queue_steps == 3 and ok.eos_id == 7
    for field, junk in [("deadline_s", "soon"), ("deadline_s", True),
                        ("slo_s", [1]), ("max_queue_steps", 2.5),
                        ("max_queue_steps", "many"), ("eos_id", "eos"),
                        ("priority", "high")]:
        with pytest.raises(ValueError, match=field):
            request_from_json({"prompt": [1], "max_new_tokens": 2,
                               field: junk})


# -- the pure pieces against the JAX module's --------------------------------


def test_shadow_index_and_policies_equal_the_jax_modules():
    from horovod_tpu import router as jr
    from horovod_tpu import serving as js

    from horovod_tpu_torch import router as tr

    rng = np.random.RandomState(0)
    names = ["r0", "r1", "r2"]
    shadows = {m: ({n: m.ShadowPrefixIndex(4, max_paths=12) for n in names})
               for m in (jr, tr)}
    pols = {m: [m.RoundRobinPolicy(), m.LeastLoadedPolicy(),
                m.PrefixAffinityPolicy()] for m in (jr, tr)}
    fams = [list(rng.randint(2, 90, 12)) for _ in range(4)]
    for step in range(60):
        prompt = [int(t) for t in fams[step % 4][:rng.randint(4, 13)]]
        prompt += [int(t) for t in rng.randint(2, 90, rng.randint(0, 5))]
        inflight = {n: int(rng.randint(0, 7)) for n in names}
        views = {n: {"goodput": float(rng.choice([0.5, 1.0]))}
                 for n in names}
        cands = [n for n in names if rng.rand() > 0.2] or names
        picks = {}
        for m, mod_req in ((jr, js.Request), (tr, Request)):
            ctx = m.RoutingContext(views, shadows[m], inflight, 2.0)
            req = mod_req(prompt=prompt, max_new_tokens=2)
            picks[m] = [p.choose(cands, req, ctx) for p in pols[m]]
            chosen = picks[m][2][0]
            shadows[m][chosen].observe(prompt)
            if step % 9 == 0:
                shadows[m][chosen].evict_oldest(3)
        assert picks[jr] == picks[tr], step
        for n in names:
            assert (shadows[jr][n].match_tokens(prompt)
                    == shadows[tr][n].match_tokens(prompt))
            assert len(shadows[jr][n]) == len(shadows[tr][n])


def test_request_json_equals_the_jax_modules():
    from horovod_tpu import router as jr
    from horovod_tpu import serving as js

    fields = dict(prompt=[3, 1, 4, 1, 5], max_new_tokens=6, eos_id=2,
                  deadline_s=2.5, max_queue_steps=9, slo_s=0.75, priority=3)
    assert request_to_json(Request(**fields)) == \
        jr.request_to_json(js.Request(**fields))
    payload = dict(fields, trace={"trace_id": "ab" * 16,
                                  "span_id": "cd" * 8})
    a, b = request_from_json(payload), jr.request_from_json(payload)
    for k in fields:
        assert getattr(a, k) == getattr(b, k), k
    assert a.trace_ctx.to_dict() == b.trace_ctx.to_dict()
    for bad in ({"prompt": [1]}, {"prompt": [1], "max_new_tokens": 1,
                                  "slo_s": "x"}, [1]):
        with pytest.raises(ValueError) as pe:
            request_from_json(bad)
        with pytest.raises(ValueError) as je:
            jr.request_from_json(bad)
        assert str(pe.value) == str(je.value)


def test_journal_parsing_and_compaction_equal_the_jax_modules(tmp_path):
    from horovod_tpu import router as jr

    path = str(tmp_path / "j.jsonl")
    log = EventLog(path)
    for rid, key in enumerate(["a", None, "b", "a", "c", None]):
        log.emit("router.accept", pid=10 + rid % 2, rid=rid, key=key,
                 req={"prompt": [rid + 2], "max_new_tokens": 1})
    log.emit("router.terminal", pid=10, rid=0, key="a", status=OK,
             tokens=[1], error=None)
    log.emit("router.replayed", pid=11, rid=1, key=None)
    log.emit("router.terminal", pid=10, rid=4, key="c", status=FAILED,
             tokens=[], error="x")
    log.close()
    with open(path, "a") as f:
        f.write('{"kind": "router.acc')         # torn last line
    got, want = load_journal(path), jr.load_journal(path)
    assert got == want
    incomplete, terms = got
    p2, p3 = str(tmp_path / "p.jsonl"), str(tmp_path / "q.jsonl")
    keep = incomplete + list(terms.values())
    compact_journal(p2, keep)
    jr.compact_journal(p3, keep)
    assert open(p2).read() == open(p3).read()


# -- routing through real engines --------------------------------------------


def test_affinity_concentrates_shared_prefix(world):
    stem = list(range(2, 19))
    reqs = [Request(prompt=stem + [40 + i], max_new_tokens=4)
            for i in range(4)]
    want = [_want(world, r.prompt, 4) for r in reqs]
    outs = {}
    for policy in ("round_robin", "prefix_affinity"):
        router = RouterServer(_engines(world, 2), policy=policy,
                              sampler=False)
        try:
            rids = [router.route(r) for r in reqs]
            res = [router.result(rid, timeout=60) for rid in rids]
            assert all(r.status == OK for r in res)
            assert [list(r) for r in res] == want
            outs[policy] = {rep["name"]: rep["routed"]
                            for rep in router.replicas_report()}
            snap = router.metrics.snapshot()
            assert snap["counters"][f"router.routed.{policy}"] == 4
            if policy == "prefix_affinity":
                hist = snap["histograms"]["router.affinity_hit_tokens"]
                assert hist["count"] == 4 and hist["max"] == 16.0
        finally:
            router.stop()
    assert sorted(outs["round_robin"].values()) == [2, 2]
    assert sorted(outs["prefix_affinity"].values()) == [0, 4]


def test_admission_shed_and_rejected_passthrough(world):
    router = RouterServer(_engines(world, 1), policy="round_robin",
                          min_goodput=2.0, sampler=False)
    try:
        rid = router.route(Request(prompt=[3, 5], max_new_tokens=2))
        res = router.result(rid, timeout=10)
        assert res.status == REJECTED and list(res) == []
        code, body = router.handle_generate(
            Request(prompt=[3, 5], max_new_tokens=2))
        assert code == 429 and body["shed"] == "goodput"
        snap = router.metrics.snapshot()
        assert snap["counters"]["router.sheds"] == 2
        assert snap["counters"]["router.requests"] == 2
    finally:
        router.stop()
    router = RouterServer(_engines(world, 1), policy="round_robin",
                          sampler=False)
    try:
        rid = router.route(Request(prompt=[], max_new_tokens=2))
        res = router.result(rid, timeout=30)
        assert res.status == REJECTED
        assert router.metrics.snapshot()["counters"][
            "router.failovers"] == 0
    finally:
        router.stop()


def test_failover_outputs_bit_identical(world):
    fr = FaultRegistry()
    router = RouterServer(_engines(world, 2), policy="round_robin",
                          faults=fr, sampler=False)
    fr.inject("serve.router", key="replica0", on_hit=3, permanent=True)
    try:
        reqs = [Request(prompt=[2 + i, 3 + i, 5 + i, 7 + i],
                        max_new_tokens=6) for i in range(4)]
        rids = [router.route(r) for r in reqs]
        res = [router.result(rid, timeout=60) for rid in rids]
        assert all(r.status == OK for r in res)
        for req, r in zip(reqs, res):
            assert list(r) == _want(world, req.prompt, 6)
        snap = router.metrics.snapshot()
        assert snap["counters"]["router.replica_deaths"] == 1
        assert snap["counters"]["router.failovers"] >= 1
        assert snap["gauges"]["router.replicas_healthy"] == 1
        report = {rep["name"]: rep for rep in router.replicas_report()}
        assert not report["replica0"]["healthy"]
        assert report["replica1"]["healthy"]
        fr.inject("serve.router", key="replica1", on_hit=1, permanent=True)
        rid = router.route(Request(prompt=[9, 8, 7], max_new_tokens=4))
        res = router.result(rid, timeout=60)
        assert res.status == FAILED
        assert "no healthy replicas" in str(res.error)
        code, body = router.health()
        assert code == 503 and body["healthy"] == 0
    finally:
        router.stop()
        fr.clear()


class _EchoReplica(ReplicaHandle):
    """Completes every submission at once with OK(prompt): a replica with
    no engine behind it, for the router's bookkeeping."""

    def __init__(self, name: str = "echo"):
        self.name = name

    def submit(self, req, done_cb):
        done_cb(RequestResult(list(req.prompt), OK))

    def probe(self):
        return {"healthy": True, "inflight": 0, "queue_depth": 0,
                "goodput": 1.0, "free_kv_frac": 1.0, "prefix": None}


class _CrashingReplica(_EchoReplica):
    """Signals death in flight for every submission, probing healthy."""

    def submit(self, req, done_cb):
        done_cb(None)


class _BlackHole(ReplicaHandle):
    """Accepts submissions and never answers."""

    name = "hole"
    block_size = 8

    def __init__(self):
        self.cbs = []

    def submit(self, req, done_cb):
        self.cbs.append(done_cb)

    def probe(self):
        return {"healthy": True, "inflight": len(self.cbs),
                "queue_depth": 0, "goodput": 1.0, "free_kv_frac": 1.0}


def test_malformed_lifecycle_request_rejected_not_fatal(world):
    router = RouterServer(_engines(world, 1), policy="round_robin",
                          sampler=False)
    try:
        rid = router.route(Request(prompt=[2, 3], max_new_tokens=2,
                                   deadline_s="soon"))
        res = router.result(rid, timeout=30)
        assert res.status == REJECTED
        snap = router.metrics.snapshot()
        assert snap["counters"]["router.replica_deaths"] == 0
        assert snap["counters"]["router.failovers"] == 0
        rid = router.route(Request(prompt=[2, 3], max_new_tokens=2))
        assert router.result(rid, timeout=60).status == OK
    finally:
        router.stop()


def test_failover_cap_stops_poison_cascade():
    router = RouterServer([_CrashingReplica("a"), _CrashingReplica("b")],
                          policy="round_robin", max_failovers=3,
                          sampler=False)
    try:
        rid = router.route(Request(prompt=[1, 2], max_new_tokens=2))
        res = router.result(rid, timeout=10)
        assert res.status == FAILED
        assert "failed over 3 times" in str(res.error)
        snap = router.metrics.snapshot()
        assert snap["counters"]["router.failovers"] == 3
        assert snap["gauges"]["router.inflight"] == 0
    finally:
        router.stop()


def test_ticket_reaping_bounds_the_table():
    router = RouterServer([_EchoReplica()], policy="round_robin",
                          ticket_ttl_s=0.0, sampler=False)
    try:
        code, body = router.handle_generate(
            Request(prompt=[4, 2], max_new_tokens=1))
        assert code == 200 and body["tokens"] == [4, 2]
        assert router.memory_report()["tickets"] == 0
        rid = router.route(Request(prompt=[7], max_new_tokens=1))
        assert router.result(rid, timeout=10).status == OK
        assert router.memory_report()["tickets"] == 1
        router.poll_now()
        assert router.memory_report()["tickets"] == 0
        with pytest.raises(KeyError, match="unknown router rid"):
            router.result(rid)
    finally:
        router.stop()


def test_probe_debounce_and_http_revival():
    class _Flaky(_EchoReplica):
        can_revive = True
        healthy = True

        def probe(self):
            return dict(super().probe(), healthy=self.healthy)

    flaky = _Flaky("flaky")
    router = RouterServer([flaky, _EchoReplica()], policy="round_robin",
                          probe_fails=3, sampler=False)
    try:
        def healthy_gauge():
            return router.metrics.snapshot()["gauges"][
                "router.replicas_healthy"]

        flaky.healthy = False
        router.poll_now()
        router.poll_now()
        assert healthy_gauge() == 2
        flaky.healthy = True
        router.poll_now()
        flaky.healthy = False
        router.poll_now()
        router.poll_now()
        assert healthy_gauge() == 2
        router.poll_now()
        assert healthy_gauge() == 1
        report = {r["name"]: r for r in router.replicas_report()}
        assert not report["flaky"]["healthy"]
        flaky.healthy = True
        router.poll_now()
        assert healthy_gauge() == 2
        snap = router.metrics.snapshot()
        assert snap["counters"]["router.replica_deaths"] == 1
        assert snap["counters"]["router.replica_revives"] == 1
    finally:
        router.stop()


def test_http_replica_timeout_is_terminal_not_failover():
    class _Slow(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            time.sleep(0.8)
            try:
                body = b'{"tokens": [], "status": "OK"}'
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except Exception:
                pass

        def log_message(self, fmt, *args):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), _Slow)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        slow = HttpReplica("slow", f"http://127.0.0.1:{srv.server_address[1]}",
                           timeout_s=0.2)
        got: list = []
        ev = threading.Event()
        slow.submit(Request(prompt=[1], max_new_tokens=1),
                    lambda r: (got.append(r), ev.set()))
        assert ev.wait(10)
        assert got[0] is not None and got[0].status == FAILED
    finally:
        srv.shutdown()
        srv.server_close()
    refused = HttpReplica("refused", "http://127.0.0.1:9", timeout_s=0.5)
    got2: list = []
    ev2 = threading.Event()
    refused.submit(Request(prompt=[1], max_new_tokens=1),
                   lambda r: (got2.append(r), ev2.set()))
    assert ev2.wait(10)
    assert got2[0] is None
    rep = HttpReplica("r", "http://example.invalid", timeout_s=30.0)
    assert rep._request_timeout_s(Request(prompt=[1],
                                          max_new_tokens=1)) == 30.0
    assert rep._request_timeout_s(Request(prompt=[1], max_new_tokens=1,
                                          deadline_s=45.0)) == 75.0


def test_memory_report_counts_shadow_indexes(world):
    router = RouterServer(_engines(world, 2), policy="prefix_affinity",
                          sampler=False)
    try:
        rid = router.route(Request(prompt=list(range(2, 19)),
                                   max_new_tokens=2))
        assert router.result(rid, timeout=60).status == OK
        mem = router.memory_report()
        assert mem["approx_footprint_bytes"] == sum(
            mem["shadow_index_bytes"].values())
        assert set(mem["shadow_index_bytes"]) == {"replica0", "replica1"}
        assert router.metrics.snapshot()["gauges"][
            "router.shadow_index_bytes"] == mem["approx_footprint_bytes"]
    finally:
        router.stop()


def test_poller_merges_replica_digests(world):
    engines = _engines(world, 2)
    stem = list(range(2, 19))
    engines[1].run([Request(prompt=stem + [77], max_new_tokens=2)])
    router = RouterServer(engines, policy="prefix_affinity", sampler=False)
    try:
        router.poll_now()
        rid = router.route(Request(prompt=stem + [88], max_new_tokens=2))
        assert router.result(rid, timeout=60).status == OK
        report = {rep["name"]: rep for rep in router.replicas_report()}
        assert report["replica1"]["routed"] == 1
        assert report["replica0"]["routed"] == 0
        view = report["replica1"]["view"]
        assert view["healthy"] and view["free_kv_frac"] > 0
    finally:
        router.stop()


def test_http_front_door(world):
    router = RouterServer(_engines(world, 1), policy="round_robin",
                          sampler=False).start()
    base = f"http://{router.host}:{router.port}"
    try:
        body = json.dumps({"prompt": [5, 17, 42],
                           "max_new_tokens": 4}).encode()
        req = urllib.request.Request(
            base + "/v1/generate", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read())
        assert out["status"] == OK and out["replica"] == "replica0"
        assert out["tokens"] == _want(world, [5, 17, 42], 4)
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            assert json.loads(r.read())["ok"]
        with urllib.request.urlopen(base + "/replicas", timeout=10) as r:
            assert json.loads(r.read())[0]["routed"] == 1
        with urllib.request.urlopen(base + "/snapshot", timeout=10) as r:
            snap = json.loads(r.read())
        assert snap["counters"]["router.requests"] == 1
        assert snap["replicas"][0]["name"] == "replica0"
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            text = r.read().decode()
        assert "router_requests 1" in text
        assert "# HELP router_sheds" in text
        for path in ("/nope", "/autoscaler"):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(base + path, timeout=10)
            assert e.value.code == 404
    finally:
        router.stop()


def test_multiprocess_router_real_sockets(world):
    """Stdlib-only client processes (the reference's worker, unchanged)
    hammer one port router and read byte-identical token payloads."""
    router = RouterServer(_engines(world, 2), policy="prefix_affinity",
                          sampler=False).start()
    try:
        procs = []
        for wid in range(2):
            env = dict(os.environ)
            env["ROUTER_URL"] = f"http://{router.host}:{router.port}"
            env["ROUTER_WORKER_ID"] = str(wid)
            procs.append(subprocess.Popen(
                [sys.executable, ROUTER_WORKER], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        outs = [p.communicate(timeout=180)[0] for p in procs]
        payloads = []
        for i, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"worker {i} rc={p.returncode}:\n{out}"
            payloads.append(out.split("WORKER_OK ", 1)[1].splitlines()[0])
        assert payloads[0] == payloads[1]
        tokens = json.loads(payloads[0])["results"][0]["tokens"]
        assert tokens == _want(world, list(range(2, 19)) + [40], 4)
    finally:
        router.stop()


# -- the JAX fleet and the port's, side by side ------------------------------


def test_same_tokens_and_replica_choices_as_the_jax_fleet(world):
    """The same shared-prefix waves through the JAX router over JAX engines
    and the port's router over port engines: each wave waits for its
    results, then one ``poll_now`` pass on each router feeds the replicas'
    digests back, so both routers see the same fleet state."""
    from horovod_tpu import router as jr
    from horovod_tpu import serving as js
    from horovod_tpu.serving_scheduler import ServeEngine as JaxEngine

    kw = dict(n_slots=2, max_len=64, chunk=8, prefix_cache=True)
    jeng = [JaxEngine(world.jp, world.jcfg, sampler=False, **kw)
            for _ in range(2)]
    jrouter = jr.RouterServer(jeng, policy="prefix_affinity", sampler=False)
    trouter = RouterServer(_engines(world, 2), policy="prefix_affinity",
                           sampler=False)
    fams = [[(7 * g + i) % 80 + 2 for i in range(16)] for g in range(3)]
    try:
        for w in range(3):
            wave = [fams[g] + [40 + 3 * w + g] for g in range(3)]
            got = {}
            for name, router, mk in (("jax", jrouter, js.Request),
                                     ("port", trouter, Request)):
                rids = [router.route(mk(prompt=p, max_new_tokens=4))
                        for p in wave]
                res = [router.result(rid, timeout=120) for rid in rids]
                assert all(r.status == OK for r in res)
                with router._lock:
                    reps = [router._tickets[rid].replica for rid in rids]
                got[name] = ([[int(t) for t in r] for r in res], reps)
                router.poll_now()
            assert got["jax"] == got["port"], w
            assert got["port"][0] == [_want(world, p, 4) for p in wave]
        assert ({r["name"]: r["routed"] for r in jrouter.replicas_report()}
                == {r["name"]: r["routed"] for r in trouter.replicas_report()})
    finally:
        jrouter.stop()
        trouter.stop()


# -- the request journal (tests/test_chaos.py's journal cases) ---------------


def test_torn_journal_line_tolerated(tmp_path):
    path = str(tmp_path / "journal.jsonl")
    log = EventLog(path)
    log.emit("router.accept", rid=0, key="k0",
             req={"prompt": [2, 3, 4], "max_new_tokens": 2})
    log.emit("router.accept", rid=1, key=None,
             req={"prompt": [5, 6], "max_new_tokens": 2})
    log.emit("router.terminal", rid=1, key=None, status=OK, tokens=[9],
             error=None)
    log.close()
    with open(path, "a") as f:
        f.write('{"kind": "router.acc')
    incomplete, terms = load_journal(path)
    assert [r["key"] for r in incomplete] == ["k0"] and terms == {}
    log = EventLog(path)
    log.emit("router.accept", rid=7, key="dup",
             req={"prompt": [2], "max_new_tokens": 1})
    log.emit("router.accept", rid=8, key="dup",
             req={"prompt": [2], "max_new_tokens": 1})
    log.emit("router.terminal", rid=0, key="k0", status=OK, tokens=[1, 2],
             error=None)
    log.close()
    incomplete, terms = load_journal(path)
    assert [r["key"] for r in incomplete] == ["dup"]
    assert terms["k0"]["tokens"] == [1, 2]


def test_journal_accept_terminal_roundtrip_and_drain(world, tmp_path):
    path = str(tmp_path / "journal.jsonl")
    router = RouterServer(_engines(world, 1), policy="round_robin",
                          journal=path, sampler=False)
    rid = router.route(Request(prompt=[5, 17, 42], max_new_tokens=4),
                       idempotency_key="req-A")
    res = router.result(rid, timeout=120)
    assert res is not None and res.status == OK
    assert list(res) == _want(world, [5, 17, 42], 4)
    rid2 = router.route(Request(prompt=[5, 17, 42, 7], max_new_tokens=4))
    router.stop(drain_s=60.0)
    res2 = router.result(rid2, timeout=0)
    assert res2 is not None and res2.status == OK
    incomplete, terms = load_journal(path)
    assert incomplete == [] and list(terms) == ["req-A"]
    assert terms["req-A"]["tokens"] == [int(t) for t in res]
    assert router.metrics.snapshot()["counters"][
        "router.journal_appends"] == 4


def test_journal_dedup_terminal_inflight_and_restart(world, tmp_path):
    path = str(tmp_path / "journal.jsonl")
    req = Request(prompt=[3, 9, 27, 81], max_new_tokens=4)
    router = RouterServer(_engines(world, 1), policy="round_robin",
                          journal=path, sampler=False)
    try:
        res1 = router.result(router.route(req, idempotency_key="pay-once"),
                             timeout=120)
        assert res1.status == OK
        res2 = router.result(router.route(req, idempotency_key="pay-once"),
                             timeout=10)
        assert list(res2) == list(res1)
        counters = router.metrics.snapshot()["counters"]
        assert counters["router.journal_dedups"] == 1
        assert counters["router.routed.round_robin"] == 1
    finally:
        router.stop()
    router = RouterServer(_engines(world, 1), policy="round_robin",
                          journal=path, sampler=False)
    try:
        res3 = router.result(router.route(req, idempotency_key="pay-once"),
                             timeout=10)
        assert list(res3) == list(res1)
        counters = router.metrics.snapshot()["counters"]
        assert counters["router.journal_dedups"] == 1
        assert counters["router.routed.round_robin"] == 0
    finally:
        router.stop()
    hole = _BlackHole()
    router = RouterServer([hole], journal=str(tmp_path / "j2.jsonl"),
                          sampler=False)
    try:
        rid_a = router.route(req, idempotency_key="k-live")
        rid_b = router.route(req, idempotency_key="k-live")
        assert len(hole.cbs) == 1
        assert router.result(rid_b, timeout=0) is None
        hole.cbs[0](RequestResult([11, 12, 13], OK))
        assert list(router.result(rid_a, timeout=10)) == [11, 12, 13]
        assert list(router.result(rid_b, timeout=10)) == [11, 12, 13]
        assert router.metrics.snapshot()["counters"][
            "router.journal_dedups"] == 1
    finally:
        router.stop()


def test_journal_write_fault_degrades_not_fails(world, tmp_path):
    fr = FaultRegistry()
    fr.inject("router.journal", on_hit=1, key="router.accept")
    router = RouterServer(_engines(world, 1), policy="round_robin",
                          journal=str(tmp_path / "journal.jsonl"), faults=fr,
                          sampler=False)
    try:
        res = router.result(router.route(
            Request(prompt=[5, 17, 42], max_new_tokens=4),
            idempotency_key="k"), timeout=120)
        assert res.status == OK
        assert list(res) == _want(world, [5, 17, 42], 4)
        counters = router.metrics.snapshot()["counters"]
        assert counters["router.journal_errors"] == 1
        assert counters["router.journal_appends"] == 1
        assert fr.log == [("router.journal", "router.accept", 1)]
    finally:
        router.stop()


def test_drain_timeout_fails_open_and_replays_next_incarnation(
        world, tmp_path):
    path = str(tmp_path / "journal.jsonl")
    req = Request(prompt=[5, 17, 42], max_new_tokens=4)
    router = RouterServer([_BlackHole()], journal=path, sampler=False)
    rid = router.route(req, idempotency_key="lost-boy")
    router.stop(drain_s=0.05)
    res = router.result(rid, timeout=0)
    assert res is not None and res.status == FAILED
    assert "shut down" in str(res.error)
    incomplete, terms = load_journal(path)
    assert [r["key"] for r in incomplete] == ["lost-boy"] and terms == {}
    router = RouterServer(_engines(world, 1), policy="round_robin",
                          journal=path, sampler=False)
    try:
        assert router.replay_journal() == 1
        res2 = router.result(router.route(req, idempotency_key="lost-boy"),
                             timeout=120)
        assert res2.status == OK
        assert list(res2) == _want(world, [5, 17, 42], 4)
        counters = router.metrics.snapshot()["counters"]
        assert counters["router.journal_replays"] == 1
        assert counters["router.journal_dedups"] == 1
        assert router.replay_journal() == 0
    finally:
        router.stop()
    assert load_journal(path)[0] == []


def test_stop_releases_parked_idempotency_waiters(tmp_path):
    path = str(tmp_path / "journal.jsonl")
    req = Request(prompt=[5, 17, 42], max_new_tokens=4)
    hole = _BlackHole()
    router = RouterServer([hole], journal=path, sampler=False)
    rid_orig = router.route(req, idempotency_key="stuck")
    rid_dup = router.route(req, idempotency_key="stuck")
    assert len(hole.cbs) == 1
    router.stop(drain_s=0.05)
    for rid in (rid_orig, rid_dup):
        res = router.result(rid, timeout=0)
        assert res is not None and res.status == FAILED
        assert "shut down" in str(res.error)
    assert router._journal_waiters == {} and router._journal_inflight == {}
    incomplete, terms = load_journal(path)
    assert [r["key"] for r in incomplete] == ["stuck"] and terms == {}


def test_stop_releases_http_handler_threads(tmp_path):
    req = Request(prompt=[5, 17, 42], max_new_tokens=4)
    hole = _BlackHole()
    router = RouterServer([hole], journal=str(tmp_path / "j.jsonl"),
                          sampler=False)
    out = []
    threads = [threading.Thread(
        target=lambda: out.append(router.handle_generate(req, "k")))
        for _ in range(2)]
    for t in threads:
        t.start()
    deadline = time.time() + 60
    while len(hole.cbs) < 1 or len(router._journal_waiters.get("k", [])) < 1:
        assert time.time() < deadline, "requests never reached the router"
        time.sleep(0.01)
    router.stop(drain_s=0.05)
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert sorted(body["status"] for _code, body in out) == [FAILED, FAILED]
    with router._lock:
        assert router._tickets == {}


def test_unkeyed_replay_converges_across_restarts(world, tmp_path):
    path = str(tmp_path / "journal.jsonl")
    log = EventLog(path)
    log.emit("router.accept", pid=424242, rid=0, key=None,
             req={"prompt": [5, 17, 42], "max_new_tokens": 4})
    log.close()
    router = RouterServer(_engines(world, 1), policy="round_robin",
                          journal=path, sampler=False)
    try:
        assert router.replay_journal() == 1
        deadline = time.time() + 120
        while time.time() < deadline and load_journal(path)[0]:
            time.sleep(0.05)
        assert load_journal(path)[0] == []
    finally:
        router.stop()
    router = RouterServer(_engines(world, 1), policy="round_robin",
                          journal=path, sampler=False)
    try:
        assert router.replay_journal() == 0
        assert router.metrics.snapshot()["counters"][
            "router.journal_replays"] == 0
    finally:
        router.stop()


def test_journal_keys_lru_bound_and_startup_compaction(tmp_path):
    path = str(tmp_path / "journal.jsonl")
    hole = _BlackHole()
    router = RouterServer([hole], journal=path, journal_keys=2,
                          sampler=False)

    def run(key, tokens):
        rid = router.route(Request(prompt=[2, 3], max_new_tokens=1),
                           idempotency_key=key)
        hole.cbs[-1](RequestResult(tokens, OK))
        return router.result(rid, timeout=10)

    run("k1", [1])
    run("k2", [2])
    run("k3", [3])
    with router._lock:
        assert list(router._journal_results) == ["k2", "k3"]
    n_subs = len(hole.cbs)
    run("k1", [1])
    assert len(hole.cbs) == n_subs + 1
    rid = router.route(Request(prompt=[2, 3], max_new_tokens=1),
                       idempotency_key="k3")
    assert len(hole.cbs) == n_subs + 1
    assert list(router.result(rid, timeout=10)) == [3]
    with router._lock:
        assert list(router._journal_results) == ["k1", "k3"]
    router.stop()
    router = RouterServer([_BlackHole()], journal=path, journal_keys=2,
                          sampler=False)
    try:
        with open(path) as f:
            recs = [json.loads(ln) for ln in f if ln.strip()]
        assert [r["kind"] for r in recs] == ["router.terminal"] * 2
        assert sorted(r["key"] for r in recs) == ["k1", "k3"]
    finally:
        router.stop()


def test_http_idempotency_and_state_endpoint(world, tmp_path):
    router = RouterServer(_engines(world, 1), policy="round_robin",
                          journal=str(tmp_path / "journal.jsonl"),
                          sampler=False).start()
    base = f"http://{router.host}:{router.port}"
    try:
        body = json.dumps({"prompt": [5, 17, 42], "max_new_tokens": 4,
                           "idempotency_key": "wire-key"}).encode()

        def _post():
            req = urllib.request.Request(
                base + "/v1/generate", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                return json.loads(r.read())

        first, second = _post(), _post()
        assert first["status"] == OK and second["status"] == OK
        assert first["tokens"] == second["tokens"]
        assert router.metrics.snapshot()["counters"][
            "router.journal_dedups"] == 1
        with pytest.raises(urllib.error.HTTPError) as e:
            req = urllib.request.Request(
                base + "/v1/generate",
                data=json.dumps({"prompt": [1],
                                 "idempotency_key": 7}).encode(),
                headers={"Content-Type": "application/json"})
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 400
        with urllib.request.urlopen(base + "/state", timeout=10) as r:
            dump = r.read().decode()
        assert "RouterServer" in dump
        assert "journal:" in dump and "replica0" in dump
    finally:
        router.stop()


# -- telemetry: the fleet /device view and the router's traces ----------------


def test_router_fleet_device_view(world):
    engines = [ServeEngine(world.tp, world.tcfg, n_slots=2, max_len=32,
                           chunk=8, sampler=False,
                           device_telemetry=(i == 0)) for i in range(2)]
    router = RouterServer(engines, policy="round_robin", sampler=False)
    router.start()
    try:
        rep = router.device_report()
        assert len(rep["replicas"]) == 1
        assert rep["without_telemetry"] == [
            n for n in sorted(r["name"] for r in router.replicas_report())
            if n not in rep["replicas"]]
        assert rep["summary"]["n_reporting"] == 1
        (one,) = rep["replicas"].values()
        assert set(one["programs"]) == {"tick", "chunk", "set_row"}
        url = f"http://{router.host}:{router.port}/device"
        with urllib.request.urlopen(url, timeout=10) as r:
            assert json.loads(r.read())["summary"]["n_reporting"] == 1
    finally:
        router.stop()


def _walk(root):
    stack = [root]
    while stack:
        node = stack.pop()
        stack.extend(node["children"])
        yield node


def _traced_engine(world, reg):
    return ServeEngine(world.tp, world.tcfg, n_slots=2, max_len=64, chunk=8,
                       metrics=reg, sampler=False)


def test_failover_trace_is_one_tree_spanning_replicas(world, tmp_path):
    log = EventLog(str(tmp_path / "events.jsonl"))
    engines = [_traced_engine(world, MetricsRegistry(event_log=log))
               for _ in range(2)]
    fr = FaultRegistry()
    router = RouterServer(engines, policy="round_robin", faults=fr,
                          registry=MetricsRegistry(event_log=log),
                          sampler=False)
    fr.inject("serve.router", key="replica0", on_hit=2, permanent=True)
    try:
        ctx = tracing.TraceContext.root("acceptance", "client", 1.0, 0)
        req = Request(prompt=[2, 3, 5, 7], max_new_tokens=6)
        req.trace_ctx = ctx
        send_ts = time.monotonic()
        res = router.result(router.route(req), timeout=120)
        done_ts = time.monotonic()
        assert res is not None and res.status == OK
        snap = router.metrics.snapshot()
        assert snap["counters"]["router.failovers"] >= 1
        assert snap["counters"]["router.replica_deaths"] == 1
        router.tracer.span(ctx, "client", send_ts, done_ts,
                           status=res.status)
        e2e = snap["histograms"]["router.e2e_s"]
        assert any(e["trace_id"] == ctx.trace_id
                   for e in e2e["exemplars"].values())
    finally:
        router.stop()
        fr.clear()
    forest = tracing.build_forest(EventLog.read(str(tmp_path
                                                    / "events.jsonl")))
    assert list(forest) == [ctx.trace_id]
    main = [r for r in forest[ctx.trace_id] if not r["orphan"]]
    assert len(main) == 1 and main[0]["name"] == "client"
    nodes = list(_walk(main[0]))
    rreq = [n for n in nodes if n["name"] == "router.request"]
    assert len(rreq) == 1 and rreq[0]["parent_id"] == ctx.span_id
    assert rreq[0]["attrs"]["failovers"] >= 1
    attempts = [n for n in nodes if n["name"] == "replica.attempt"]
    assert len(attempts) == 2
    first = next(a for a in attempts
                 if a["parent_id"] == rreq[0]["span_id"])
    assert first["attrs"]["replica"] == "replica0"
    assert first["attrs"]["status"] == "failover"
    second = next(a for a in attempts if a is not first)
    assert second["parent_id"] == first["span_id"]
    assert second["attrs"]["replica"] == "replica1"
    assert second["attrs"]["status"] == OK
    serves = [n for n in nodes if n["name"] == "serve.request"]
    assert len(serves) == 2
    dead = next(s for s in serves if s["unclosed"])
    live = next(s for s in serves if not s["unclosed"])
    assert dead["parent_id"] == first["span_id"]
    assert live["parent_id"] == second["span_id"]
    assert {"serve.queue", "serve.prefill", "serve.decode"} <= {
        c["name"] for c in live["children"]}
    cp = tracing.critical_path(main[0])
    assert abs(sum(e["self_s"] for e in cp) - (done_ts - send_ts)) < 1e-3


def test_journal_replay_rejoins_original_trace(world, tmp_path):
    tid = tracing.trace_id_for("incarnation-1", 0)
    dead_root = tracing.child_span_id(tid, "", "client")
    dead_span = tracing.child_span_id(tid, dead_root, "router.request")
    jpath = str(tmp_path / "journal.jsonl")
    jl = EventLog(jpath)
    jl.emit("router.accept", rid=0, key="crash-1",
            req={"prompt": [5, 6, 7], "max_new_tokens": 3},
            trace={"trace_id": tid, "span_id": dead_span})
    jl.close()
    epath = str(tmp_path / "events.jsonl")
    log = EventLog(epath)
    router = RouterServer(
        [_traced_engine(world, MetricsRegistry(event_log=log))],
        policy="round_robin", journal=jpath,
        registry=MetricsRegistry(event_log=log), sampler=False)
    try:
        assert router.replay_journal() == 1
        res = router.result(router.route(
            Request(prompt=[5, 6, 7], max_new_tokens=3),
            idempotency_key="crash-1"), timeout=120)
        assert res is not None and res.status == OK
    finally:
        router.stop()
    forest = tracing.build_forest(EventLog.read(epath))
    replayed = [r for r in forest[tid] if r["name"] == "router.request"]
    assert len(replayed) == 1
    node = replayed[0]
    assert node["orphan"] and node["parent_id"] == dead_span
    assert node["span_id"] == tracing.child_span_id(tid, dead_span,
                                                    "router.request")
    assert any(n["name"] == "serve.request" and not n["unclosed"]
               for n in _walk(node))


# -- the autoscaler: attached by argument or knob, served at /autoscaler ------


def test_autoscaler_is_attached_and_reported(monkeypatch):
    """``autoscaler=`` and ``HVD_TORCH_AUTOSCALE=1`` attach a live
    ``FleetAutoscaler`` (the poller ticks it, ``/autoscaler`` reports it,
    ``health()`` carries its epoch); without either there is none."""
    from horovod_tpu_torch.autoscaler import FleetAutoscaler

    monkeypatch.setenv("HVD_TORCH_AUTOSCALE", "0")
    router = RouterServer([_EchoReplica()], sampler=False)
    try:
        assert router.autoscaler is None
        assert "epoch" not in router.health()[1]
    finally:
        router.stop()
    monkeypatch.setenv("HVD_TORCH_AUTOSCALE_COOLDOWN_S", "0")
    router = RouterServer([_EchoReplica()], sampler=False,
                          autoscaler=True).start()
    try:
        asc = router.autoscaler
        assert isinstance(asc, FleetAutoscaler) and asc.enabled
        assert asc.cooldown_s == 0.0 and asc.router is router
        with urllib.request.urlopen(
                f"http://{router.host}:{router.port}/autoscaler",
                timeout=30) as r:
            body = json.loads(r.read())
        assert body["enabled"] and body["size"] == 1
        assert body["epoch"]["members"] == [router.replicas[0].name]
        assert router.health()[1]["epoch"] == 0
        assert "autoscaler: epoch=0" in router.state_dump()
    finally:
        router.stop()
    with pytest.raises(ValueError, match="autoscaler must be"):
        RouterServer([_EchoReplica()], sampler=False, autoscaler=object())
    with pytest.raises(ValueError, match="autoscaler must be"):
        RouterServer([_EchoReplica()], sampler=False, autoscaler=False)
    monkeypatch.setenv("HVD_TORCH_AUTOSCALE", "1")
    monkeypatch.setenv("HVD_TORCH_AUTOSCALE_MAX_REPLICAS", "3")
    router = RouterServer([_EchoReplica()])
    try:
        asc = router.autoscaler
        assert isinstance(asc, FleetAutoscaler) and asc.enabled
        assert asc.max_replicas == 3 and router.advisor is not None
        router.poll_now()                   # the poller's tick runs it
        assert asc.report()["last_decision"] is not None
    finally:
        router.stop()


def test_cordon_uncordon_add_and_retire():
    """The membership surface: a cordoned replica gets no new placements
    (unless every live one is cordoned), a retired one leaves the fleet,
    and the last replica is never retired."""
    router = RouterServer([_EchoReplica("a"), _EchoReplica("b")],
                          policy="round_robin", sampler=False)
    try:
        router.cordon_replica("a")
        assert router.cordoned() == ["a"]
        for _ in range(3):
            code, body = router.handle_generate(
                Request(prompt=[1], max_new_tokens=1))
            assert code == 200 and body["replica"] == "b"
        router.cordon_replica("b")              # all cordoned: still serves
        assert router.handle_generate(
            Request(prompt=[2], max_new_tokens=1))[0] == 200
        router.uncordon_replica("a")
        router.uncordon_replica("b")
        router.add_replica(_EchoReplica("c"))
        with pytest.raises(ValueError, match="duplicate"):
            router.add_replica(_EchoReplica("c"))
        assert {r["name"] for r in router.replicas_report()} == {"a", "b",
                                                                 "c"}
        router.retire_replica("a")
        router.retire_replica("b")
        assert [r.name for r in router.replicas] == ["c"]
        with pytest.raises(ValueError, match="last replica"):
            router.retire_replica("c")
        with pytest.raises(KeyError):
            router.cordon_replica("a")
        router.poll_now()
        assert router.metrics.snapshot()["gauges"]["router.fleet_size"] == 1
    finally:
        router.stop()


def test_maybe_start_router_reads_its_port(monkeypatch):
    monkeypatch.delenv("HVD_TORCH_ROUTER_PORT", raising=False)
    assert maybe_start_router([_EchoReplica()]) is None
    monkeypatch.setenv("HVD_TORCH_ROUTER_PORT", "not-a-port")
    with pytest.warns(RuntimeWarning, match="not an int"):
        assert maybe_start_router([_EchoReplica()]) is None
    monkeypatch.setenv("HVD_TORCH_ROUTER_PORT", "0")
    router = maybe_start_router([_EchoReplica()], sampler=False)
    try:
        with urllib.request.urlopen(
                f"http://{router.host}:{router.port}/healthz",
                timeout=10) as r:
            assert json.loads(r.read())["ok"]
    finally:
        router.stop()


# the router's tuning settings: (constructor argument, the reference's knob)
_TUNING = (("max_failovers", "MAX_FAILOVERS"), ("imbalance", "IMBALANCE"),
           ("drain_s", "DRAIN_S"), ("probe_fails", "PROBE_FAILS"),
           ("ticket_ttl_s", "TICKET_TTL_S"), ("journal_keys", "JOURNAL_KEYS"),
           ("min_goodput", "MIN_GOODPUT"), ("min_free_kv", "MIN_FREE_KV"),
           ("shadow_max_bytes", "SHADOW_MAX_MB"), ("poll_s", "POLL_S"))


@pytest.mark.parametrize("attr,name", _TUNING, ids=[a for a, _ in _TUNING])
def test_router_knobs_set_the_defaults(attr, name, monkeypatch):
    """The router's tuning settings are constructor arguments whose
    defaults are the reference's knob defaults; the deployment settings
    (policy, poll period, journal, port) stay env knobs."""
    from horovod_tpu import knobs as jknobs

    want = float({k.name: k.default for k in jknobs.knobs()}[
        f"HVD_TPU_ROUTER_{name}"])
    if name == "SHADOW_MAX_MB":
        want *= 1024 * 1024
    router = RouterServer([_EchoReplica()], sampler=False)
    try:
        assert getattr(router, attr) == want
    finally:
        router.stop()
    if name == "POLL_S":
        monkeypatch.setenv("HVD_TORCH_ROUTER_POLL_S", "0.25")
        router = RouterServer([_EchoReplica()], sampler=False)
    else:
        router = RouterServer([_EchoReplica()], sampler=False,
                              **{attr: 5})
    try:
        assert getattr(router, attr) == (0.25 if name == "POLL_S" else 5)
    finally:
        router.stop()


def test_port_engine_probe_view(world):
    """LocalReplica reads the port engine's seam: free + cached blocks
    over the pool, goodput, the prefix digest."""
    (eng,) = _engines(world, 1)
    from horovod_tpu_torch.router import LocalReplica

    rep = LocalReplica(eng, "solo")
    try:
        ev = threading.Event()
        box = []
        rep.submit(Request(prompt=list(range(2, 19)), max_new_tokens=2),
                   lambda r: (box.append(r), ev.set()))
        assert ev.wait(60) and box[0].status == OK
        deadline = time.time() + 30
        while rep.probe()["prefix"] is None and time.time() < deadline:
            time.sleep(0.01)
        view = rep.probe()
        assert view["healthy"] and view["tp_size"] == 1
        assert 0 < view["free_kv_frac"] <= 1.0
        assert view["prefix"]["block_size"] == 8
        assert rep.block_size == 8
    finally:
        rep.stop()
    assert torch.equal(eng.params["embed"], world.tp["embed"])
