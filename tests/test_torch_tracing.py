"""Port parity: causal tracing (``horovod_tpu_torch/tracing.py`` and the
engine's spans).

Mirrors tests/test_tracing.py's identity plane, exemplars, engine tree
and degraded-forest cases.  The pure functions equal the JAX module's on
1,000 seeded keys (same sampling decisions, trace ids, span ids); the
port's engine and the JAX engine give equal span forests on the same
requests (``torch_engine_twin``), timestamps aside.
"""

from __future__ import annotations

import random

import pytest

from horovod_tpu import tracing as jtracing
from horovod_tpu_torch import tracing
from horovod_tpu_torch.metrics import EventLog, MetricsRegistry
from horovod_tpu_torch.serving import OK, Request
from horovod_tpu_torch.serving_scheduler import ServeEngine
from torch_engine_twin import Twin, span_forest, tiny_world


@pytest.fixture(scope="module")
def world():
    return tiny_world()


def _keys(n: int = 1000) -> list:
    rng = random.Random(1234)
    return [rng.choice([f"serve:{rng.randrange(10**6)}",
                        f"router:{rng.randrange(10**6)}",
                        rng.randrange(10**9)]) for _ in range(n)]


@pytest.mark.parametrize("fraction,seed", [(0.3, 7), (0.05, 0), (0.9, 12)])
def test_pure_functions_equal_the_jax_module(fraction, seed):
    keys = _keys()
    assert ([tracing.sampled(k, fraction, seed) for k in keys]
            == [jtracing.sampled(k, fraction, seed) for k in keys])
    tids = [tracing.trace_id_for(k, seed) for k in keys]
    assert tids == [jtracing.trace_id_for(k, seed) for k in keys]
    for i, (k, tid) in enumerate(zip(keys, tids)):
        parent = tids[i - 1][:16]
        assert (tracing.child_span_id(tid, parent, f"n{i % 5}", i % 3)
                == jtracing.child_span_id(tid, parent, f"n{i % 5}", i % 3))
        got = tracing.TraceContext.root(k, "serve.request", fraction, seed)
        want = jtracing.TraceContext.root(k, "serve.request", fraction,
                                          seed)
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.trace_id, got.span_id) == (want.trace_id,
                                                   want.span_id)
            assert got.child("x", 2).span_id == want.child("x", 2).span_id
            assert got.to_header() == want.to_header()


def test_sampling_is_pure_and_clamped():
    assert not tracing.sampled("k", 0.0, 0)
    assert not tracing.sampled("k", -1.0, 0)
    assert tracing.sampled("k", 1.0, 0)
    assert tracing.sampled("k", 2.0, 0)
    keys = [f"router:{i}" for i in range(2000)]
    picks = [k for k in keys if tracing.sampled(k, 0.3, 7)]
    assert picks == [k for k in keys if tracing.sampled(k, 0.3, 7)]
    assert picks != [k for k in keys if tracing.sampled(k, 0.3, 8)]
    assert 0.25 < len(picks) / len(keys) < 0.35
    tid = tracing.trace_id_for("router:5", 7)
    assert tid != tracing.trace_id_for("router:5", 8)
    assert len(tid) == 32 and int(tid, 16) >= 0
    sid = tracing.child_span_id(tid, "", "client")
    assert len(sid) == 16
    assert sid != tracing.child_span_id(tid, "", "client", seq=1)
    assert tracing.TraceContext.root("k", "client", 0.0, 0) is None
    ctx = tracing.TraceContext.root("k", "client", 1.0, 0)
    assert ctx.trace_id == tracing.trace_id_for("k", 0)
    assert ctx.span_id == tracing.child_span_id(ctx.trace_id, "", "client")


def test_env_knobs(monkeypatch):
    monkeypatch.setenv("HVD_TORCH_TRACE_SAMPLE", "0.25")
    monkeypatch.setenv("HVD_TORCH_TRACE_SEED", "9")
    assert tracing.env_sample_fraction() == 0.25
    assert tracing.env_trace_seed() == 9
    monkeypatch.setenv("HVD_TORCH_TRACE_SAMPLE", "7")       # clamped
    assert tracing.env_sample_fraction() == 1.0
    monkeypatch.setenv("HVD_TORCH_TRACE_SAMPLE", "junk")
    monkeypatch.setenv("HVD_TORCH_TRACE_SEED", "junk")
    assert tracing.env_sample_fraction() == 0.0
    assert tracing.env_trace_seed() == 0


def test_trace_context_header_and_dict_round_trips():
    ctx = tracing.TraceContext.root("rt", "client", 1.0, 3)
    hdr = ctx.to_header()
    assert hdr == f"00-{ctx.trace_id}-{ctx.span_id}-01"
    back = tracing.TraceContext.from_header(hdr)
    assert (back.trace_id, back.span_id) == (ctx.trace_id, ctx.span_id)
    for bad in (None, "", "junk", "00-zz-yy-01", "00-abc-01",
                f"00-{ctx.trace_id}-{ctx.span_id}-00"):
        assert tracing.TraceContext.from_header(bad) is None
    back = tracing.TraceContext.from_dict(ctx.to_dict())
    assert back == ctx
    for bad in (None, {}, {"trace_id": 5}, {"trace_id": "a"}, "nope"):
        assert tracing.TraceContext.from_dict(bad) is None
    ch = ctx.child("router.request")
    assert ch.trace_id == ctx.trace_id
    assert ch.span_id == tracing.child_span_id(
        ctx.trace_id, ctx.span_id, "router.request")


def test_histogram_exemplars_in_snapshot_and_prometheus():
    reg = MetricsRegistry(event_log=None)
    h = reg.histogram("router.e2e_s")
    h.observe(0.01)
    assert "exemplars" not in reg.snapshot()["histograms"]["router.e2e_s"]
    h.observe(0.02, exemplar="deadbeefdeadbeef")
    snap = reg.snapshot()["histograms"]["router.e2e_s"]
    assert any(e == {"trace_id": "deadbeefdeadbeef", "value": 0.02}
               for e in snap["exemplars"].values())
    assert '# {trace_id="deadbeefdeadbeef"} 0.02' in reg.to_prometheus()


def test_engine_request_tree_and_critical_path(world, tmp_path,
                                               monkeypatch):
    monkeypatch.setenv("HVD_TORCH_TRACE_SAMPLE", "1")
    path = str(tmp_path / "events.jsonl")
    reg = MetricsRegistry(event_log=EventLog(path))
    eng = ServeEngine(world.tp, world.tcfg, n_slots=2, max_len=32, chunk=4,
                      metrics=reg, monitor=False)
    out = eng.run([Request(prompt=[2, 3, 5, 7, 11], max_new_tokens=4)])
    assert out[0].ok
    records = EventLog.read(path)
    forest = tracing.build_forest(records)
    (roots,) = forest.values()
    (root,) = roots
    assert root["trace_id"] == tracing.trace_id_for("serve:0", 0)
    assert root["name"] == "serve.request"
    assert not root["unclosed"] and not root["orphan"]
    assert root["attrs"]["status"] == OK
    by_name = {c["name"]: c for c in root["children"]}
    assert {"serve.queue", "serve.prefill", "serve.decode"} <= set(by_name)
    prefill = by_name["serve.prefill"]
    assert prefill["attrs"]["chunks"] == 2
    chunks = [c for c in prefill["children"]
              if c["name"] == "serve.prefill_chunk"]
    assert sorted(c["attrs"]["seq"] for c in chunks) == [0, 1]
    decode = by_name["serve.decode"]
    assert decode["attrs"]["n_tokens"] == 4
    assert decode["attrs"]["admit_step"] <= decode["attrs"]["terminal_step"]
    ents = tracing.critical_path(root)
    assert sum(e["self_s"] for e in ents) == pytest.approx(
        root["t1"] - root["t0"], abs=1e-9)
    agg = tracing.aggregate_critical_paths(roots)
    assert sum(s["share"] for s in agg["by_name"].values()) == \
        pytest.approx(1.0)
    snap = reg.snapshot()
    assert snap["counters"]["trace.sampled"] == 1
    assert snap["counters"]["trace.spans"] >= 5
    ex = snap["histograms"]["serve.e2e_s"]["exemplars"]
    assert any(e["trace_id"] == root["trace_id"] for e in ex.values())
    # the tracer's live ring holds the same closed spans
    assert span_forest(eng.tracer) == {
        root["trace_id"]: span_forest(_Ring(records))[root["trace_id"]]}


class _Ring:
    """Event-log records behind the tracer's ``recent()`` interface."""

    def __init__(self, records):
        self._records = [r for r in records
                         if r.get("kind") == tracing.SPAN_KIND]

    def recent(self):
        return self._records


def test_propagated_context_parents_the_request(world):
    eng = ServeEngine(world.tp, world.tcfg, n_slots=1, max_len=32, chunk=4,
                      metrics=MetricsRegistry(event_log=None),
                      monitor=False)
    ctx = tracing.TraceContext.root("client:3", "client", 1.0, 5)
    out = eng.run([Request(prompt=[4, 5, 6], max_new_tokens=2,
                           trace_ctx=ctx)])
    assert out[0].ok
    (roots,) = tracing.build_forest(eng.tracer.recent()).values()
    (root,) = roots
    # the client's own span was never emitted here: the request hangs
    # under it as a labeled orphan of the client's trace
    assert root["orphan"] and root["parent_id"] == ctx.span_id
    assert root["span_id"] == ctx.child("serve.request").span_id
    assert root["trace_id"] == ctx.trace_id


@pytest.mark.parametrize("options", [
    {}, {"prefix_cache": True, "spec": True, "draft_k": 3},
    {"n_blocks": 6, "preempt_after": 1}, {"device_telemetry": True}],
    ids=["fifo", "prefix_spec", "preempt", "device"])
def test_engine_span_forests_equal_the_jax_engine(world, options):
    tw = Twin(world, n_slots=2, max_len=16, chunk=4, block_size=4,
              **options)
    reqs = [dict(prompt=[(7 * i + j) % 250 + 1 for j in range(3 + i % 4)],
                 max_new_tokens=3 + i % 3) for i in range(6)]
    rid = tw.submit(**reqs[0])
    tw.step()
    tw.cancel(rid)
    tw.run(reqs[1:])
    tw.check(max_len=16)
    forest = span_forest(tw.t.tracer)
    assert len(forest) == 6
    assert forest == span_forest(tw.j.tracer)


def test_degraded_trees_orphan_unclosed_and_duplicate_close():
    tid = tracing.trace_id_for("deg", 0)
    root = tracing.child_span_id(tid, "", "client")
    mid = tracing.child_span_id(tid, root, "router.request")
    leaf = tracing.child_span_id(tid, mid, "replica.attempt")
    recs = [
        {"kind": tracing.SPAN_OPEN_KIND, "trace_id": tid, "span_id": mid,
         "parent_id": root, "name": "router.request", "t0": 10.0,
         "pid": 1111, "rank": 0},
        {"kind": tracing.SPAN_KIND, "trace_id": tid, "span_id": leaf,
         "parent_id": mid, "name": "replica.attempt", "t0": 10.2,
         "t1": 10.6, "attrs": {"rid": 7}, "pid": 2222, "rank": 1},
        {"kind": "serve.submit", "rid": 1},
        {"kind": tracing.SPAN_KIND, "trace_id": tid},
        {"kind": tracing.SPAN_KIND, "trace_id": tid, "span_id": leaf,
         "parent_id": mid, "name": "replica.attempt", "t0": 10.2,
         "t1": 10.7, "pid": 2222, "rank": 1},
    ]
    forest = tracing.build_forest(recs)
    assert forest == jtracing.build_forest(recs)
    (roots,) = forest.values()
    node = roots[0]
    assert node["orphan"] and node["unclosed"]
    assert [c["span_id"] for c in node["children"]] == [leaf]
    assert node["children"][0]["t1"] == 10.7
    assert tracing.span_end(node) == 10.7
    cp = tracing.critical_path(node)
    assert cp == jtracing.critical_path(node)
    assert sum(e["self_s"] for e in cp) == pytest.approx(0.7)
    reopened = tracing.build_forest(recs + [
        {"kind": tracing.SPAN_OPEN_KIND, "trace_id": tid,
         "span_id": leaf, "parent_id": mid, "name": "replica.attempt",
         "t0": 10.2}])
    (roots2,) = reopened.values()
    assert not roots2[0]["children"][0]["unclosed"]
