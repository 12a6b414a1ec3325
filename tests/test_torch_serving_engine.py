"""Port parity: ``horovod_tpu_torch.serving_scheduler.ServeEngine``.

Mirrors tests/test_serving_scheduler.py and the policy cases of
tests/test_spec_sched.py.  Every case runs the same queue through the
JAX engine and the port's (``torch_engine_twin.Twin``) and holds them to
equal tokens, statuses, counters, scheduler events, timeline files and
block tables after every step; the port's results also equal its own
solo ``generate``.  The signature pin: each device program sees one
argument signature through admission, retirement and recycling, and a
new one trips the retrace sentry.
"""

from __future__ import annotations

import pytest
import torch

from horovod_tpu import scheduling as jsched
from horovod_tpu_torch import device_telemetry as tdevice
from horovod_tpu_torch import metrics as tmetrics
from horovod_tpu_torch import scheduling as tsched
from horovod_tpu_torch import tracing as ttracing
from horovod_tpu_torch.serving import REJECTED, Request
from horovod_tpu_torch.serving_scheduler import ServeEngine
from torch_engine_twin import Twin, solo, tiny_world

PROGRAMS = {"tick": 1, "chunk": 1, "set_row": 1}


@pytest.fixture(scope="module")
def world():
    return tiny_world()


def _mixed():
    return [
        dict(prompt=[5, 17, 42], max_new_tokens=4),
        dict(prompt=[7], max_new_tokens=6),
        dict(prompt=[9, 1, 2, 3, 4, 5], max_new_tokens=3),
        dict(prompt=[100, 101], max_new_tokens=5),
        dict(prompt=[200, 3, 1], max_new_tokens=2),
        dict(prompt=[11, 12, 13, 14], max_new_tokens=4),
        dict(prompt=[42], max_new_tokens=5),
    ]


@pytest.mark.parametrize("n_blocks", [None, 6])
def test_engine_matches_jax_engine_and_solo(world, n_blocks):
    """A queue deeper than the pool, recycled slots and blocks, the
    timeline files; with ``n_blocks=6`` an overcommitted pool where
    admission waits on the free list and every block comes home."""
    tw = Twin(world, n_slots=2, max_len=16, chunk=4, n_blocks=n_blocks,
              timeline=True)
    tw.run(_mixed())
    tw.check(max_len=16)
    assert tw.t.compile_cache_sizes() == PROGRAMS
    assert tw.t.free_block_count() == tw.t.pcache.k.shape[1] - 1


def test_midflight_admission_parity(world):
    """Requests submitted while rows decode land in just-recycled slots
    whose blocks held another request's K/V moments earlier."""
    tw = Twin(world, n_slots=2, max_len=16, chunk=4)
    for r in _mixed()[:3]:
        tw.submit(**r)
    for _ in range(3):
        tw.step()
    tw.submit(prompt=[33, 44, 55, 66, 77], max_new_tokens=4)
    tw.submit(prompt=[8, 9], max_new_tokens=6)
    tw.drain()
    tw.check(max_len=16)


def test_signature_pin_across_admissions(world):
    """One signature per program through a workload, a second workload
    on the same engine, and every admit and recycle."""
    eng = ServeEngine(world.tp, world.tcfg, n_slots=2, max_len=16, chunk=4,
                      metrics=tmetrics.MetricsRegistry(event_log=None))
    assert eng.compile_cache_sizes() == {k: 0 for k in PROGRAMS}
    eng.run([Request(**r) for r in _mixed()])
    assert eng.compile_cache_sizes() == PROGRAMS
    eng.run([Request(prompt=[1, 2, 3, 4, 5, 6, 7], max_new_tokens=6),
             Request(prompt=[250], max_new_tokens=3)])
    assert eng.compile_cache_sizes() == PROGRAMS
    assert [e.kind for e in eng.events].count("admit") == 9
    assert [e.kind for e in eng.events].count("recycle") == 9
    assert eng.metrics.counter("serve.retrace").value == 0


def test_retrace_sentry_counts_a_new_signature(world, monkeypatch):
    """A program called with a new argument signature (a tensor slot
    where the engine passes an int) bumps ``serve.retrace``; with
    ``HVD_TORCH_RETRACE_FATAL=1`` the next step raises with the state."""
    reg = tmetrics.MetricsRegistry(event_log=None)
    eng = ServeEngine(world.tp, world.tcfg, n_slots=1, max_len=16, chunk=4,
                      metrics=reg)
    eng.run([Request(prompt=[5, 17, 42], max_new_tokens=3)])
    eng._set_row(eng.pcache, torch.tensor(0),
                 torch.zeros(eng.blocks_per_slot, dtype=torch.int64), 0)
    eng.step()
    assert reg.counter("serve.retrace").value == 1
    assert eng.compile_cache_sizes()["set_row"] == 2
    monkeypatch.setenv("HVD_TORCH_RETRACE_FATAL", "1")
    eng = ServeEngine(world.tp, world.tcfg, n_slots=1, max_len=16, chunk=4,
                      metrics=reg)
    eng.run([Request(prompt=[5], max_new_tokens=2)])
    eng._tick(eng.params, eng.pcache, eng.last_logits,
              torch.zeros(1, dtype=torch.int32))
    with pytest.raises(RuntimeError, match="retrace sentry"):
        eng.step()


def test_eos_retires_slot_early(world):
    want = solo(world, [5, 17, 42], 8, 16)
    tw = Twin(world, n_slots=1, max_len=16, chunk=4)
    out = tw.run([dict(prompt=[5, 17, 42], max_new_tokens=8,
                       eos_id=want[2])])[0]
    assert list(out) == want[:3]
    tw.check(max_len=16)
    assert tw.t.free_block_count() == tw.t.pcache.k.shape[1] - 1


def test_chunked_prefill_interleaves_with_decode(world):
    """A 19-token prompt admitted while another row decodes prefills one
    window a step; both keep parity and the retirement step is the
    reference's."""
    tw = Twin(world, n_slots=2, max_len=32, chunk=4)
    short = tw.submit(prompt=[3, 1], max_new_tokens=10)
    tw.step()
    tw.step()
    admit_step = tw.t.step_index
    long = tw.submit(prompt=list(range(10, 29)), max_new_tokens=5)
    tw.drain()
    tw.check(max_len=32)
    retire = [e for e in tw.t.events
              if e.kind == "recycle" and e.request_id == long]
    assert retire[0].step == admit_step + 5 + 5 - 2
    assert tw.t.results[short].status == "OK"


def test_submit_validation_and_seams(world):
    """Malformed requests REJECT; caller errors raise as the reference's
    do; the measurement planes take the reference's None / False / True /
    instance / port values and a request's ``trace_ctx``; tensor
    parallelism raises ``NotImplementedError``."""
    p, cfg = world.tp, world.tcfg
    eng = ServeEngine(p, cfg, n_slots=1, max_len=16, chunk=6, block_size=4,
                      metrics=tmetrics.MetricsRegistry(event_log=None))
    assert eng.results[eng.submit(Request(prompt=[], max_new_tokens=2))
                       ].status == REJECTED
    assert eng.results[eng.submit(Request(prompt=[1], max_new_tokens=0))
                       ].status == REJECTED
    with pytest.raises(ValueError, match="greedy-only"):
        eng.submit(Request(prompt=[1], max_new_tokens=2, temperature=0.7))
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.submit(Request(prompt=[1, 2, 3], max_new_tokens=14))
    with pytest.raises(ValueError, match="prefill"):
        eng.submit(Request(prompt=list(range(1, 14)), max_new_tokens=2))
    ctx = ttracing.TraceContext.root("client:1", fraction=1.0, seed=0)
    rid = eng.submit(Request(prompt=[1], max_new_tokens=2, trace_ctx=ctx))
    assert eng.traces[rid].trace_id == ctx.trace_id
    assert eng.traces[rid].parent_span_id == ctx.span_id
    with pytest.raises(ValueError, match="trash block"):
        ServeEngine(p, cfg, n_slots=1, max_len=16, chunk=4, n_blocks=3)
    # None reads the environment: the sampler and alerts are on at 1 s,
    # the monitor and device telemetry off
    assert eng.sampler is not None and eng.sampler.sample_s == 1.0
    assert eng.alerts is not None and eng.advisor is not None
    assert eng.monitor is None and eng.device_telemetry is None
    for plane in ("monitor", "sampler", "alerts", "device_telemetry"):
        off = ServeEngine(p, cfg, n_slots=1, max_len=16, chunk=4,
                          **{plane: False})
        assert getattr(off, plane) is None
    on = ServeEngine(p, cfg, n_slots=1, max_len=16, chunk=4, monitor=0,
                     device_telemetry=True)
    try:
        assert on.monitor.port > 0 and on.monitor.engine is on
        assert isinstance(on.device_telemetry,
                          tdevice.DeviceTelemetry)
        assert on.device_telemetry.device == on.device
    finally:
        on.monitor.stop()
    with pytest.raises(ValueError, match="monitor must be"):
        ServeEngine(p, cfg, n_slots=1, max_len=16, chunk=4, monitor=True)
    # tp > 1: the reference's divisibility check, then the mesh's rank
    # count (a process with no world is one rank)
    with pytest.raises(ValueError, match="does not divide cfg.n_heads=4"):
        ServeEngine(p, cfg, n_slots=1, max_len=16, chunk=4, tp_size=3)
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        ServeEngine(p, cfg, n_slots=1, max_len=16, chunk=4, tp_size=2)


def test_reports_and_profiler(world):
    """``metrics_snapshot`` carries the SLO window, the memory report and
    the profiler's phases; TTFT/TPOT come from the request traces."""
    reg = tmetrics.MetricsRegistry(event_log=None)
    eng = ServeEngine(world.tp, world.tcfg, n_slots=2, max_len=16, chunk=4,
                      metrics=reg, profile=True)
    out = eng.run([Request(**r) for r in _mixed()[:4]])
    snap = eng.metrics_snapshot()
    assert snap["slo"]["n"] == 4 and snap["slo"]["goodput"] == 1.0
    assert snap["histograms"]["serve.ttft_s"]["count"] == 4
    assert snap["histograms"]["serve.tpot_s"]["count"] == 4
    kv = snap["memory"]["kv"]
    assert kv["free_blocks"] == eng.pcache.k.shape[1] - 1
    assert kv["block_bytes"] == 2 * 4 * 2 * 4 * 2 * 16
    assert set(snap["profile"]["phases"]) >= {
        "expire", "admit", "decode_dispatch", "device_sync",
        "sample_postprocess", "bookkeeping"}
    assert abs(snap["profile"]["coverage"] - 1.0) < 1e-6
    assert all(r.trace.ttft_s is not None for r in out)
    assert "queue_depth=0" in eng.state_dump()


@pytest.mark.parametrize("starvation_steps,first", [(64, "high"), (2, "low")])
def test_priority_admission_and_starvation_guard(world, starvation_steps,
                                                 first):
    """One slot, a running filler, a low- and a high-priority waiter: the
    high one admits first unless the low one starved past it."""
    tw = Twin(world, n_slots=1, max_len=24, chunk=4, policy=(
        jsched.PriorityPolicy(starvation_steps=starvation_steps),
        tsched.PriorityPolicy(starvation_steps=starvation_steps)))
    tw.submit(prompt=[1, 2, 3, 4], max_new_tokens=6)
    tw.step()
    low = tw.submit(prompt=[5, 6], max_new_tokens=2, priority=0)
    high = tw.submit(prompt=[7, 8], max_new_tokens=2, priority=5)
    tw.drain()
    tw.check(max_len=24)
    done = [e.request_id for e in tw.t.events if e.kind == "recycle"]
    assert done[1] == {"high": high, "low": low}[first]


def test_edf_preempts_slack_richest(world):
    """Two rows fill the pool and a third starves on blocks: EDF evicts
    the slack-rich first-admitted row, not the youngest, in both
    engines, and the victim's replay ends solo-exact."""
    class Recording:
        def __init__(self, base):
            self.base, self.victims = base, []

        def make(self):
            outer = self

            class Policy(self.base):
                def victim(self, candidates):
                    slot = super().victim(candidates)
                    outer.victims.append(dict(candidates)[slot].request_id)
                    return slot
            return Policy()

    jrec, trec = Recording(jsched.EdfPolicy), Recording(tsched.EdfPolicy)
    tw = Twin(world, n_slots=3, max_len=24, chunk=4, block_size=4,
              n_blocks=9, preempt_after=2, policy=(jrec.make(), trec.make()))
    slack = tw.submit(prompt=[3, 1, 4, 1, 5, 9], max_new_tokens=8,
                      slo_s=1e6)
    tw.submit(prompt=[2, 7, 1, 8, 2, 8], max_new_tokens=8, slo_s=1e-6)
    while tw.t._queue:
        tw.step()
    tw.submit(prompt=[6, 6, 6, 6, 6, 6], max_new_tokens=8)
    tw.drain()
    tw.check(max_len=24)
    assert tw.t.counters["preemptions"] >= 1
    assert trec.victims[0] == slack and trec.victims == jrec.victims


def test_randomized_stream_parity(world):
    """A seeded random stream (random prompts, budgets and submission
    times, EOS on some) over a small overcommitted pool with preemption:
    both engines agree step by step and every result is solo-exact."""
    import numpy as np

    rng = np.random.default_rng(7)
    tw = Twin(world, n_slots=3, max_len=24, chunk=4, n_blocks=12,
              preempt_after=2)
    pending = []
    for _ in range(12):
        n = int(rng.integers(1, 12))
        req = dict(prompt=rng.integers(1, 256, size=n).tolist(),
                   max_new_tokens=int(rng.integers(1, 24 - n + 1)))
        if rng.random() < 0.3:
            req["eos_id"] = int(rng.integers(0, 256))
        pending.append(req)
    while pending or tw.pending():
        for _ in range(int(rng.integers(0, 3))):
            if pending:
                tw.submit(**pending.pop(0))
        tw.step()
    tw.check(max_len=24)
    assert tw.t.compile_cache_sizes() == PROGRAMS
