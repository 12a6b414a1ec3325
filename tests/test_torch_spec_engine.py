"""Port parity: the self-drafting ``ServeEngine`` (``spec=True``).

Mirrors the spec cases of tests/test_spec_sched.py: the port's engine
runs beside JAX's (``torch_engine_twin.Twin``) under preemption replay
with the prefix cache on and off, on a repetitive stream (more than one
accepted token a round), with ``serve.draft`` faults, and with
``spec_tick`` the one program replacing ``tick``.
"""

from __future__ import annotations

import numpy as np
import pytest

from horovod_tpu_torch import metrics as tmetrics
from horovod_tpu_torch.serving import Request
from horovod_tpu_torch.serving_scheduler import ServeEngine
from torch_engine_twin import Twin, tiny_world

pytestmark = pytest.mark.spec

SPEC_PROGRAMS = {"tick": 0, "chunk": 1, "set_row": 1, "spec_tick": 1}


@pytest.fixture(scope="module")
def world():
    return tiny_world()


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_spec_engine_preempt_replay_parity(world, prefix_cache):
    """Speculation under preemption churn on an overcommitted pool: both
    engines agree on everything, results equal solo greedy, and the
    program set stays frozen with ``spec_tick`` replacing ``tick``."""
    rng = np.random.default_rng(11)
    reqs = [dict(prompt=[int(t) for t in rng.integers(
                     1, world.tcfg.vocab_size, int(rng.integers(3, 8)))],
                 max_new_tokens=int(rng.integers(3, 9))) for _ in range(5)]
    tw = Twin(world, n_slots=3, max_len=24, chunk=4, block_size=4,
              n_blocks=9, preempt_after=2, prefix_cache=prefix_cache,
              spec=True, draft_k=3)
    tw.run(reqs)
    tw.check(max_len=24)
    assert tw.t.counters["preemptions"] >= 1
    assert tw.t.compile_cache_sizes() == SPEC_PROGRAMS


def test_spec_accepts_on_repetitive_stream_and_draft_faults():
    """A zeroed lm_head makes a constant greedy stream, the drafter's
    best case: more than one accepted token a row-round, counters
    mirrored into the registry; ``serve.draft`` faults cost only that
    row's proposals for those rounds."""
    world = tiny_world(seed=0, zero_head=True)
    tw = Twin(world, n_slots=2, max_len=32, chunk=4, spec=True, draft_k=4)
    tw.run([dict(prompt=[5, 9, 2, 0, 0, 0], max_new_tokens=16)] * 3)
    tw.check(max_len=32)
    c = tw.t.spec_counters
    assert c["accepted"] > c["row_rounds"] and c["proposed"] >= c["accepted"]
    for k, v in c.items():
        assert tw.t.metrics.counter("serve.spec." + k).value == v
    assert (tw.t.metrics.histogram("serve.spec.accepted_per_round").count
            == c["row_rounds"])
    tw = Twin(world, n_slots=1, max_len=32, chunk=4, spec=True, draft_k=4)
    rid = tw.submit(prompt=[5, 9, 2, 0, 0, 0], max_new_tokens=12)
    _, rule = tw.inject("serve.draft", on_hit=2, count=3, key=rid)
    tw.drain()
    tw.check(max_len=32)
    assert rule.fired == 3 and tw.t.counters["retries"] == 0
    assert tw.t.metrics.counter("serve.spec.draft_faults").value == 3
    assert tw.t.spec_counters["accepted"] > 0


def test_spec_off_engine_and_env_knobs(world, monkeypatch):
    reg = tmetrics.MetricsRegistry(event_log=None)
    eng = ServeEngine(world.tp, world.tcfg, n_slots=2, max_len=24, chunk=4,
                      metrics=reg)
    eng.run([Request(prompt=[1, 2, 3], max_new_tokens=4)])
    assert eng.compile_cache_sizes() == {"tick": 1, "chunk": 1,
                                         "set_row": 1}
    assert not eng.spec and eng._spec_tick is None
    assert all(s.draft is None for s in eng._slots)
    assert not any(n.startswith("serve.spec.")
                   for n in reg.snapshot()["counters"])
    monkeypatch.setenv("HVD_TORCH_SPEC", "1")
    monkeypatch.setenv("HVD_TORCH_DRAFT_K", "2")
    eng = ServeEngine(world.tp, world.tcfg, n_slots=1, max_len=16, chunk=4)
    assert eng.spec and eng.draft_k == 2
    with pytest.raises(ValueError):
        ServeEngine(world.tp, world.tcfg, n_slots=1, max_len=16, chunk=4,
                    spec=True, draft_k=0)
