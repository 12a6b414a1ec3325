"""Port parity: the request lifecycle and fault tolerance of the port's
``ServeEngine``, and the loader's ``data.producer`` fault site.

Mirrors tests/test_serving_faults.py.  Every case drives the JAX engine
and the port's with the same queue, cancellations and fault schedules
(``torch_engine_twin.Twin``), step by step: deadlines, queue budgets,
malformed submissions, cancellation in every state, preemption with
replay, permanent and transient faults at ``serve.admit``,
``serve.prefill`` and ``serve.tick``, retry exhaustion and the watchdog.
Both must agree on tokens, statuses, errors, events, counters and block
tables; OK results equal solo ``generate`` and the others are a prefix
of it.  All schedules are step-counted: no sleeps.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

from horovod_tpu import faults as jfaults
from horovod_tpu.data import ShardedLoader as JaxLoader
from horovod_tpu_torch import faults as tfaults
from horovod_tpu_torch.data import ShardedLoader
from horovod_tpu_torch.faults import PermanentFault, TransientFault
from torch_engine_twin import Twin, tiny_world

pytestmark = pytest.mark.faults

PROGRAMS = {"tick": 1, "chunk": 1, "set_row": 1}


@pytest.fixture(scope="module")
def world():
    return tiny_world()


def _all_free(tw):
    return tw.t.free_block_count() == tw.t.pcache.k.shape[1] - 1


def test_deadlines_and_queue_budget(world):
    """A queued request past its deadline and one past its queue budget
    end TIMEOUT / REJECTED with no tokens; an in-flight one past its
    deadline (expired white-box on both engines) keeps its tokens."""
    tw = Twin(world, n_slots=1, max_len=16, chunk=4)
    occupant = tw.submit(prompt=[5, 17, 42], max_new_tokens=8)
    doomed = tw.submit(prompt=[7, 8], max_new_tokens=4, deadline_s=0.0)
    shed = tw.submit(prompt=[9, 9], max_new_tokens=4, max_queue_steps=2)
    late = tw.submit(prompt=[3, 1], max_new_tokens=10, deadline_s=60.0)
    assert tw.step()[doomed].status == "TIMEOUT"
    while late not in tw.t.results:
        slot = next((i for i, s in enumerate(tw.t._slots)
                     if s.request_id == late and s.out), None)
        if slot is not None:
            for eng in (tw.j, tw.t):
                eng._slots[slot].deadline = time.monotonic() - 1.0
        tw.step()
    tw.drain()
    tw.check(max_len=16)
    res = tw.t.results
    assert res[occupant].status == "OK" and res[shed].status == "REJECTED"
    assert res[late].status == "TIMEOUT" and len(res[late]) > 0
    assert tw.t.counters["timeouts"] == 2
    assert tw.t.counters["rejections"] == 1
    assert [e for e in tw.t.events if e.kind == "reject"][0].slot == -1
    assert _all_free(tw)


def test_malformed_submit_and_cancel_in_every_state(world):
    tw = Twin(world, n_slots=1, max_len=32, chunk=4)
    for bad in (dict(prompt=[], max_new_tokens=4),
                dict(prompt=[7, 8], max_new_tokens=0)):
        rid = tw.submit(**bad)
        assert tw.t.results[rid].status == "REJECTED"
        assert tw.t.results[rid].trace.status == "REJECTED"
    running = tw.submit(prompt=[5, 17, 42], max_new_tokens=6)
    queued = tw.submit(prompt=[7], max_new_tokens=3)
    assert tw.cancel(queued) and not tw.cancel(queued)
    assert not tw.cancel(999)
    for _ in range(3):
        tw.step()
    assert tw.cancel(running)
    mid = tw.submit(prompt=list(range(1, 15)), max_new_tokens=4)
    tw.step()
    assert tw.t._slots[0].state == "prefill"
    assert tw.cancel(mid)
    tw.submit(prompt=[3, 1], max_new_tokens=4)
    tw.drain()
    tw.check(max_len=32)
    assert tw.t.counters["cancellations"] == 3
    assert len(tw.t.results[running]) > 0 and _all_free(tw)


@pytest.mark.parametrize("preempt_after,reqs", [
    (2, [dict(prompt=[5, 17, 42], max_new_tokens=13),
         dict(prompt=[7, 8], max_new_tokens=6)]),
    (1, [dict(prompt=[5, 17, 42], max_new_tokens=12),
         dict(prompt=[7], max_new_tokens=10),
         dict(prompt=[9, 1, 2, 3], max_new_tokens=8),
         dict(prompt=[100, 101], max_new_tokens=11),
         dict(prompt=[200, 3, 1], max_new_tokens=5)]),
])
def test_preemption_replay_parity(world, preempt_after, reqs):
    """A starved head preempts a decoding row (the only one, then under
    churn); the victim replays and every result is solo-exact, with no
    new signature."""
    tw = Twin(world, n_slots=2, max_len=16, chunk=4, block_size=4,
              n_blocks=6, preempt_after=preempt_after)
    out = tw.run(reqs)
    tw.check(max_len=16)
    assert tw.t.counters["preemptions"] >= 1
    assert all(r.status == "OK" for r in out)
    assert len([e for e in tw.t.events
                if e.kind == "admit" and e.request_id == 0]) >= 2
    assert tw.t.compile_cache_sizes() == PROGRAMS
    assert tw.t.free_block_count() == 5


def test_permanent_faults_fail_only_their_request(world):
    """A permanent prefill fault fails one request with no tokens; a
    permanent readback fault on another's 4th tick keeps its 3 tokens;
    the rest finish solo-exact and the engine serves on."""
    tw = Twin(world, n_slots=2, max_len=16, chunk=4)
    ids = [tw.submit(prompt=[5, 17, 42], max_new_tokens=8),
           tw.submit(prompt=[7, 8, 9, 10, 11], max_new_tokens=5),
           tw.submit(prompt=[100, 101], max_new_tokens=4)]
    tw.inject("serve.prefill", key=ids[1], permanent=True)
    tw.inject("serve.tick", key=ids[0], on_hit=4, permanent=True)
    tw.drain()
    tw.run([dict(prompt=[42], max_new_tokens=5)])
    tw.check(max_len=16)
    res = tw.t.results
    assert res[ids[1]].status == "FAILED" and list(res[ids[1]]) == []
    assert isinstance(res[ids[1]].error, PermanentFault)
    assert res[ids[0]].status == "FAILED" and len(res[ids[0]]) == 3
    assert res[ids[2]].status == "OK"
    assert tw.t.counters["failures"] == 2
    assert tw.t.compile_cache_sizes() == PROGRAMS and _all_free(tw)


def test_transient_faults_retry_to_parity(world):
    tw = Twin(world, n_slots=2, max_len=16, chunk=4)
    ids = [tw.submit(prompt=[5, 17, 42], max_new_tokens=6),
           tw.submit(prompt=[7, 8, 9, 10, 11], max_new_tokens=5)]
    tw.inject("serve.admit", key=ids[0])
    tw.inject("serve.prefill", key=ids[1], on_hit=1)
    tw.inject("serve.tick", key=ids[0], on_hit=2)
    tw.drain()
    tw.check(max_len=16)
    assert tw.t.counters["retries"] == 3
    assert all(tw.t.results[r].status == "OK" for r in ids)


def test_transient_fault_exhausts_retries_to_failed(world):
    tw = Twin(world, n_slots=1, max_len=16, chunk=4, max_retries=1)
    rid = tw.submit(prompt=[5, 17, 42], max_new_tokens=4)
    tw.inject("serve.prefill", key=rid, on_hit=1, count=10)
    tw.drain()
    tw.check()
    assert tw.t.results[rid].status == "FAILED"
    assert isinstance(tw.t.results[rid].error, TransientFault)
    assert tw.t.counters["retries"] == 1 and _all_free(tw)


def test_no_progress_watchdog_raises_with_dump(world):
    from horovod_tpu_torch.serving import Request
    from horovod_tpu_torch.serving_scheduler import ServeEngine

    eng = ServeEngine(world.tp, world.tcfg, n_slots=1, max_len=16, chunk=4,
                      watchdog_steps=5)
    eng.submit(Request(prompt=[5, 17, 42], max_new_tokens=4))
    eng._free_blocks.clear()                 # a simulated block leak
    with pytest.raises(RuntimeError, match="no scheduling progress"):
        for _ in range(10):
            eng.step()
    msg = eng.state_dump()
    assert "queued rid=0" in msg and "free_blocks=0" in msg


def test_data_producer_fault_surfaces_in_consumer(monkeypatch):
    """An injected ``data.producer`` fault on batch 1 surfaces from the
    port's loader as from JAX's: after batch 0 (this rank's rows of
    JAX's), as the same ``TransientFault``; with the registry cleared the
    same loader drains fully.  Rank 0 of a world of one."""
    from horovod_tpu_torch import basics

    monkeypatch.setattr(basics, "size", lambda: 1)
    monkeypatch.setattr(basics, "rank", lambda: 0)
    x = np.arange(64, dtype=np.float32).reshape(32, 2)
    seen = []
    for mod, loader in (
            (jfaults, JaxLoader((x,), 2, shuffle=False, device_put=False)),
            (tfaults, ShardedLoader((x,), 2, shuffle=False,
                                    device_put=False))):
        try:
            mod.inject("data.producer", on_hit=2)
            it = iter(loader)
            first = np.asarray(next(it)[0])[:2].tolist()
            with pytest.raises(mod.TransientFault) as err:
                for _ in it:
                    pass
            seen.append((first, err.value.site, err.value.key,
                         err.value.hit))
        finally:
            mod.clear()
        assert len(list(iter(loader))) == len(loader)
    assert seen[0] == seen[1]
