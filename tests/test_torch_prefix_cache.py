"""Port parity: the shared-prefix KV cache (``horovod_tpu_torch.prefix_cache``).

Mirrors tests/test_prefix_cache.py.  The radix index, driven by one call
sequence over the port's ``BlockPool`` and over JAX's, returns the same
blocks, stats, digests and evictions.  Engine cases run the JAX and the
port ``ServeEngine`` side by side with ``prefix_cache=True``
(``torch_engine_twin.Twin``): hits, COW-divergent continuations,
preemption replay through the cache, ``serve.cache`` faults, the block
invariant walker, and one signature per program through every hit.
"""

from __future__ import annotations

import pytest

from horovod_tpu.models.llama import BlockPool as JaxPool
from horovod_tpu.prefix_cache import RadixPrefixCache as JaxRadix
from horovod_tpu.prefix_cache import chunk_path_digests as jdigests
from horovod_tpu_torch.faults import PermanentFault
from horovod_tpu_torch.models.llama import BlockPool
from horovod_tpu_torch.prefix_cache import (RadixPrefixCache,
                                            chunk_path_digests)
from torch_engine_twin import Twin, tiny_world

pytestmark = pytest.mark.prefix

PROGRAMS = {"tick": 1, "chunk": 1, "set_row": 1}
SYS = [5, 17, 42, 9, 3, 8, 11, 2]


@pytest.fixture(scope="module")
def world():
    return tiny_world()


def _shared():
    return [dict(prompt=SYS + [7], max_new_tokens=5),
            dict(prompt=SYS + [30, 31], max_new_tokens=4),
            dict(prompt=SYS + [7], max_new_tokens=5),
            dict(prompt=[100, 101], max_new_tokens=6),
            dict(prompt=SYS, max_new_tokens=3)]


def _radix_script(pool_cls, radix_cls):
    """The reference tests' pool and radix sequences, logged."""
    log = []
    pool = pool_cls(10)
    cache = radix_cls(pool, block_size=2)
    blocks = [pool.alloc() for _ in range(3)]
    for b in blocks:
        pool.incref(b)
    log.append(cache.insert([5, 6, 7, 8, 9], blocks, frontier=5))
    cache.release(reversed(blocks))
    log += [pool.cached_count(), pool.free_count()]
    hit = cache.acquire([5, 6, 7, 8])
    log += [hit, dict(cache.stats)]
    cache.release(hit)
    log += [cache.path_blocks([5, 6, 7, 8, 1, 2]),
            cache.path_blocks([5, 6, 99, 8])]
    dup = [pool.alloc() for _ in range(2)]
    for b in dup:
        pool.incref(b)
    log.append(cache.insert([5, 6, 7, 8], dup, frontier=4))
    cache.release(reversed(dup))
    log += [cache.key_digest(), cache.indexed_blocks(),
            pool.state_lines()]
    cache.check_consistency()
    lru = radix_cls(pool_cls(10), block_size=1)
    for path in ([1, 2, 3], [1, 9]):
        bl = [lru.pool.alloc() for _ in path]
        for b in bl:
            lru.pool.incref(b)
        lru.insert(path, bl, frontier=len(path))
        lru.release(reversed(bl))
    log += [lru.evict(1), lru.path_blocks([1]), lru.evict(99),
            lru.pool.state_lines(), dict(lru.stats)]
    return log


def test_radix_index_matches_jax():
    assert (_radix_script(BlockPool, RadixPrefixCache)
            == _radix_script(JaxPool, JaxRadix))
    toks = list(range(3, 20))
    assert chunk_path_digests(toks, 4) == jdigests(toks, 4)
    assert chunk_path_digests(toks, 4, 2) == jdigests(toks, 4, 2)


def test_key_digest_retries_then_serves_last_summary(monkeypatch):
    """A tree mutated mid-walk (``RuntimeError``) is walked again; one
    that never holds still serves the last complete summary, and with
    none an empty one of the same schema."""
    pool = BlockPool(8)
    cache = RadixPrefixCache(pool, block_size=2)
    blocks = [pool.alloc() for _ in range(2)]
    for b in blocks:
        pool.incref(b)
    cache.insert([5, 6, 7, 8], blocks, frontier=4)
    cache.release(reversed(blocks))
    summary = cache.key_digest()
    assert summary["n_paths"] == 2
    assert set(summary["paths"]) == set(chunk_path_digests([5, 6, 7, 8], 2))
    walk, calls = cache._key_digest_walk, []

    def flaky(max_paths):
        calls.append(max_paths)
        if len(calls) == 1:
            raise RuntimeError("dictionary changed size during iteration")
        return walk(max_paths)

    def boom(max_paths):
        raise RuntimeError("dictionary changed size during iteration")

    monkeypatch.setattr(cache, "_key_digest_walk", flaky)
    assert cache.key_digest() == summary and len(calls) == 2
    monkeypatch.setattr(cache, "_key_digest_walk", boom)
    assert cache.key_digest() == summary
    cold = RadixPrefixCache(BlockPool(4), block_size=2)
    monkeypatch.setattr(cold, "_key_digest_walk", boom)
    assert cold.key_digest() == {"block_size": 2, "indexed_blocks": 0,
                                 "n_paths": 0, "truncated": False,
                                 "paths": []}


def test_engine_parity_and_hits(world):
    """A shared-prefix workload served twice: the second pass hits on
    every prompt spanning a full block, both engines agree on every hit,
    and no program sees a second signature."""
    tw = Twin(world, n_slots=2, max_len=24, chunk=4, prefix_cache=True,
              timeline=True)
    for _ in range(2):
        tw.run(_shared())
        assert tw.t.pool.ref_count() == 0
        tw.t.prefix.check_consistency()
    tw.check(max_len=24)
    assert tw.t.prefix_counters["hits"] >= 4
    assert tw.t.prefix_counters["tokens_skipped"] > 0
    assert tw.t.compile_cache_sizes() == PROGRAMS
    assert tw.t.prefix.key_digest() == tw.j.prefix.key_digest()


def test_cow_divergent_continuations_share_blocks(world):
    """Two rows over one cached prefix map the same physical blocks
    (refcount 2) and append into private tails."""
    tw = Twin(world, n_slots=2, max_len=24, chunk=4, prefix_cache=True)
    tw.run([dict(prompt=SYS + [1], max_new_tokens=3)])
    ra = tw.submit(prompt=SYS + [7, 13], max_new_tokens=5)
    rb = tw.submit(prompt=SYS + [60], max_new_tokens=5)
    shared = False
    while tw.pending():
        tw.step()
        slots = {s.request_id: s for s in tw.t._slots}
        sa, sb = slots.get(ra), slots.get(rb)
        if sa is not None and sb is not None and sa.n_hit and sb.n_hit:
            common = set(sa.blocks[:sa.n_hit]) & set(sb.blocks[:sb.n_hit])
            shared |= bool(common)
            assert all(tw.t.pool.refcount(b) == 2 for b in common)
            assert not (set(sa.blocks[sa.n_hit:])
                        & set(sb.blocks[sb.n_hit:]))
    assert shared
    tw.check(max_len=24)


def test_preempt_replay_with_cache_reports_hits(world):
    tw = Twin(world, n_slots=2, max_len=16, chunk=4, block_size=4,
              n_blocks=6, preempt_after=2, prefix_cache=True)
    tw.run([dict(prompt=[5, 17, 42], max_new_tokens=13),
            dict(prompt=[7, 8], max_new_tokens=6)])
    tw.check(max_len=16)
    kinds = [(e.kind, e.request_id) for e in tw.t.events]
    assert ("hit", 0) in kinds[kinds.index(("preempt", 0)):]
    assert tw.t.compile_cache_sizes() == PROGRAMS


@pytest.mark.parametrize("permanent", [True, False])
def test_cache_fault_quarantines_one_request(world, permanent):
    """A permanent ``serve.cache`` fault fails only its request and the
    index survives (a later sharer hits); a transient one retries after
    the backoff and the request then hits."""
    tw = Twin(world, n_slots=2, max_len=24, chunk=4, prefix_cache=True)
    if not permanent:
        tw.run([dict(prompt=[5, 17, 42, 9, 3], max_new_tokens=4)])
    reqs = (_shared()[:3] if permanent
            else [dict(prompt=[5, 17, 42, 9, 3], max_new_tokens=4)])
    ids = [tw.submit(**r) for r in reqs]
    victim = ids[1] if permanent else ids[0]
    tw.inject("serve.cache", on_hit=1, permanent=permanent, key=victim)
    tw.drain()
    if permanent:
        tw.run([_shared()[0]])
    tw.check(max_len=24)
    res = tw.t.results[victim]
    if permanent:
        assert res.status == "FAILED"
        assert isinstance(res.error, PermanentFault)
    else:
        assert res.status == "OK" and tw.t.counters["retries"] >= 1
    assert tw.t.prefix_counters["hits"] >= 1


def test_invariant_walker_runs_and_catches_corruption(world, monkeypatch):
    monkeypatch.setenv("HVD_TORCH_VERIFY_BLOCKS", "1")
    monkeypatch.setenv("HVD_TPU_VERIFY_BLOCKS", "1")
    tw = Twin(world, n_slots=2, max_len=24, chunk=4, prefix_cache=True)
    assert tw.t._verify_blocks
    tw.run(_shared())
    tw.check(max_len=24)
    s = tw.t._slots[0]
    s.state, s.blocks, s.n_blocks = "decode", [3], 1
    with pytest.raises(AssertionError):
        tw.t._check_block_invariants()
