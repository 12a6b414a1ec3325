"""Port parity: the paged KV cache of ``horovod_tpu_torch.models.llama``.

Across frameworks, on the same pool values (seeded numpy) and JAX's
weights: ``decode_chunk_paged``, ``decode_chunk_paged_row`` and
``spec_verify_paged`` give JAX's logits to 1e-5 relative and its tables,
lengths, tokens and accept counts exactly; ``BlockPool`` driven by one
call sequence reports what JAX's does.  Inside the port: a paged pool
holding a dense cache's values gives ``decode_chunk``'s logits bit for
bit, the reference's "paged == dense" oracle.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import llama as jl
from horovod_tpu_torch.models import llama as tl
from horovod_tpu_torch.models.convert import params_from_jax

RTOL = 1e-5
B, BS, PER = 3, 4, 4              # rows, block size, blocks a row (M = 16)
N_BLOCKS = B * PER + 1


@pytest.fixture(scope="module")
def world():
    jcfg = jl.llama_tiny(dtype=jnp.float32)
    tcfg = tl.llama_tiny(dtype=torch.float32)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(3))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def _pool(cfg, seed, lengths):
    """Random pool values and a table of distinct blocks per row (0 =
    trash past each row's last needed block)."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, N_BLOCKS, BS, cfg.n_kv_heads, cfg.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    perm = rng.permutation(np.arange(1, N_BLOCKS))
    table = perm[:B * PER].reshape(B, PER).astype(np.int64)
    table[2, 3:] = 0                         # row 2 maps only 3 blocks
    return k, v, table, np.asarray(lengths, np.int64)


def _both(k, v, table, lengths):
    jc = jl.PagedKVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                         block_table=jnp.asarray(table, jnp.int32),
                         length=jnp.asarray(lengths, jnp.int32))
    tc = tl.PagedKVCache(k=torch.tensor(k), v=torch.tensor(v),
                         block_table=torch.tensor(table),
                         length=torch.tensor(lengths))
    return jc, tc


def _assert_cache_equal(tc, jc):
    np.testing.assert_array_equal(tc.block_table.numpy(),
                                  np.asarray(jc.block_table))
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), rtol=RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), rtol=RTOL,
                               atol=1e-6)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("t,advance", [(1, None), (3, None), (1, [1, 0, 1]),
                                       (2, [2, 2, 0])])
def test_decode_chunk_paged_matches_jax(world, t, advance):
    """T tokens per row, rows at different depths; row 2 runs past its
    table into the clamp."""
    jcfg, jp, tcfg, tp = world
    k, v, table, lengths = _pool(jcfg, 0, [5, 0, 11])
    jc, tc = _both(k, v, table, lengths)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, t))
    adv = None if advance is None else np.asarray(advance)
    jlog, jc = jl.decode_chunk_paged(
        jp, jnp.asarray(toks, jnp.int32), jcfg, jc,
        advance=None if adv is None else jnp.asarray(adv, jnp.int32))
    tlog, tc2 = tl.decode_chunk_paged(
        tp, torch.tensor(toks), tcfg, tc,
        advance=None if adv is None else torch.tensor(adv))
    assert tc2 is tc                          # updated in place
    _close(tlog, jlog)
    _assert_cache_equal(tc, jc)


@pytest.mark.parametrize("slot,start,new_len", [(0, 0, 3), (1, 4, 8),
                                                (2, 8, 10)])
def test_decode_chunk_paged_row_matches_jax(world, slot, start, new_len):
    """One row's prefill window; the last case's padded tail runs past
    the row's 3 mapped blocks into trash."""
    jcfg, jp, tcfg, tp = world
    lengths = [0, 0, 0]
    lengths[slot] = start
    k, v, table, lengths = _pool(jcfg, 2, lengths)
    jc, tc = _both(k, v, table, lengths)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (1, 4))
    jlog, jc = jl.decode_chunk_paged_row(
        jp, jnp.asarray(toks, jnp.int32), jcfg, jc, jnp.asarray(slot),
        new_length=jnp.asarray(new_len))
    tlog, _ = tl.decode_chunk_paged_row(tp, torch.tensor(toks), tcfg, tc,
                                        slot, new_length=new_len)
    _close(tlog, jlog)
    _assert_cache_equal(tc, jc)
    with pytest.raises(ValueError, match="B=1"):
        tl.decode_chunk_paged_row(tp, torch.tensor(np.zeros((2, 4), int)),
                                  tcfg, tc, 0, new_length=1)


def test_spec_verify_paged_matches_jax(world):
    """Drafts that match the target's own argmax (accepted), random
    ones (rejected) and ``-1`` pads (never accepted), with one row
    inactive."""
    jcfg, jp, tcfg, tp = world
    k, v, table, lengths = _pool(jcfg, 4, [6, 2, 9])
    rng = np.random.default_rng(5)
    last = rng.standard_normal((B, jcfg.vocab_size)).astype(np.float32)
    # row 0 drafts the target's greedy continuation: run the chunk once
    # on a scratch copy to learn it
    jc, tc = _both(k, v, table, lengths)
    tok0 = int(np.argmax(last[0]))
    probe, _ = tl.decode_chunk_paged(
        tp, torch.tensor([[tok0, 0, 0]] * B), tcfg, tc, advance=0)
    good = int(torch.argmax(probe[0, 0]))
    drafts = np.array([[good, 7, 1], [3, 9, 4], [-1, -1, -1]])
    active = np.array([1, 1, 0])
    jc, tc = _both(k, v, table, lengths)
    jtok, jacc, jnext, jc = jl.spec_verify_paged(
        jp, jcfg, jc, jnp.asarray(last), jnp.asarray(drafts, jnp.int32),
        jnp.asarray(active, jnp.int32))
    ttok, tacc, tnext, _ = tl.spec_verify_paged(
        tp, tcfg, tc, torch.tensor(last), torch.tensor(drafts),
        torch.tensor(active))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    assert int(tacc[0]) >= 1 and int(tacc[2]) == 0
    _close(tnext, jnext)
    _assert_cache_equal(tc, jc)


@pytest.mark.parametrize("t", [1, 3])
def test_paged_equals_dense_bit_for_bit(world, t):
    """A pool whose gathered rows hold exactly a dense cache's values:
    ``decode_chunk_paged`` and ``decode_chunk`` give identical logits and
    identical caches afterwards."""
    _, _, cfg, params = world
    m = PER * BS
    rng = np.random.default_rng(7)
    shape = (cfg.n_layers, B, m, cfg.n_kv_heads, cfg.head_dim)
    dk = torch.tensor(rng.standard_normal(shape).astype(np.float32))
    dv = torch.tensor(rng.standard_normal(shape).astype(np.float32))
    lengths = torch.tensor([3, 9, 12])
    dense = tl.KVCache(k=dk.clone(), v=dv.clone(), length=lengths.clone())
    table = torch.arange(1, B * PER + 1).reshape(B, PER).flip(0)
    kp = torch.zeros((cfg.n_layers, N_BLOCKS, BS, cfg.n_kv_heads,
                      cfg.head_dim))
    vp = torch.zeros_like(kp)
    for r in range(B):
        for j in range(PER):
            kp[:, table[r, j]] = dk[:, r, j * BS:(j + 1) * BS]
            vp[:, table[r, j]] = dv[:, r, j * BS:(j + 1) * BS]
    paged = tl.PagedKVCache(k=kp, v=vp, block_table=table,
                            length=lengths.clone())
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (B, t)))
    want, dense = tl.decode_chunk(params, toks, cfg, dense)
    got, paged = tl.decode_chunk_paged(params, toks, cfg, paged)
    assert torch.equal(got, want)
    assert torch.equal(paged.length, dense.length)
    gather = tl._gather_index(table, BS)
    for layer in range(cfg.n_layers):
        flat = paged.k[layer].reshape(N_BLOCKS * BS, *shape[3:])
        assert torch.equal(flat[gather], dense.k[layer])


def test_block_pool_matches_jax():
    """One call sequence through both pools: the same allocations,
    refcounts, LRU order, errors and state lines."""
    pools = (jl.BlockPool(7), tl.BlockPool(7))
    seen = []
    for pool in pools:
        log = []
        a, b, c = pool.alloc(), pool.alloc(), pool.alloc()
        for blk in (a, b, b, c):
            log.append(pool.incref(blk))
        log.append(pool.decref(b))
        pool.mark_indexed(b)
        pool.mark_indexed(c)
        log += [pool.decref(b), pool.decref(c), pool.decref(a)]
        log += [pool.lru_blocks(), pool.free_count(), pool.cached_count(),
                pool.ref_count(), pool.refcount(b)]
        pool.incref(c)
        with pytest.raises(RuntimeError, match="live"):
            pool.drop_indexed(c)
        pool.decref(c)
        pool.drop_indexed(b)
        log += [pool.alloc(), pool.lru_blocks(), pool.state_lines()]
        seen.append(log)
    assert seen[0] == seen[1]
    with pytest.raises(ValueError):
        tl.BlockPool(1)


def test_init_paged_cache_shapes_and_validation(world):
    jcfg, _, tcfg, _ = world
    want = jl.init_paged_cache(jcfg, 3, 16, block_size=4)
    got = tl.init_paged_cache(tcfg, 3, 16, block_size=4, device="cpu")
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and not g.any()
    assert got.block_size == 4 and got.logical_len == 16
    assert tl.init_paged_cache(tcfg, 3, 16, block_size=4, n_blocks=6,
                               device="cpu").k.shape[1] == 6
    with pytest.raises(ValueError, match="multiple"):
        tl.init_paged_cache(tcfg, 1, 10, block_size=4, device="cpu")
    with pytest.raises(ValueError, match="trash"):
        tl.init_paged_cache(tcfg, 2, 16, block_size=4, n_blocks=4,
                            device="cpu")
