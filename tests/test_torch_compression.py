"""The port's top-k, int8 and int4 compressors against the JAX package's.

Per-rank inputs come from seeded numpy.  The port runs on gloo worlds of
2, 3 and 4 processes (one spawn per world for the file); the JAX package
runs the same functions under ``shard_map`` on as many CPU devices, and
rank r of the port is held against row r of JAX.  The inputs are
continuous random floats, so no two |x| tie (``lax.top_k`` and
``torch.topk`` break ties differently).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops.compression import (Compression, Int4Compressor,
                                               Int8Compressor, TopKCompressor)
from torch_gloo_world import jax_spmd, start_world

WORLDS = (2, 3, 4)
TOPK_SHAPE = (37, 11)           # 407 elements
TOPK = {"ratio0.1": dict(ratio=0.1), "k5": dict(k=5)}
# Three blocks of 1,024: the second all zero, the third a 952-element tail.
Q_N = 3000
QUANT = {"int8": Int8Compressor, "int4": Int4Compressor}
# index_add_ of more than two values into one slot may add in another
# order than XLA's scatter-add: the last bit of an f32 sum.
TOPK_TOL_4 = 1e-6
SUM_TOL = 1e-6


def _topk_input(rank, world):
    rng = np.random.RandomState(100 * world + rank)
    return rng.randn(*TOPK_SHAPE).astype(np.float32)


def _q_input(rank, world):
    rng = np.random.RandomState(200 * world + rank)
    x = (rng.randn(Q_N) * np.repeat([1.0, 0.0, 30.0], [1024, 1024, 952])
         ).astype(np.float32)
    return x


def _worker(rank, world):
    seen = {}
    x = torch.from_numpy(_topk_input(rank, world))
    for name, kw in TOPK.items():
        for avg in (False, True):
            seen[("topk", name, avg)] = TopKCompressor(**kw).sparse_allreduce(
                x, average=avg).numpy()
    q = torch.from_numpy(_q_input(rank, world))
    for name, cls in QUANT.items():
        for avg in (False, True):
            if world == 2:
                seen[(name, "one", avg)] = cls.quantized_allreduce(
                    q, average=avg, two_shot=False).numpy()
                seen[(name, "auto", avg)] = cls.quantized_allreduce(
                    q, average=avg).numpy()
            if world in (2, 3):
                seen[(name, "two", avg)] = cls.quantized_allreduce(
                    q, average=avg, two_shot=True).numpy()
    return seen


@pytest.fixture(scope="module")
def worlds():
    joins = {w: start_world(_worker, w) for w in WORLDS}
    jax_out = {w: _jax_side(w) for w in WORLDS}
    return {w: (joins[w](), jax_out[w]) for w in WORLDS}


def _jax_side(world):
    import jax.numpy as jnp

    from horovod_tpu.ops import compression as J

    out = {}
    xs = jnp.asarray(np.stack([_topk_input(r, world) for r in range(world)]))
    for name, kw in TOPK.items():
        for avg in (False, True):
            out[("topk", name, avg)] = jax_spmd(
                lambda x: J.TopKCompressor(**kw).sparse_allreduce(
                    x, average=avg), world, xs)
    qs = jnp.asarray(np.stack([_q_input(r, world) for r in range(world)]))
    for name in QUANT:
        cls = {"int8": J.Int8Compressor, "int4": J.Int4Compressor}[name]
        for avg in (False, True):
            for mode, flag in (("one", False), ("two", True)):
                if (mode == "one" and world != 2) or world == 4:
                    continue
                out[(name, mode, avg)] = jax_spmd(
                    lambda x: cls.quantized_allreduce(x, average=avg,
                                                      two_shot=flag),
                    world, qs)
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(TOPK))
@pytest.mark.parametrize("avg", [False, True])
def test_topk_sparse_allreduce_matches_jax(worlds, world, name, avg):
    """Exact at world 2 (two values a slot add in either order alike);
    within 1e-6 at world 4."""
    ranks, jx = worlds[world]
    for r, seen in enumerate(ranks):
        got, want = seen[("topk", name, avg)], jx[("topk", name, avg)][r]
        assert got.shape == TOPK_SHAPE
        if world == 2:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=TOPK_TOL_4,
                                       atol=TOPK_TOL_4)


def test_topk_keeps_k_entries_per_rank(worlds):
    """Each rank sends its k largest |x|: the sum has at most world·k
    non-zeros, and every one is the sum of the ranks' picked values."""
    ranks, _ = worlds[2]
    comp = TopKCompressor(ratio=0.1)
    k = comp._k_for(int(np.prod(TOPK_SHAPE)))
    want = np.zeros(int(np.prod(TOPK_SHAPE)), np.float32)
    for r in range(2):
        flat = _topk_input(r, 2).reshape(-1)
        idx = np.argsort(-np.abs(flat))[:k]
        np.add.at(want, idx, flat[idx])
    got = ranks[0][("topk", "ratio0.1", False)].reshape(-1)
    assert np.count_nonzero(got) <= 2 * k
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(QUANT))
@pytest.mark.parametrize("avg", [False, True])
def test_quantized_one_shot_matches_jax(worlds, name, avg):
    ranks, jx = worlds[2]
    for r, seen in enumerate(ranks):
        np.testing.assert_allclose(seen[(name, "one", avg)],
                                   jx[(name, "one", avg)][r], rtol=SUM_TOL,
                                   atol=SUM_TOL)
        # World 2 is below TWO_SHOT_MIN_WORLD: the automatic choice is
        # one-shot.
        np.testing.assert_array_equal(seen[(name, "auto", avg)],
                                      seen[(name, "one", avg)])


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("name", list(QUANT))
@pytest.mark.parametrize("avg", [False, True])
def test_quantized_two_shot_matches_jax(worlds, world, name, avg):
    ranks, jx = worlds[world]
    for r, seen in enumerate(ranks):
        np.testing.assert_allclose(seen[(name, "two", avg)],
                                   jx[(name, "two", avg)][r], rtol=SUM_TOL,
                                   atol=SUM_TOL)
    for seen in ranks[1:]:      # every rank ends with the same sum
        np.testing.assert_array_equal(seen[(name, "two", avg)],
                                      ranks[0][(name, "two", avg)])


def _jax_cls(name):
    from horovod_tpu.ops import compression as J

    return {"int8": J.Int8Compressor, "int4": J.Int4Compressor}[name]


@pytest.mark.parametrize("name", list(QUANT))
@pytest.mark.parametrize("n", [1, 1024, 3000, 5000])
def test_block_quantize_codes_bit_equal(name, n):
    """The wire format: the same codes and scales, bit for bit, including
    a tail block and an all-zero block (its scale floored at 1e-30)."""
    import jax.numpy as jnp

    rng = np.random.RandomState(n)
    x = rng.randn(n).astype(np.float32) * 3
    x[: min(n, 1024)] *= 0 if n > 1024 else 1
    x[-1] = 2.5 * (x[-2] if n > 1 else 1.0)
    codes, scale, m = QUANT[name]._block_quantize(torch.from_numpy(x))
    jcodes, jscale, jm = _jax_cls(name)._block_quantize(jnp.asarray(x))
    assert m == jm == n
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    if n > 1024:                     # the all-zero block
        assert scale[0].item() == np.float32(1e-30)


@pytest.mark.parametrize("name", list(QUANT))
def test_roundtrip_matches_jax_and_is_within_one_step(name):
    import jax.numpy as jnp

    x = _q_input(0, 2).reshape(60, 50)
    got = QUANT[name].roundtrip(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        _jax_cls(name).roundtrip(jnp.asarray(x))))
    assert got.shape == x.shape
    blocks = np.pad(x.reshape(-1), (0, 72)).reshape(3, 1024)
    step = np.abs(blocks).max(1, keepdims=True) / QUANT[name].LEVELS
    err = np.abs(np.pad(got.reshape(-1) - x.reshape(-1), (0, 72))
                 ).reshape(3, 1024)
    assert (err <= step / 2 * (1 + 1e-6) + 1e-30).all()
    assert (got.reshape(-1)[1024:2048] == 0).all()


def test_int4_packs_two_codes_a_byte():
    x = torch.tensor([-7.0, 7.0] * 512 + [0.0, 3.0] * 512)
    codes, scale, _ = Int4Compressor._block_quantize(x)
    assert codes.dtype == torch.uint8 and codes.shape == (2, 512)
    assert int(codes[0, 0]) == 1 | (15 << 4)
    np.testing.assert_array_equal(Int4Compressor.roundtrip(x).numpy(),
                                  x.numpy())


@pytest.mark.parametrize("size", [1, 2, 3, 4, 5, 6, 8, 16, 64])
@pytest.mark.parametrize("numel", [1, 1024, 4096, 5 * 1024 + 1, 1 << 20])
def test_two_shot_selection_rule(size, numel):
    """The automatic choice, as the JAX package states it: two-shot only
    from TWO_SHOT_MIN_WORLD ranks and only when (n−1)·nb₁ > 2·nb₂; the
    one-shot variant never takes it."""
    from horovod_tpu.ops.compression import Int8Compressor as J8

    nb1 = -(-numel // J8.BLOCK)
    nb2 = nb1 + (-nb1) % size
    want = size >= J8.TWO_SHOT_MIN_WORLD and (size - 1) * nb1 > 2 * nb2
    assert Int8Compressor.TWO_SHOT_MIN_WORLD == J8.TWO_SHOT_MIN_WORLD
    assert Int8Compressor.picks_two_shot(size, numel) is want
    assert Int4Compressor.picks_two_shot(size, numel) is want
    assert Int8Compressor.one_shot().picks_two_shot(size, numel) is False


def test_dense_interface_raises_and_registry():
    assert Compression.topk is TopKCompressor
    assert Compression.int8 is Int8Compressor
    assert Compression.int4 is Int4Compressor
    x = torch.ones(3)
    for call in (lambda: TopKCompressor().compress(x),
                 lambda: TopKCompressor().decompress(x),
                 lambda: Int8Compressor.compress(x),
                 lambda: Int4Compressor.compress(x)):
        with pytest.raises(NotImplementedError):
            call()
    assert TopKCompressor(ratio=0.01)._k_for(50) == 1
    assert TopKCompressor(ratio=0.01)._k_for(1000) == 10
    assert TopKCompressor(k=7)._k_for(3) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(QUANT))
def test_block_quantize_on_card_bit_equal_to_cpu(name):
    """On the card the wire format is the CPU's, bit for bit (CUDA divides
    by a Python number through its reciprocal; the scale must not)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.RandomState(11)
    x = torch.from_numpy((rng.randn(1 << 20) * 3).astype(np.float32))
    x[:1024] = 0
    cls = QUANT[name]
    codes, scale, _ = cls._block_quantize(x)
    ccodes, cscale, _ = cls._block_quantize(x.cuda())
    assert torch.equal(ccodes.cpu(), codes)
    assert torch.equal(cscale.cpu(), scale)
    assert torch.equal(cls.roundtrip(x.cuda()).cpu(), cls.roundtrip(x))
