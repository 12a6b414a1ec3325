"""Port parity: horovod_tpu_torch.models.llama against the JAX reference.

Both sides run ``llama_tiny`` from the same weights (the JAX
``init_params`` pytree, converted by ``params_from_jax``) on the same
seeded numpy tokens.  In float32 the two frameworks differ only in the
summation order of their products, so logits agree to ~1e-5 and greedy
tokens are equal.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import llama as jl
from horovod_tpu_torch.models import llama as tl
from horovod_tpu_torch.models.convert import params_from_jax

# f32 logits of a 2-layer tiny model: products summed in another order
# (~1e-7 relative per op) through a handful of matmuls.
LOGIT_ATOL = 1e-4
# bf16 activations: both frameworks round every matmul output to bf16
# (8 mantissa bits) but may accumulate in another order, so single
# roundings can differ by one bf16 ulp and propagate through the layers.
BF16_LOGIT_ATOL = 0.1
IMPLS = ["dense", "blockwise", "flash"]

# One compile per config instead of op-by-op dispatch of the reference.
_jprefill = jax.jit(jl.prefill, static_argnums=(2,))
_jdecode_step = jax.jit(jl.decode_step, static_argnums=(2,))
_jdecode_chunk = jax.jit(jl.decode_chunk, static_argnums=(2,))
_jforward = jax.jit(jl.forward, static_argnums=(2,))
_jgenerate = jax.jit(jl.generate, static_argnums=(2,),
                     static_argnames=("max_new_tokens",))


def _cfgs(**kw):
    jkw = {k: (getattr(jnp, v) if k == "dtype" else v) for k, v in kw.items()}
    tkw = {k: (getattr(torch, v) if k == "dtype" else v) for k, v in kw.items()}
    return jl.llama_tiny(**jkw), tl.llama_tiny(**tkw)


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs(dtype="float32")
    jp = jl.init_params(jcfg, jax.random.PRNGKey(11))
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")


def _tokens(b, l, seed=0, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, (b, l)).astype(np.int32)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.int64))


def test_params_from_jax_round_trip(weights):
    jp, tp = weights
    jflat = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jflat) == 12
    for path, leaf in jflat:
        t = tp
        for key in path:
            t = t[key.key]
        assert t.device.type == "cpu" and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    # bf16 leaves (ml_dtypes) convert bit for bit
    bf = jnp.asarray(np.random.RandomState(0).randn(3, 5), jnp.bfloat16)
    got = params_from_jax({"w": np.asarray(bf)}, device="cpu")["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(bf, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(dtype):
    rng = np.random.RandomState(1)
    x, w = rng.randn(2, 5, 64).astype(np.float32), rng.randn(64).astype(np.float32)
    want = jl.rmsnorm(jnp.asarray(x).astype(getattr(jnp, dtype)),
                      jnp.asarray(w), 1e-5)
    got = tl.rmsnorm(torch.from_numpy(x).to(getattr(torch, dtype)),
                     torch.from_numpy(w), 1e-5)
    assert got.dtype == getattr(torch, dtype)
    # bf16: same f32 normalisation, the same two roundings to bf16.
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=1e-6 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_jax(dtype):
    jcfg, tcfg = _cfgs(dtype="float32")
    pos = np.arange(12).reshape(2, 6) * 7
    jc, js = jl.rope_tables(jcfg, jnp.asarray(pos))
    tc, ts = tl.rope_tables(tcfg, _t(pos))
    # positions up to 77 rad: sin/cos of f32 angles, ulp-level libm drift
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    x = np.random.RandomState(2).randn(2, 6, 4, 16).astype(np.float32)
    want = jl.apply_rope(jnp.asarray(x).astype(getattr(jnp, dtype)), jc, js)
    got = tl.apply_rope(torch.from_numpy(x).to(getattr(torch, dtype)), tc, ts)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_matches_jax(weights, impl):
    jp, tp = weights
    jcfg, tcfg = _cfgs(dtype="float32", attn_impl=impl, attn_block_size=8)
    toks = _tokens(2, 20)
    want = _jforward(jp, jnp.asarray(toks), jcfg)
    got = tl.forward(tp, _t(toks), tcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 20, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_matches_jax(weights, impl, ragged):
    jp, tp = weights
    jcfg, tcfg = _cfgs(dtype="float32", attn_impl=impl, attn_block_size=8)
    toks = _tokens(3, 12, seed=1)
    lengths = np.array([12, 5, 1], np.int32) if ragged else None
    jlog, jcache = _jprefill(jp, jnp.asarray(toks), jcfg,
                              jl.init_cache(jcfg, 3, 16),
                              lengths=None if lengths is None
                              else jnp.asarray(lengths))
    tlog, tcache = tl.prefill(tp, _t(toks), tcfg,
                              tl.init_cache(tcfg, 3, 16, device="cpu"),
                              lengths=None if lengths is None else _t(lengths))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k),
                               atol=1e-5)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v),
                               atol=1e-5)
    if ragged:
        assert tcache.length.tolist() == lengths.tolist()
    else:
        assert tcache.length == 12


@pytest.mark.parametrize("ragged", [False, True])
def test_decode_step_matches_jax(weights, ragged):
    """Three decode steps after a prefill, lockstep (scalar length) and
    ragged ([B] length, through decode_chunk)."""
    jp, tp = weights
    jcfg, tcfg = _cfgs(dtype="float32")
    toks = _tokens(2, 6, seed=2)
    lengths = np.array([6, 3], np.int32) if ragged else None
    jlog, jc = _jprefill(jp, jnp.asarray(toks), jcfg, jl.init_cache(jcfg, 2, 12),
                          lengths=None if lengths is None else jnp.asarray(lengths))
    tlog, tc = tl.prefill(tp, _t(toks), tcfg,
                          tl.init_cache(tcfg, 2, 12, device="cpu"),
                          lengths=None if lengths is None else _t(lengths))
    for step in range(3):
        nxt = np.array([7 + step, 40 + step], np.int32)
        jlog, jc = _jdecode_step(jp, jnp.asarray(nxt), jcfg, jc)
        tlog, tc = tl.decode_step(tp, _t(nxt), tcfg, tc)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=LOGIT_ATOL)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(tc.length), np.asarray(jc.length))


def test_decode_chunk_matches_jax(weights):
    jp, tp = weights
    jcfg, tcfg = _cfgs(dtype="float32")
    toks = _tokens(2, 5, seed=3)
    _, jc = _jprefill(jp, jnp.asarray(toks), jcfg, jl.init_cache(jcfg, 2, 16),
                       lengths=jnp.asarray([5, 2]))
    _, tc = tl.prefill(tp, _t(toks), tcfg,
                       tl.init_cache(tcfg, 2, 16, device="cpu"),
                       lengths=_t([5, 2]))
    chunk = _tokens(2, 4, seed=4)
    jlog, jc = _jdecode_chunk(jp, jnp.asarray(chunk), jcfg, jc)
    tlog, tc = tl.decode_chunk(tp, _t(chunk), tcfg, tc)
    assert tuple(tlog.shape) == (2, 4, 256)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), atol=1e-5)
    assert tc.length.tolist() == [9, 6]


@pytest.mark.parametrize("ragged", [False, True])
def test_prefill_chunked_equals_prefill_and_jax(weights, ragged):
    jp, tp = weights
    jcfg, tcfg = _cfgs(dtype="float32")
    toks = _tokens(2, 12, seed=5)
    lengths = _t([12, 7]) if ragged else None
    want, wc = tl.prefill(tp, _t(toks), tcfg,
                          tl.init_cache(tcfg, 2, 12, device="cpu"),
                          lengths=lengths)
    got, gc = tl.prefill_chunked(tp, _t(toks), tcfg,
                                 tl.init_cache(tcfg, 2, 12, device="cpu"),
                                 window=4, lengths=lengths)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=LOGIT_ATOL)
    np.testing.assert_allclose(gc.k.numpy(), wc.k.numpy(), atol=1e-5)
    assert np.asarray(gc.length).tolist() == np.asarray(wc.length).tolist()
    jlog, _ = jl.prefill_chunked(
        jp, jnp.asarray(toks), jcfg, jl.init_cache(jcfg, 2, 12), window=4,
        lengths=None if lengths is None else jnp.asarray(lengths.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(jlog), atol=LOGIT_ATOL)


def test_prefill_chunked_validation(weights):
    _, tp = weights
    _, tcfg = _cfgs(dtype="float32")
    toks = _t(_tokens(1, 8))
    with pytest.raises(ValueError, match="multiple"):
        tl.prefill_chunked(tp, toks, tcfg,
                           tl.init_cache(tcfg, 1, 8, device="cpu"), window=3)
    cache = tl.init_cache(tcfg, 1, 12, device="cpu")._replace(
        length=torch.tensor([6]))
    with pytest.raises(ValueError, match="overflow"):
        tl.prefill_chunked(tp, toks, tcfg, cache, window=4)
    with pytest.raises(ValueError, match="lengths"):
        tl.prefill(tp, toks, tcfg, tl.init_cache(tcfg, 1, 8, device="cpu"),
                   lengths=_t([9]))


@pytest.mark.parametrize("top_k,top_p", [(5, None), (None, 0.8), (7, 0.6)])
def test_filtered_logits_matches_jax(top_k, top_p):
    logits = np.random.RandomState(6).randn(3, 50).astype(np.float32) * 3
    want = jl.filtered_logits(jnp.asarray(logits), 0.7, top_k=top_k, top_p=top_p)
    got = tl.filtered_logits(torch.from_numpy(logits), 0.7, top_k=top_k,
                             top_p=top_p)
    np.testing.assert_array_equal(np.asarray(want) > -1e29,
                                  got.numpy() > -1e29)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("impl", IMPLS)
def test_generate_greedy_tokens_equal_jax(weights, impl):
    jp, tp = weights
    jcfg, tcfg = _cfgs(dtype="float32", attn_impl=impl, attn_block_size=8)
    prompt = _tokens(2, 10, seed=7)
    want = np.asarray(_jgenerate(jp, jnp.asarray(prompt), jcfg,
                                  max_new_tokens=6))
    got = tl.generate(tp, _t(prompt), tcfg, max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_ragged_greedy_tokens_equal_jax(weights):
    jp, tp = weights
    jcfg, tcfg = _cfgs(dtype="float32", attn_impl="flash")
    prompt = _tokens(2, 9, seed=8)
    lengths = np.array([9, 4], np.int32)
    want = np.asarray(_jgenerate(jp, jnp.asarray(prompt), jcfg,
                                  max_new_tokens=5,
                                  prompt_lengths=jnp.asarray(lengths)))
    got = tl.generate(tp, _t(prompt), tcfg, max_new_tokens=5,
                      prompt_lengths=_t(lengths))
    np.testing.assert_array_equal(got.numpy(), want)


def test_bf16_logits_close_to_jax(weights):
    """bf16 compute (f32 master weights cast at use) through the flash
    path: prefill and one decode step within the bf16 tolerance."""
    jp, tp = weights
    jcfg, tcfg = _cfgs(dtype="bfloat16", attn_impl="flash")
    prompt = _tokens(2, 16, seed=9)
    jlog, jc = _jprefill(jp, jnp.asarray(prompt), jcfg,
                          jl.init_cache(jcfg, 2, 20))
    tlog, tc = tl.prefill(tp, _t(prompt), tcfg,
                          tl.init_cache(tcfg, 2, 20, device="cpu"))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=BF16_LOGIT_ATOL)
    nxt = np.array([3, 4], np.int32)
    jlog, _ = _jdecode_step(jp, jnp.asarray(nxt), jcfg, jc)
    tlog, _ = tl.decode_step(tp, _t(nxt), tcfg, tc)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=BF16_LOGIT_ATOL)


def test_cast_params_equals_cast_at_use(weights):
    """Weights held in cfg.dtype from load give the logits of f32 master
    weights cast at each use."""
    _, tp = weights
    _, tcfg = _cfgs(dtype="bfloat16")
    toks = _t(_tokens(2, 8, seed=10))
    want = tl.forward(tp, toks, tcfg)
    cast = {k: ({n: t.bfloat16() for n, t in v.items()}
                if isinstance(v, dict) else v.bfloat16())
            for k, v in tp.items()}
    got = tl.forward(cast, toks, tcfg)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_sampled_generate_is_reproducible_and_valid(weights):
    _, tp = weights
    _, tcfg = _cfgs(dtype="float32")
    prompt = _t(_tokens(2, 5, seed=11))
    a = tl.generate(tp, prompt, tcfg, max_new_tokens=6, temperature=0.8,
                    top_k=20, top_p=0.9, key=3)
    b = tl.generate(tp, prompt, tcfg, max_new_tokens=6, temperature=0.8,
                    top_k=20, top_p=0.9,
                    key=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert int(a.min()) >= 0 and int(a.max()) < tcfg.vocab_size


def test_init_params_layout_and_unported_engines():
    _, tcfg = _cfgs(dtype="float32")
    jcfg, _ = _cfgs(dtype="float32")
    tp = tl.init_params(tcfg, 0, device="cpu")
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    tshapes = {k: ({n: tuple(t.shape) for n, t in v.items()}
                   if isinstance(v, dict) else tuple(v.shape))
               for k, v in tp.items()}
    assert tshapes == jshapes
    assert sum(t.numel() for t in jax.tree_util.tree_leaves(tp)) == \
        tl.num_params(tcfg)
    assert tl.num_params(tl.llama3_8b()) == jl.num_params(jl.llama3_8b())
    with pytest.raises(ValueError, match="needs sp_group"):
        tl.forward(tp, _t(_tokens(1, 4)),
                   dataclasses.replace(tcfg, attn_impl="ring"))
