"""Port parity: the fused linear + cross-entropy against the JAX reference.

Mirrors tests/test_fused_xent.py: the same seeded numpy x/w/targets go
through the JAX ``fused_linear_cross_entropy`` and ``reference_cross_entropy``
and through their port counterparts, values and gradients, across chunk
layouts (one chunk, divisible, a ragged last chunk, chunk > V, tiny odd
shapes), extreme logits and a bad chunk size.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import fused_xent as jx
from horovod_tpu_torch.models import llama as tl
from horovod_tpu_torch.ops import fused_xent as tx

# f32 throughout: the same online logsumexp in both frameworks, differing
# only in the summation order of the products and of the row sums.
VALUE_RTOL = 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6

LAYOUTS = [
    (16, 8, 32, 32),     # one chunk == V
    (16, 8, 32, 8),      # V divisible by chunk
    (16, 8, 37, 8),      # ragged final chunk (V % chunk != 0)
    (16, 8, 32, 100),    # chunk > V (clamped)
    (5, 4, 3, 2),        # tiny odd everything
]


def _inputs(n, d, v, seed=0, scale=3.0):
    rng = np.random.RandomState(seed)
    return ((rng.randn(n, d) * scale).astype(np.float32),
            rng.randn(d, v).astype(np.float32),
            rng.randint(0, v, size=(n,)))


@pytest.mark.parametrize("n,d,v,chunk", LAYOUTS)
def test_fused_xent_matches_jax(n, d, v, chunk):
    x, w, t = _inputs(n, d, v)
    want = float(jx.fused_linear_cross_entropy(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(t), chunk_size=chunk))
    got = float(tx.fused_linear_cross_entropy(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(t),
        chunk_size=chunk))
    np.testing.assert_allclose(got, want, rtol=VALUE_RTOL)


@pytest.mark.parametrize("n,d,v,chunk", LAYOUTS)
def test_reference_xent_matches_jax_and_fused(n, d, v, chunk):
    x, w, t = _inputs(n, d, v, seed=1)
    want = float(jx.reference_cross_entropy(jnp.asarray(x), jnp.asarray(w),
                                            jnp.asarray(t)))
    xt, wt, tt = (torch.from_numpy(a) for a in (x, w, t))
    ref = float(tx.reference_cross_entropy(xt, wt, tt))
    fused = float(tx.fused_linear_cross_entropy(xt, wt, tt, chunk_size=chunk))
    np.testing.assert_allclose(ref, want, rtol=VALUE_RTOL)
    np.testing.assert_allclose(fused, ref, rtol=VALUE_RTOL)


@pytest.mark.parametrize("chunk", [16, 7])
def test_fused_xent_gradients_match_jax(chunk):
    x, w, t = _inputs(24, 16, 50, seed=2, scale=1.0)
    gx_j, gw_j = jax.grad(
        lambda x, w: jx.fused_linear_cross_entropy(x, w, jnp.asarray(t),
                                                   chunk_size=chunk),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    tx.fused_linear_cross_entropy(xt, wt, torch.from_numpy(t),
                                  chunk_size=chunk).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_j),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_fused_xent_extreme_logits_stable():
    """The online logsumexp survives logits far outside exp()'s range."""
    x = np.asarray([[300.0], [-300.0]], np.float32)
    w = np.asarray([[1.0, -1.0, 0.5]], np.float32)
    t = np.asarray([0, 1])
    got = float(tx.fused_linear_cross_entropy(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(t),
        chunk_size=2))
    want = float(jx.reference_cross_entropy(jnp.asarray(x), jnp.asarray(w),
                                            jnp.asarray(t)))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=VALUE_RTOL)


@pytest.mark.parametrize("chunk", [0, -1])
def test_fused_xent_rejects_bad_chunk(chunk):
    x, w, t = torch.zeros(2, 4), torch.zeros(4, 8), torch.zeros(2,
                                                                dtype=torch.long)
    with pytest.raises(ValueError, match="positive"):
        tx.fused_linear_cross_entropy(x, w, t, chunk_size=chunk)


def test_fused_xent_bf16_inputs_take_f32_products():
    """bf16 x and w: the products are exact upcasts summed in f32 (the
    reference's preferred_element_type), so the loss equals the f32 loss of
    the bf16-rounded inputs."""
    x, w, t = _inputs(12, 8, 40, seed=4, scale=1.0)
    xb, wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    got = float(tx.fused_linear_cross_entropy(xb, wb, torch.from_numpy(t),
                                              chunk_size=16))
    want = float(tx.fused_linear_cross_entropy(
        xb.float(), wb.float(), torch.from_numpy(t), chunk_size=16))
    assert got == want


def _trainable_copy(tree):
    if isinstance(tree, dict):
        return {k: _trainable_copy(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_()


def test_llama_fused_loss_matches_plain():
    """In f32 the port's fused loss equals its plain loss, value and
    gradient (tests/test_fused_xent.py's Llama case)."""
    cfg = tl.llama_tiny(dtype=torch.float32)
    fused = dataclasses.replace(cfg, fused_loss_chunk=64)
    params = tl.init_params(cfg, 0, device="cpu")
    rng = np.random.RandomState(1)
    batch = tuple(torch.as_tensor(rng.randint(0, cfg.vocab_size, (2, 16)))
                  for _ in range(2))

    def grads(c):
        p = _trainable_copy(params)
        loss = tl.loss_fn(p, batch, c)
        loss.backward()
        return float(loss.detach()), p

    lp, gp = grads(cfg)
    lf, gf = grads(fused)
    np.testing.assert_allclose(lf, lp, rtol=2e-5)
    for k in ("embed", "lm_head", "final_norm"):
        np.testing.assert_allclose(gf[k].grad.numpy(), gp[k].grad.numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=k)
    for k in gp["layers"]:
        np.testing.assert_allclose(gf["layers"][k].grad.numpy(),
                                   gp["layers"][k].grad.numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=k)
