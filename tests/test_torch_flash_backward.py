"""Port parity: the flash-attention backward against the JAX reference.

The same seeded numpy q/k/v/dO go through the JAX ``_flash_backward`` (the
Pallas dQ and dK/dV kernels in interpret mode, as tests/test_attention.py
runs them on the CPU) and through the port's plain
``_flash_backward_reference``, at equal blocks (16 at L=40: a ragged tail)
with GQA (H=4, KVH=2), so that a swapped KV index map would show.  On CPU
tensors the port's public backward is that plain version; the CUDA kernels
are held against it by tests/test_torch_flash_kernel.py and chip_smoke.py.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu_torch.parallel import flash_attention as tflash

jflash = importlib.import_module("horovod_tpu.parallel.flash_attention")

B, L, H, KVH, D, BLOCK = 2, 40, 4, 2, 16, 16
# f32: the same block loops and rounding points; only the summation order
# of the f32 products differs.
F32_ATOL = 5e-5
# bf16: dQ, dK and dV are each rounded to bf16 after three bf16 roundings
# inside (P, dS to the storage dtype) and the per-head dK/dV are summed in
# bf16; a tie broken differently moves one bf16 ulp (2**-8 relative), and
# the f32 paths before each rounding differ only in summation order.  Held
# relative to the largest |grad| of each tensor.
BF16_RTOL = 2 ** -6


def _np(seed=0, l=L):
    rng = np.random.RandomState(seed)
    q = rng.randn(B * H, l, D).astype(np.float32)
    k = rng.randn(B * KVH, l, D).astype(np.float32)
    v = rng.randn(B * KVH, l, D).astype(np.float32)
    g = rng.randn(B * H, l, D).astype(np.float32)
    return q, k, v, g


def _jax_forward_backward(q, k, v, g, causal, dtype):
    jq, jk, jv, jg = (jnp.asarray(a).astype(dtype) for a in (q, k, v, g))
    kw = dict(n_heads=H, n_kv_heads=KVH, causal=causal, block_q=BLOCK,
              block_k=BLOCK, interpret=True)
    o, lse = jflash._flash_forward(jq, jk, jv, **kw)
    grads = jflash._flash_backward(jq, jk, jv, o, lse, jg, **kw)
    return o, lse, grads


def _t(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_backward_reference_matches_jax(dtype, causal):
    """dQ, dK, dV of the plain backward == JAX ``_flash_backward`` on the
    same q/k/v/o/lse/dO (o and LSE from the JAX forward)."""
    q, k, v, g = _np(seed=5)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    o, lse, want = _jax_forward_backward(q, k, v, g, causal, jdt)
    got = tflash._flash_backward_reference(
        _t(q, tdt), _t(k, tdt), _t(v, tdt), _t(o, tdt),
        torch.from_numpy(np.array(lse)[:, :L]), _t(g, tdt), n_heads=H,
        n_kv_heads=KVH, causal=causal, block_q=BLOCK, block_k=BLOCK)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == tdt and tuple(a.shape) == w.shape, name
        w = np.asarray(w, np.float32)
        atol = (F32_ATOL if dtype == "float32"
                else BF16_RTOL * float(np.abs(w).max()))
        np.testing.assert_allclose(a.float().numpy(), w, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_grads_match_jax_grad(dtype, causal):
    """The public [B, L, H, D] entry point: gradients of sum(o²) against
    ``jax.grad`` of the JAX ``flash_attention`` (block 16 on both)."""
    rng = np.random.RandomState(7)
    qn = rng.randn(B, L, H, D).astype(np.float32)
    kn = rng.randn(B, L, KVH, D).astype(np.float32)
    vn = rng.randn(B, L, KVH, D).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jloss(q, k, v):
        o = jflash.flash_attention(q, k, v, causal=causal, block_q=BLOCK,
                                   block_k=BLOCK, bwd="pallas")
        return jnp.sum(o.astype(jnp.float32) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a).astype(jdt) for a in (qn, kn, vn)))
    ts = [_t(a, tdt).requires_grad_() for a in (qn, kn, vn)]
    o = tflash.flash_attention(*ts, causal=causal, block_q=BLOCK,
                               block_k=BLOCK, bwd="kernel")
    (o.float() ** 2).sum().backward()
    for name, t, w in zip(("dq", "dk", "dv"), ts, want):
        w = np.asarray(w, np.float32)
        # bf16: the forward's o is rounded too, so dO = 2·o carries one
        # more bf16 rounding than the backward alone.
        atol = (F32_ATOL * max(1.0, float(np.abs(w).max()))
                if dtype == "float32"
                else 2 * BF16_RTOL * float(np.abs(w).max()))
        np.testing.assert_allclose(t.grad.float().numpy(), w, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_default_backward_matches_blockwise_oracle(causal):
    """The two-pass backward == the blockwise recompute oracle (f32, GQA,
    a tail block), the port's twin of
    test_flash_pallas_bwd_matches_blockwise_oracle."""
    rng = np.random.RandomState(3)
    qn = rng.randn(B, L, H, D).astype(np.float32)
    kn = rng.randn(B, L, KVH, D).astype(np.float32)
    vn = rng.randn(B, L, KVH, D).astype(np.float32)

    def grads(bwd):
        ts = [torch.from_numpy(a).requires_grad_() for a in (qn, kn, vn)]
        o = tflash.flash_attention(*ts, causal=causal, block_q=BLOCK,
                                   block_k=BLOCK, bwd=bwd)
        (o ** 2).sum().backward()
        return [t.grad for t in ts]

    for a, b in zip(grads("kernel"), grads("blockwise")):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=F32_ATOL)


def test_backward_env_knob_selects_blockwise(monkeypatch):
    """``HVD_TORCH_FLASH_BWD=blockwise`` routes the backward to the oracle
    and never to the plain two-pass backward."""
    def boom(*a, **k):
        raise AssertionError("the two-pass backward was called")

    monkeypatch.setattr(tflash, "_flash_backward", boom)
    monkeypatch.setenv("HVD_TORCH_FLASH_BWD", "blockwise")
    q, k, v, _ = (torch.from_numpy(a) for a in _np(seed=1))
    qs = q.reshape(B, H, L, D).transpose(1, 2).requires_grad_()
    ks = k.reshape(B, KVH, L, D).transpose(1, 2)
    vs = v.reshape(B, KVH, L, D).transpose(1, 2)
    tflash.flash_attention(qs, ks, vs, block_q=BLOCK, block_k=BLOCK).sum(
    ).backward()
    assert qs.grad is not None and torch.isfinite(qs.grad).all()


def test_cpu_backward_never_touches_the_kernels(monkeypatch):
    """CPU tensors take the plain backward: no CUDA wrapper is entered and
    no counter moves."""
    def boom(*a, **k):
        raise AssertionError("CPU tensors reached a CUDA wrapper")

    for name in ("_flash_forward_cuda", "_flash_bwd_dq_cuda",
                 "_flash_bwd_dkv_cuda", "_flash_backward_cuda"):
        monkeypatch.setattr(tflash, name, boom)
    for name in ("launches", "dq_launches", "dkv_launches"):
        monkeypatch.setattr(tflash, name, 0)
    rng = np.random.RandomState(2)
    ts = [torch.from_numpy(rng.randn(B, L, n, D).astype(np.float32))
          .requires_grad_() for n in (H, KVH, KVH)]
    tflash.flash_attention(*ts, block_q=BLOCK, block_k=BLOCK).sum().backward()
    assert all(t.grad is not None for t in ts)
    assert tflash.launches == tflash.dq_launches == tflash.dkv_launches == 0


@pytest.mark.parametrize("wrapper", ["_flash_bwd_dq_cuda",
                                     "_flash_bwd_dkv_cuda"])
def test_backward_wrappers_reject_cpu_tensors_and_head_dims(wrapper):
    """The kernel wrappers check device and head width before they build
    anything: a CPU tensor and a head dim outside {64, 128} both raise."""
    fn = getattr(tflash, wrapper)
    q = torch.zeros((H, 16, 128), dtype=torch.bfloat16)
    k = torch.zeros((KVH, 16, 128), dtype=torch.bfloat16)
    lse = torch.zeros((H, 16), dtype=torch.float32)
    with pytest.raises(ValueError, match="not CUDA"):
        fn(q, k, k, q, lse, lse, n_heads=H, n_kv_heads=KVH, causal=True)
    q96, k96 = q[..., :96].contiguous(), k[..., :96].contiguous()
    with pytest.raises(ValueError, match=r"head dim 96.*\(64, 128\)"):
        fn(q96, k96, k96, q96, lse, lse, n_heads=H, n_kv_heads=KVH,
           causal=True)


def test_backward_reference_group_sums_per_query_head():
    """With KVH = H/2, dK of each KV head is the sum of its two query heads'
    per-head dK: swapping the KV index map would break this."""
    q, k, v, g = (torch.from_numpy(a) for a in _np(seed=9))
    kw = dict(n_heads=H, n_kv_heads=KVH, causal=True, block_q=BLOCK,
              block_k=BLOCK)
    o, lse = tflash._flash_forward_reference(q, k, v, **kw)
    _, dk, dv = tflash._flash_backward_reference(q, k, v, o, lse, g, **kw)
    rows = tflash._kv_rows(B * H, H, KVH, "cpu")
    # expand KV to one head per query head: then the backward is per head
    _, dk_h, dv_h = tflash._flash_backward_reference(
        q, k[rows], v[rows], o, lse, g, n_heads=H, n_kv_heads=H, causal=True,
        block_q=BLOCK, block_k=BLOCK)
    np.testing.assert_allclose(dk.numpy(), tflash._group_sum(
        dk_h, H, KVH).numpy(), atol=1e-6)
    np.testing.assert_allclose(dv.numpy(), tflash._group_sum(
        dv_h, H, KVH).numpy(), atol=1e-6)
