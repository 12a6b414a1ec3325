"""Port parity: horovod_tpu_torch attention engines against the JAX reference.

The same numpy inputs (seeded) go through the JAX function (the Pallas
flash kernel in interpret mode, as tests/test_attention.py runs it on the
CPU) and through its port counterpart.  On CPU tensors the port's flash
path is its plain reference; the CUDA kernel itself is held against that
reference by tests/test_torch_flash_kernel.py and by ``chip_smoke.py``.
"""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.parallel import attention as jattn
from horovod_tpu_torch.parallel import attention as tattn
from horovod_tpu_torch.parallel import flash_attention as tflash

# The package re-exports the function under the module's name.
jflash = importlib.import_module("horovod_tpu.parallel.flash_attention")

# f32: same algorithm and block order, only the summation order of the
# products differs (~1e-7 relative).
F32_ATOL = 1e-5
# bf16 outputs: both sides round P to bf16 from f32 values that agree to
# ~1e-7 and round o to bf16 once; a tie broken differently is one bf16 ulp,
# 2**-7 for |o| in [1, 2) (random N(0,1) inputs keep |o| below 2 here).
BF16_ATOL = 2 ** -7
# The log-sum-exp is f32 in both from the same f32 scores.
LSE_ATOL = 1e-5


def _np_qkv(b, l, h, kvh, d, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, l, h, d).astype(np.float32),
            rng.randn(b, l, kvh, d).astype(np.float32),
            rng.randn(b, l, kvh, d).astype(np.float32))


def _jax(a, dtype):
    return jnp.asarray(a).astype(dtype)


def _torch(a, dtype):
    return torch.from_numpy(a).to(dtype)


def _flat(a):
    """[B, L, H, D] numpy → [B·H, L, D]."""
    b, l, h, d = a.shape
    return np.ascontiguousarray(a.transpose(0, 2, 1, 3).reshape(b * h, l, d))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_forward_o_and_lse_match_jax(dtype, causal):
    """GQA (H=4, KVH=2), L=40 with 16-blocks (a padded tail): o and LSE
    of the port's reference == JAX ``_flash_forward`` (interpret mode)."""
    b, l, h, kvh, d = 2, 40, 4, 2, 16
    q, k, v = (_flat(a) for a in _np_qkv(b, l, h, kvh, d, seed=3))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jo, jlse = jflash._flash_forward(
        _jax(q, jdt), _jax(k, jdt), _jax(v, jdt), n_heads=h, n_kv_heads=kvh,
        causal=causal, block_q=16, block_k=16, interpret=True)
    to, tlse = tflash._flash_forward_reference(
        _torch(q, tdt), _torch(k, tdt), _torch(v, tdt), n_heads=h,
        n_kv_heads=kvh, causal=causal, block_q=16, block_k=16)
    assert to.dtype == tdt and tlse.dtype == torch.float32
    assert tuple(tlse.shape) == (b * h, l, 1)
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo, np.float32), atol=atol)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse)[:, :l],
                               atol=LSE_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_public_matches_jax(dtype, causal):
    """The public [B, L, H, D] entry point, transposes and block clamp
    included (block 512 clamps to L=40)."""
    q, k, v = _np_qkv(2, 40, 4, 2, 16, seed=4)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jflash.flash_attention(_jax(q, jdt), _jax(k, jdt), _jax(v, jdt),
                                  causal=causal)
    got = tflash.flash_attention(_torch(q, tdt), _torch(k, tdt),
                                 _torch(v, tdt), causal=causal)
    assert got.dtype == tdt and tuple(got.shape) == q.shape
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol)


def test_flash_rejects_mixed_dtypes():
    q, k, v = (torch.from_numpy(a) for a in _np_qkv(1, 16, 2, 1, 8))
    with pytest.raises(ValueError, match="one dtype"):
        tflash.flash_attention(q, k.bfloat16(), v.bfloat16())
    with pytest.raises(ValueError, match="bwd"):
        tflash.flash_attention(q, k, v, bwd="pallas")


def test_flash_cpu_dispatch_never_touches_the_kernel(monkeypatch):
    """CPU tensors take the reference: the launch counter stays put and the
    kernel wrapper is never entered."""
    def boom(*a, **k):
        raise AssertionError("CPU tensors reached the CUDA wrapper")

    monkeypatch.setattr(tflash, "_flash_forward_cuda", boom)
    monkeypatch.setattr(tflash, "launches", 0)
    q, k, v = (torch.from_numpy(a) for a in _np_qkv(2, 24, 4, 2, 8))
    tflash.flash_attention(q, k, v, causal=True, block_q=8, block_k=8)
    assert tflash.launches == 0


def test_flash_cuda_wrapper_rejects_cpu_tensors():
    """The kernel wrapper checks the device before it builds anything."""
    q, k, v = (_torch(_flat(a), torch.bfloat16)
               for a in _np_qkv(1, 16, 2, 1, 128))
    with pytest.raises(ValueError, match="not CUDA"):
        tflash._flash_forward_cuda(q, k, v, n_heads=2, n_kv_heads=1,
                                   causal=True)


@pytest.mark.parametrize("b", [1, 2])
def test_flash_hands_contiguous_rows_to_the_forward(monkeypatch, b):
    """At B=1 a transpose+reshape can be a strided view; the kernel needs
    contiguous [B·H, L, D] rows, so the entry point must make them."""
    seen = []
    real = tflash._flash_forward

    def spy(q, k, v, **kw):
        seen.append(all(t.is_contiguous() for t in (q, k, v)))
        return real(q, k, v, **kw)

    monkeypatch.setattr(tflash, "_flash_forward", spy)
    q, k, v = (torch.from_numpy(a) for a in _np_qkv(b, 24, 4, 2, 8))
    tflash.flash_attention(q, k, v)
    assert seen == [True]


@pytest.mark.parametrize("bwd", ["kernel", "blockwise"])
def test_flash_backward_on_cpu_matches_dense(bwd):
    """On CPU tensors the backward differentiates through the reference
    (``kernel``) or recomputes through blockwise attention; both equal the
    dense gradient in f32."""
    qn, kn, vn = _np_qkv(1, 24, 4, 2, 8, seed=6)

    def grads(fn):
        q, k, v = (torch.from_numpy(a).requires_grad_() for a in (qn, kn, vn))
        (fn(q, k, v) ** 2).sum().backward()
        return q.grad, k.grad, v.grad

    gf = grads(lambda q, k, v: tflash.flash_attention(
        q, k, v, causal=True, block_q=8, block_k=8, bwd=bwd))
    gd = grads(lambda q, k, v: tattn.dense_attention(q, k, v, causal=True))
    for a, b in zip(gf, gd):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("offset", [0, 7])
def test_dense_attention_matches_jax(causal, offset):
    q, k, v = _np_qkv(2, 20, 4, 2, 8, seed=1)
    want = jattn.dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 causal=causal, q_offset=offset,
                                 kv_offset=offset)
    got = tattn.dense_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal,
                                q_offset=offset, kv_offset=offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block", [16, 64])   # 16: a padded tail block
def test_blockwise_attention_matches_jax(causal, block):
    q, k, v = _np_qkv(2, 40, 4, 2, 8, seed=2)
    want = jattn.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal,
                                     block_size=block)
    got = tattn.blockwise_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=causal,
                                    block_size=block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)
