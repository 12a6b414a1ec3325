"""The hand-written flash-attention kernels against their plain versions, on the card.

The CUDA kernels have no CPU mode, so these tests carry the ``cuda`` marker
and skip without a GPU.  This file imports only torch and the port (no
JAX), so it runs on a machine with the card and no JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_flash_kernel.py
"""

from __future__ import annotations

import pytest
import torch

from horovod_tpu_torch.parallel import flash_attention as tflash

H, KVH, D = 32, 8, 128            # Llama-3-8B attention heads
# o against the plain version at the kernel's own tiles, as in
# chip_smoke.py: about two units in the last place of the storage dtype
# relative to |o|; the LSE is f32 from exact products.
O_TOL = {torch.bfloat16: (1e-2, 2 ** -7), torch.float16: (2e-3, 2 ** -9),
         torch.float32: (1e-4, 1e-5)}
LSE_TOL = 1e-3


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _qkv(b, l, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b * H, l, D), generator=g, device="cuda").to(dtype)
    k = torch.randn((b * KVH, l, D), generator=g, device="cuda").to(dtype)
    v = torch.randn((b * KVH, l, D), generator=g, device="cuda").to(dtype)
    return q, k, v


def _check_forward(q, k, v, causal, block):
    before = tflash.launches
    o, lse = tflash._flash_forward_cuda(q, k, v, n_heads=H, n_kv_heads=KVH,
                                        causal=causal)
    torch.cuda.synchronize()
    assert tflash.launches == before + 1
    o_ref, lse_ref = tflash._flash_forward_reference(
        q, k, v, n_heads=H, n_kv_heads=KVH, causal=causal, block_q=block,
        block_k=block)
    atol, rtol = O_TOL[q.dtype]
    diff = (o.float() - o_ref.float()).abs()
    assert bool(torch.isfinite(o.float()).all())
    assert float((diff - rtol * o_ref.float().abs()).max()) <= atol
    assert float((lse - lse_ref).abs().max()) <= LSE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("l", [1, 127, 128, 129, 300, 1000])
def test_flash_kernel_matches_reference_on_card(l, b, causal, dtype):
    """The Hopper kernel (bf16/f16) against its plain version at its own
    128 × 128 tiles: ragged tails within one 128-row tile (127, 129, 300,
    1000), a single row, and B = 2 so a tail tile sits right before the
    next head's rows in memory."""
    _need_card()
    _check_forward(*_qkv(b, l, dtype, seed=l + b), causal, block=128)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_f32_takes_the_mma_kernel_on_card(causal):
    """f32 runs the mma.sync/FMA kernel (64 × 64 tiles): no TF32, so it
    matches the plain version to f32 summation order."""
    _need_card()
    _check_forward(*_qkv(2, 300, torch.float32, seed=7), causal, block=64)


# dQ, dK, dV against the plain versions, as in chip_smoke.py: relative to
# the largest |grad| of each tensor (three roundings of P and dS compound),
# plus a floor for gradients that cancel to f32 noise (at L = 1 dQ and dK
# are 0: softmax over one key is constant).
BWD_RTOL = {torch.bfloat16: 2 ** -6, torch.float16: 2 ** -8,
            torch.float32: 1e-4}
BWD_ATOL = 1e-4


def _check_backward(b, l, causal, dtype, seed):
    """Both backward kernels (through their wrappers, each counting one
    launch) and the whole kernel backward against the plain versions, O and
    LSE from the forward kernel."""
    rtol = BWD_RTOL[dtype]
    q, k, v = _qkv(b, l, dtype, seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    do = torch.randn((b * H, l, D), generator=g, device="cuda").to(dtype)
    kw = dict(n_heads=H, n_kv_heads=KVH, causal=causal)
    o, lse = tflash._flash_forward_cuda(q, k, v, **kw)
    delta = tflash._delta(o, do)
    lse = lse.view(b * H, l)
    before = (tflash.dq_launches, tflash.dkv_launches)
    dq = tflash._flash_bwd_dq_cuda(q, k, v, do, lse, delta, **kw)
    dk_h, dv_h = tflash._flash_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert (tflash.dq_launches, tflash.dkv_launches) == (before[0] + 1,
                                                         before[1] + 1)
    ref_kw = dict(kw, block_q=min(l, 512), block_k=min(l, 512))
    dq_ref = tflash._flash_bwd_dq_reference(q, k, v, do, lse, delta, **ref_kw)
    dk_ref, dv_ref = tflash._flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                     **ref_kw)
    for got, ref in ((dq, dq_ref), (dk_h, dk_ref), (dv_h, dv_ref)):
        assert bool(torch.isfinite(got.float()).all())
        err = float((got.float() - ref.float()).abs().max())
        assert err <= BWD_ATOL + rtol * float(ref.float().abs().max())
    # The full backward (delta, both kernels, the GQA group-sum) against
    # the plain backward.
    got = tflash._flash_backward_cuda(q, k, v, o, lse, do, **kw)
    want = tflash._flash_backward_reference(q, k, v, o, lse, do, **ref_kw)
    for a, b_ in zip(got, want):
        assert a.shape == b_.shape
        err = float((a.float() - b_.float()).abs().max())
        assert err <= BWD_ATOL + rtol * float(b_.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("l", [1, 63, 64, 65, 129, 1000])
def test_flash_bwd_kernels_match_reference_on_card(l, b, causal, dtype):
    """The Hopper dQ and dK/dV kernels (bf16/f16) against their plain
    versions on the card at Llama-3-8B head widths, GQA 32/8: L on both
    sides of the 64-row tiles and a single row, and B = 2 so a tail tile
    sits right before the next head's rows in memory."""
    _need_card()
    _check_backward(b, l, causal, dtype, seed=l + b)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_f32_takes_the_mma_kernels_on_card(monkeypatch, causal):
    """f32 runs the mma.sync/FMA backward kernels (no TF32) and matches
    the plain versions to f32 summation order."""
    _need_card()
    launched = []
    launch = tflash._launch
    monkeypatch.setattr(tflash, "_launch", lambda name, fn, *a: (
        launched.append(fn), launch(name, fn, *a))[1])
    _check_backward(2, 200, causal, torch.float32, seed=11)
    assert set(f for f in launched if "bwd" in f) == {
        "hvd_flash_bwd_dq_mma", "hvd_flash_bwd_dkv_mma"}
