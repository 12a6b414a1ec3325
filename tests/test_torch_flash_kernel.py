"""The hand-written flash-attention kernels against their plain versions, on the card.

The CUDA kernels have no CPU mode, so these tests carry the ``cuda`` marker
and skip without a GPU.  This file imports only torch and the port (no
JAX), so it runs on a machine with the card and no JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_flash_kernel.py

Llama-3's head dim 128 and the ViT's head dim 64: at each the Hopper
kernels for bf16/f16 (``hvd_flash_fwd``, ``hvd_flash_fwd_d64`` and the
backward pairs) and the ``mma.sync`` kernels for f32; and the ``mma.sync``
forward at D = 64 in bf16/f16 called directly, the same-run yardstick of
``chip_smoke.py``.
"""

from __future__ import annotations

import pytest
import torch

from horovod_tpu_torch.parallel import flash_attention as tflash

H, KVH, D = 32, 8, 128            # Llama-3-8B attention heads
VIT_HEADS = (12, 12, 64)          # ViT-B/16: 12 heads of 64, no GQA
# o against the plain version at the kernel's own tiles, as in
# chip_smoke.py: about two units in the last place of the storage dtype
# relative to |o|; the LSE is f32 from exact products.
O_TOL = {torch.bfloat16: (1e-2, 2 ** -7), torch.float16: (2e-3, 2 ** -9),
         torch.float32: (1e-4, 1e-5)}
LSE_TOL = 1e-3


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _qkv(b, l, dtype, seed, heads=(H, KVH, D)):
    h, kvh, d = heads
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b * h, l, d), generator=g, device="cuda").to(dtype)
    k = torch.randn((b * kvh, l, d), generator=g, device="cuda").to(dtype)
    v = torch.randn((b * kvh, l, d), generator=g, device="cuda").to(dtype)
    return q, k, v


def _check_forward(q, k, v, causal, block, heads=(H, KVH, D)):
    h, kvh, _ = heads
    before = tflash.launches
    o, lse = tflash._flash_forward_cuda(q, k, v, n_heads=h, n_kv_heads=kvh,
                                        causal=causal)
    torch.cuda.synchronize()
    assert tflash.launches == before + 1
    o_ref, lse_ref = tflash._flash_forward_reference(
        q, k, v, n_heads=h, n_kv_heads=kvh, causal=causal, block_q=block,
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


def _check_backward(b, l, causal, dtype, seed, heads=(H, KVH, D)):
    """Both backward kernels (through their wrappers, each counting one
    launch) and the whole kernel backward against the plain versions, O and
    LSE from the forward kernel."""
    h, kvh, d = heads
    rtol = BWD_RTOL[dtype]
    q, k, v = _qkv(b, l, dtype, seed=seed, heads=heads)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    do = torch.randn((b * h, l, d), generator=g, device="cuda").to(dtype)
    kw = dict(n_heads=h, n_kv_heads=kvh, causal=causal)
    o, lse = tflash._flash_forward_cuda(q, k, v, **kw)
    delta = tflash._delta(o, do)
    lse = lse.view(b * h, l)
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


# Head dim 64, the ViT's: the three kernels take the Hopper D = 64 kernels
# for bf16/f16 and the mma.sync kernels for f32, all on 64 × 64 tiles, so
# the forward's plain version is blocked 64 × 64.


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("l", [1, 63, 65, 196, 1000])
def test_flash_kernel_d64_matches_reference_on_card(l, causal, dtype):
    """The forward at D = 64 (ViT-B/16 heads: 12 of 64, no GQA) against its
    plain version at its 64 × 64 tiles, B = 2, tails on both sides of a
    tile and the ViT's L = 196; and GQA 4/2 at D = 64.  bf16/f16 launch
    the Hopper D = 64 kernel, f32 the mma.sync kernel."""
    _need_card()
    entries = []
    launch = tflash._launch
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tflash, "_launch", lambda name, fn, *a: (
            entries.append(fn), launch(name, fn, *a))[1])
        _check_forward(*_qkv(2, l, dtype, seed=l, heads=VIT_HEADS), causal,
                       block=64, heads=VIT_HEADS)
        gqa = (4, 2, 64)
        _check_forward(*_qkv(2, l, dtype, seed=l + 1, heads=gqa), causal,
                       block=64, heads=gqa)
    want = ("hvd_flash_fwd_mma" if dtype == torch.float32
            else "hvd_flash_fwd_d64")
    assert entries == [want] * 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("l", [65, 196])
def test_flash_mma_kernel_d64_matches_reference_on_card(l, causal, dtype):
    """The mma.sync forward at D = 64 in bf16/f16, which the wrapper no
    longer routes to but chip_smoke.py times as ``prev_ms``, called through
    its entry against its plain version at its 64 × 64 tiles: ViT-B/16
    heads and GQA 4/2, B = 2."""
    _need_card()
    for seed, heads in ((l, VIT_HEADS), (l + 1, (4, 2, 64))):
        h, kvh, _ = heads
        q, k, v = _qkv(2, l, dtype, seed=seed, heads=heads)
        o = torch.empty_like(q)
        lse = torch.empty((q.shape[0], l, 1), dtype=torch.float32,
                          device="cuda")
        tflash._launch("flash_fwd", "hvd_flash_fwd_mma", (q, k, v, o, lse), q,
                       h, kvh, causal)
        torch.cuda.synchronize()
        o_ref, lse_ref = tflash._flash_forward_reference(
            q, k, v, n_heads=h, n_kv_heads=kvh, causal=causal, block_q=64,
            block_k=64)
        atol, rtol = O_TOL[dtype]
        diff = (o.float() - o_ref.float()).abs()
        assert bool(torch.isfinite(o.float()).all())
        assert float((diff - rtol * o_ref.float().abs()).max()) <= atol
        assert float((lse - lse_ref).abs().max()) <= LSE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("l", [1, 63, 65, 196, 1000])
def test_flash_bwd_kernels_d64_match_reference_on_card(monkeypatch, l, causal,
                                                       dtype):
    """The dQ and dK/dV kernels at D = 64 (the Hopper D = 64 kernels for
    bf16/f16, the mma.sync kernels for f32) against their plain versions,
    B = 2, ViT-B/16 heads and GQA 4/2."""
    _need_card()
    launched = []
    launch = tflash._launch
    monkeypatch.setattr(tflash, "_launch", lambda name, fn, *a: (
        launched.append(fn), launch(name, fn, *a))[1])
    _check_backward(2, l, causal, dtype, seed=l + 3, heads=VIT_HEADS)
    _check_backward(2, l, causal, dtype, seed=l + 4, heads=(4, 2, 64))
    want = ({"hvd_flash_bwd_dq_mma", "hvd_flash_bwd_dkv_mma"}
            if dtype == torch.float32 else
            {"hvd_flash_bwd_dq_d64", "hvd_flash_bwd_dkv_d64"})
    assert set(f for f in launched if "bwd" in f) == want


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 96, 256])
def test_flash_kernels_refuse_other_head_dims_on_card(d):
    """A CUDA call at a head dim the kernels do not take raises; it never
    takes the plain version."""
    _need_card()
    q, k, v = _qkv(1, 64, torch.bfloat16, seed=d, heads=(2, 2, d))
    before = tflash.launches
    with pytest.raises(ValueError, match="head dims"):
        tflash._flash_forward_cuda(q, k, v, n_heads=2, n_kv_heads=2,
                                   causal=False)
    lse = torch.zeros((2, 64), device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        tflash._flash_bwd_dq_cuda(q, k, v, q, lse, lse, n_heads=2,
                                  n_kv_heads=2, causal=False)
    with pytest.raises(ValueError, match="head dims"):
        tflash.flash_attention(q.view(1, 2, 64, d).transpose(1, 2),
                               k.view(1, 2, 64, d).transpose(1, 2),
                               v.view(1, 2, 64, d).transpose(1, 2),
                               causal=False)
    assert tflash.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("b, l, causal, dtype, heads", [
    (1, 4096, True, torch.bfloat16, (H, KVH, D)),     # Llama training shape
    (2, 1000, True, torch.float16, (H, KVH, D)),
    (2, 200, True, torch.float32, (H, KVH, D)),
    (64, 196, False, torch.bfloat16, VIT_HEADS),      # ViT-B/16
    (64, 196, False, torch.float16, VIT_HEADS),
    (2, 333, True, torch.float16, VIT_HEADS),
    (2, 333, True, torch.bfloat16, (4, 2, 64)),
    (2, 65, False, torch.float32, VIT_HEADS),
], ids=["llama_train_bf16", "d128_f16", "d128_f32", "vit_b16_bf16",
        "vit_b16_f16", "d64_f16", "d64_gqa_bf16", "d64_f32"])
def test_flash_kernels_repeat_bit_for_bit_on_card(b, l, causal, dtype,
                                                  heads):
    """Each kernel owns its outputs (no atomics), so repeated launches on
    the same inputs give the same bits; a race between a block's warps (a
    missing barrier or mbarrier wait) shows as a launch that differs."""
    _need_card()
    h, kvh, d = heads
    q, k, v = _qkv(b, l, dtype, seed=11, heads=heads)
    g = torch.Generator(device="cuda").manual_seed(12)
    do = torch.randn((b * h, l, d), generator=g, device="cuda").to(dtype)
    kw = dict(n_heads=h, n_kv_heads=kvh, causal=causal)

    def run():
        o, lse = tflash._flash_forward_cuda(q, k, v, **kw)
        lse = lse.view(b * h, l)
        delta = tflash._delta(o, do)
        dq = tflash._flash_bwd_dq_cuda(q, k, v, do, lse, delta, **kw)
        return (o, lse, dq, *tflash._flash_bwd_dkv_cuda(q, k, v, do, lse,
                                                        delta, **kw))

    first = run()
    for _ in range(30):
        again = run()
        for name, a, b_ in zip(("o", "lse", "dq", "dk", "dv"), first, again):
            assert torch.equal(a, b_), f"{name} differs between launches"
