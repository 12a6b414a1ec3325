"""The hand-written flash-attention kernel against its plain version, on the card.

The CUDA kernel has no CPU mode, so these tests carry the ``cuda`` marker
and skip without a GPU.  This file imports only torch and the port (no
JAX), so it runs on a machine with the card and no JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_flash_kernel.py
"""

from __future__ import annotations

import pytest
import torch

from horovod_tpu_torch.parallel import flash_attention as tflash


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_reference_on_card(causal):
    """The hand-written kernel against its plain version on the card
    (Llama-3-8B head widths, a ragged tail).  Tolerance as in
    chip_smoke.py: two bf16 units in the last place relative to |o|."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    h, kvh, d, l = 32, 8, 128, 300
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((2 * h, l, d), generator=g, device="cuda").bfloat16()
    k = torch.randn((2 * kvh, l, d), generator=g, device="cuda").bfloat16()
    v = torch.randn((2 * kvh, l, d), generator=g, device="cuda").bfloat16()
    before = tflash.launches
    o, lse = tflash._flash_forward_cuda(q, k, v, n_heads=h, n_kv_heads=kvh,
                                        causal=causal)
    torch.cuda.synchronize()
    assert tflash.launches == before + 1
    o_ref, lse_ref = tflash._flash_forward_reference(
        q, k, v, n_heads=h, n_kv_heads=kvh, causal=causal, block_q=l,
        block_k=l)
    diff = (o.float() - o_ref.float()).abs()
    assert float((diff - 2 ** -7 * o_ref.float().abs()).max()) <= 1e-2
    assert float((lse - lse_ref).abs().max()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_kernels_match_reference_on_card(causal):
    """The dQ and dK/dV kernels against their plain versions on the card
    (Llama-3-8B head widths, GQA 32/8, a ragged tail), O and LSE from the
    forward kernel.  Tolerance as in chip_smoke.py: 2**-6 of the largest
    |grad| of each tensor (three bf16 roundings compound)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    h, kvh, d, l = 32, 8, 128, 300
    g = torch.Generator(device="cuda").manual_seed(1)
    q, do = (torch.randn((2 * h, l, d), generator=g, device="cuda").bfloat16()
             for _ in range(2))
    k, v = (torch.randn((2 * kvh, l, d), generator=g, device="cuda").bfloat16()
            for _ in range(2))
    kw = dict(n_heads=h, n_kv_heads=kvh, causal=causal)
    o, lse = tflash._flash_forward_cuda(q, k, v, **kw)
    delta = tflash._delta(o, do)
    lse = lse.view(2 * h, l)
    before = (tflash.dq_launches, tflash.dkv_launches)
    dq = tflash._flash_bwd_dq_cuda(q, k, v, do, lse, delta, **kw)
    dk_h, dv_h = tflash._flash_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert (tflash.dq_launches, tflash.dkv_launches) == (before[0] + 1,
                                                         before[1] + 1)
    ref_kw = dict(kw, block_q=l, block_k=l)
    dq_ref = tflash._flash_bwd_dq_reference(q, k, v, do, lse, delta, **ref_kw)
    dk_ref, dv_ref = tflash._flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                     **ref_kw)
    for got, ref in ((dq, dq_ref), (dk_h, dk_ref), (dv_h, dv_ref)):
        err = float((got.float() - ref.float()).abs().max())
        assert err <= 2 ** -6 * float(ref.float().abs().max())
    # The full backward (delta, both kernels, the GQA group-sum) against
    # the plain backward.
    got = tflash._flash_backward_cuda(q, k, v, o, lse, do, **kw)
    want = tflash._flash_backward_reference(q, k, v, o, lse, do, **ref_kw)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        err = float((a.float() - b.float()).abs().max())
        assert err <= 2 ** -6 * float(b.float().abs().max())
