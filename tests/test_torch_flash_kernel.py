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
