"""The yardstick's arithmetic against hand-worked values."""

from __future__ import annotations

import pytest

from portbench import yardstick


def test_mistral_cell_step_is_197_6_tflop():
    # N = 8 layers × (2·4096² + 2·4096·1024 + 3·4096·14336) + 4096·32000
    #   = 8 × 218,103,808 + 131,072,000 = 1,875,902,464 weights in products;
    # 6·N·T at T = 4 × 4096 = 16,384 tokens: 184,408,715,821,056;
    # attention: 8 layers × 6 products × 2 × 32 heads × 128 × 4 sequences
    # × 4096·4097/2 pairs = 393,216 × 33,562,624 = 13,197,360,758,784.
    flops = yardstick.train_flops(4096, 8, 32, 8, 14336, 32000, 4, 4096)
    assert flops == 184_408_715_821_056 + 13_197_360_758_784
    assert flops == pytest.approx(197.6e12, rel=1e-3)


def test_resnet50_forward_is_4_089_g_multiply_adds():
    # He et al. 2015 table 1 at 224², v1.5 (stride on the 3×3), by stage:
    stem = 112 * 112 * 64 * 3 * 49                         # 118,013,952
    rest = 218_365_952                     # a 1×1 / 3×3 / 1×1 block at 56²
    stage1 = 231_211_008 + 2 * rest        # first block with its projection
    stage2 = 372_506_624 + 3 * rest        # down-sampling blocks: same MACs
    stage3 = 372_506_624 + 5 * rest
    stage4 = 372_506_624 + 2 * rest
    head = 2048 * 1000
    macs = stem + stage1 + stage2 + stage3 + stage4 + head
    assert macs == 4_089_184_256
    got = yardstick.resnet_forward_flops([3, 4, 6, 3], 64, 224, 1000)
    assert got == 2 * macs


def test_flash_bounds_at_the_training_shape():
    # One 4096-token causal sequence, 32/8 heads of 128, bf16: the forward
    # is 4·B·H·D·pairs = 1.3747e11 FLOP, 0.139 ms at 989 TFLOP/s (the PR
    # 10-16 chip records quote the same 0.1390 ms bound).
    ms, by = yardstick.flash_bound(1, 32, 8, 4096, 128, True, 2, "bf16")
    assert by == "operations"
    assert ms == pytest.approx(4 * 32 * 128 * 4096 * 4097 / 2 / 989e12 * 1e3)
    assert ms == pytest.approx(0.1390, abs=1e-4)
    # The backward needs five products to the forward's two.
    bwd, by = yardstick.attn_bwd_bound(1, 32, 8, 4096, 128, True, 2, "bf16")
    assert by == "operations"
    assert bwd == pytest.approx(ms * 5 / 2)
    # At four sequences both bounds scale by four.
    four, _ = yardstick.attn_bwd_bound(4, 32, 8, 4096, 128, True, 2, "bf16")
    assert four == pytest.approx(4 * bwd)


def test_a_short_call_is_bound_by_bytes():
    ms, by = yardstick.flash_bound(2, 32, 8, 8, 128, True, 2, "bf16")
    assert by == "bytes"
    nbytes = (2 * 2 * 32 + 2 * 2 * 8) * 8 * 128 * 2 + 2 * 32 * 8 * 4
    assert ms == pytest.approx(nbytes / yardstick.PEAK_BYTES * 1e3)
