"""The benchmark's yardstick: peaks, model FLOPs and kernel rooflines.

Everything here is counted from published shapes, never from what the
program launches, so a change to the program cannot move its own
yardstick.  ``train_flops``, ``flash_flops``/``flash_bound`` and
``bwd_flops`` are copied from the port's chip smoke script
(``chip_smoke.py`` ``_train_flops``, ``_flash_flops``, ``_flash_bound``,
``_bwd_flops``); ``train_flops`` is widened from one sequence to a batch.
"""

from __future__ import annotations

# One H100 SXM, dense rates (NVIDIA's data sheet), at the 700 W limit.
PEAK_FLOPS = {"bf16": 989e12, "f16": 989e12, "f32": 67e12}
PEAK_BYTES = 3.35e12


def train_flops(dim: int, n_layers: int, n_heads: int, n_kv_heads: int,
                ffn_dim: int, vocab: int, batch: int, seq: int) -> float:
    """Model FLOP of one train step of a Llama-block decoder over
    ``batch`` causal sequences of ``seq`` tokens: 6·N·T for the N weights
    of the layers' and the lm_head's products, plus six attention products
    per layer (Q·Kᵀ and P·V forward; dP, dV, dQ and dK backward) over each
    sequence's causal triangle.  Recomputation (remat) is not counted."""
    head_dim = dim // n_heads
    kdim = n_kv_heads * head_dim
    n_mm = n_layers * (2 * dim * dim + 2 * dim * kdim + 3 * dim * ffn_dim) \
        + dim * vocab
    pairs = seq * (seq + 1) // 2
    attn = n_layers * 6 * 2 * n_heads * head_dim * pairs * batch
    return 6 * n_mm * seq * batch + attn


def flash_flops(b, h, l, d, causal) -> int:
    pairs = l * (l + 1) // 2 if causal else l * l
    return 4 * b * h * d * pairs                  # Q·Kᵀ and P·V


def flash_bound(b, h, kvh, l, d, causal, elem, tname):
    """Least time (ms) of one attention forward, and what bounds it: the
    two products over the (causal) score matrix, against reading q, k, v
    once and writing o and the f32 log-sum-exp once."""
    flops = flash_flops(b, h, l, d, causal)
    nbytes = (2 * b * h + 2 * b * kvh) * l * d * elem + b * h * l * 4
    t_ops = flops / PEAK_FLOPS[tname]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def bwd_flops(b, h, l, d, causal, products) -> int:
    pairs = l * (l + 1) // 2 if causal else l * l
    return products * 2 * b * h * d * pairs


# The products an attention backward needs from q, k, v, o, dO and the
# log-sum-exp: S = Q·Kᵀ again (P is not kept), dP = dO·Vᵀ, dV = Pᵀ·dO,
# dQ = dS·K and dK = dSᵀ·Q.  A design that recomputes more (two kernels
# that each rebuild S and dP do seven) is not credited for it.
BWD_PRODUCTS = 5


def attn_bwd_bound(b, h, kvh, l, d, causal, elem, tname):
    """Least time (ms) of one attention backward, and what bounds it: the
    five products, against reading q, o, dO, k, v and the log-sum-exp once
    and writing dQ, dK and dV once."""
    flops = bwd_flops(b, h, l, d, causal, BWD_PRODUCTS)
    nbytes = (4 * b * h + 4 * b * kvh) * l * d * elem + b * h * l * 4
    t_ops = flops / PEAK_FLOPS[tname]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def resnet_forward_flops(stage_sizes, width: int, image: int, classes: int,
                         in_channels: int = 3) -> int:
    """FLOP (2 per multiply-add) of one image through a bottleneck ResNet
    v1.5's convolutions and its classifier, from He et al. 2015 table 1:
    the 7×7/2 stem, the 3×3/2 max-pool, stages of 1×1 → 3×3 (stride here)
    → 1×1 ×4 blocks with a 1×1 projection where the shape changes, and the
    dense head.  Normalisation, activations and additions are not
    counted."""
    macs = 0
    side = -(-image // 2)                                  # the stem
    macs += side * side * width * in_channels * 7 * 7
    side = -(-side // 2)                                   # the max-pool
    features = width
    for i, count in enumerate(stage_sizes):
        filters = width * 2 ** i
        for j in range(count):
            stride = 2 if i > 0 and j == 0 else 1
            out_side = -(-side // stride)
            macs += side * side * features * filters            # 1×1
            macs += out_side * out_side * filters * filters * 9  # 3×3
            macs += out_side * out_side * filters * filters * 4  # 1×1 ×4
            if features != filters * 4 or stride != 1:
                macs += out_side * out_side * features * filters * 4
            side, features = out_side, filters * 4
    macs += features * classes
    return 2 * macs
