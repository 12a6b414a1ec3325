"""What the benchmark hands to both sides: weights and batches from the seed.

Every tensor is drawn on the run's device by a ``torch.Generator`` seeded
from ``(seed, what, ...)``, so the program and the plain reference get the
same numbers without either taking anything the other made, and any
leaf or batch can be drawn again later on its own (the reference does,
after the program's state is freed).  Weights are f32, as the
configurations hold their master weights.
"""

from __future__ import annotations

import hashlib
import math

import torch

# flax's LeCun normal: truncated at ±2σ, σ corrected for the truncation.
_TRUNC_STD = 0.87962566103423978


def subseed(seed: int, *parts) -> int:
    """A 63-bit generator seed for ``(seed, *parts)``; ``seed`` may be any
    integer, however large."""
    text = "/".join(str(p) for p in (seed, *parts)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def generator(device, seed: int, *parts) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, *parts))


# -- decoder (Llama-block) weights --------------------------------------------

def llama_dims(c: dict) -> dict:
    """The sizes of a Llama-block configuration file, by short name."""
    d, h = c["hidden_size"], c["num_attention_heads"]
    return {"dim": d, "n_layers": c["num_hidden_layers"], "n_heads": h,
            "n_kv_heads": c["num_key_value_heads"],
            "head_dim": c.get("head_dim") or d // h,
            "ffn_dim": c["intermediate_size"], "vocab": c["vocab_size"],
            "rope_theta": float(c["rope_theta"]),
            "norm_eps": float(c["rms_norm_eps"])}


def llama_leaves(c: dict) -> list[tuple[str, tuple, int | None]]:
    """(name, shape, fan-in) of every weight, layers stacked on a leading
    axis, matrices as ``[in, out]`` for ``h @ w``; fan-in None for the
    RMSNorm scales, which start at one."""
    m = llama_dims(c)
    d, f, n, v = m["dim"], m["ffn_dim"], m["n_layers"], m["vocab"]
    q, k = m["n_heads"] * m["head_dim"], m["n_kv_heads"] * m["head_dim"]
    return [
        ("embed", (v, d), d),
        ("layers.attn_norm", (n, d), None),
        ("layers.wq", (n, d, q), d),
        ("layers.wk", (n, d, k), d),
        ("layers.wv", (n, d, k), d),
        ("layers.wo", (n, q, d), q),
        ("layers.mlp_norm", (n, d), None),
        ("layers.w_gate", (n, d, f), d),
        ("layers.w_up", (n, d, f), d),
        ("layers.w_down", (n, f, d), f),
        ("final_norm", (d,), None),
        ("lm_head", (d, v), d),
    ]


def llama_leaf(seed: int, name: str, shape, fan_in, device) -> torch.Tensor:
    """One weight: normal / sqrt(fan_in) in one draw, or ones."""
    if fan_in is None:
        return torch.ones(shape, dtype=torch.float32, device=device)
    w = torch.randn(shape, generator=generator(device, seed, "w", name),
                    dtype=torch.float32, device=device)
    return w.mul_(1.0 / math.sqrt(fan_in))


def lm_batch(seed: int, rank: int, step: int, batch: int, seq: int,
             vocab: int, device) -> torch.Tensor:
    """Rank ``rank``'s rows of step ``step``: ``batch`` rows of ``seq + 1``
    token ids uniform over the vocabulary (inputs, then targets shifted by
    one)."""
    return torch.randint(0, vocab, (batch, seq + 1), device=device,
                         generator=generator(device, seed, "tokens", rank,
                                             step))


# -- ResNet weights ------------------------------------------------------------

def resnet_leaves(c: dict) -> list[tuple[str, tuple, str, int]]:
    """(state-dict key, shape, kind, fan-in) of a bottleneck ResNet v1.5 in
    the port's (flax's) module names; kind is ``lecun``, ``ones``,
    ``zeros`` or ``last_scale``.  Each block's last batch-norm scale starts
    at the configuration's ``last_bn_scale``: above nought, so that every
    residual branch takes part in the first steps, and well under one, so
    that the first steps stay off the chaotic regime of 16 unit-scale
    branches summed, where float32 runs already part from float64 ones.
    Batch-norm running statistics are included (zeros, ones)."""
    width, classes = c["width"], c["num_classes"]
    out: list[tuple[str, tuple, str, int]] = []

    def conv(key, o, i, k):
        out.append((f"{key}.weight", (o, i, k, k), "lecun", i * k * k))

    def bn(key, n, scale="ones"):
        out.extend([(f"{key}.weight", (n,), scale, 0),
                    (f"{key}.bias", (n,), "zeros", 0),
                    (f"{key}.running_mean", (n,), "zeros", 0),
                    (f"{key}.running_var", (n,), "ones", 0)])

    conv("conv_init", width, c["in_channels"], 7)
    bn("bn_init", width)
    features, b = width, 0
    for i, count in enumerate(c["stage_sizes"]):
        filters = width * 2 ** i
        for j in range(count):
            stride = 2 if i > 0 and j == 0 else 1
            key = f"BottleneckBlock_{b}"
            conv(f"{key}.Conv_0", filters, features, 1)
            conv(f"{key}.Conv_1", filters, filters, 3)
            conv(f"{key}.Conv_2", filters * 4, filters, 1)
            for n, f in enumerate((filters, filters, filters * 4)):
                bn(f"{key}.BatchNorm_{n}", f,
                   "last_scale" if n == 2 else "ones")
            if features != filters * 4 or stride != 1:
                conv(f"{key}.downsample_conv", filters * 4, features, 1)
                bn(f"{key}.downsample_bn", filters * 4)
            features, b = filters * 4, b + 1
    out.append(("head.weight", (classes, features), "lecun", features))
    out.append(("head.bias", (classes,), "zeros", 0))
    return out


def resnet_state(c: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every weight and statistic of the ResNet: the LeCun-normal ones
    from one draw of standard truncated normals, each scaled by its
    σ = sqrt(1 / fan_in) / 0.8796."""
    leaves = resnet_leaves(c)
    n = sum(math.prod(s) for _, s, kind, _ in leaves if kind == "lecun")
    flat = torch.empty(n, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0,
                                generator=generator(device, seed, "resnet"))
    state, at = {}, 0
    for key, shape, kind, fan_in in leaves:
        if kind == "lecun":
            size = math.prod(shape)
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            state[key] = flat[at:at + size].view(shape) * std
            at += size
        elif kind == "ones":
            state[key] = torch.ones(shape, device=device)
        elif kind == "last_scale":
            state[key] = torch.full(shape, float(c["last_bn_scale"]),
                                    device=device)
        else:
            state[key] = torch.zeros(shape, device=device)
    return state


def image_batch(seed: int, rank: int, step: int, batch: int, side: int,
                channels: int, classes: int, device):
    """Rank ``rank``'s rows of step ``step``: NHWC standard normal images
    and uniform labels."""
    g = generator(device, seed, "images", rank, step)
    x = torch.randn((batch, side, side, channels), generator=g,
                    device=device)
    y = torch.randint(0, classes, (batch,), generator=g, device=device)
    return x, y
