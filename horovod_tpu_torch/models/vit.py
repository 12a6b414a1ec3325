"""Vision Transformer: port of ``horovod_tpu/models/vit.py``.

``ViT`` and ``ViT_S16/B16/L16``: patchify as one strided conv, learned
position embeddings, pre-LN blocks, mean-pool, linear head; ``dtype`` the
computation dtype with f32 parameters.  flax's numbers are kept: LayerNorm
epsilon 1e-6 (:class:`.layers.LayerNorm`), ``nn.gelu``'s tanh
approximation, and the dense attention's rounding points (scores in
``dtype``, softmax in f32, probabilities cast back to ``dtype``).

``attn_impl="flash"`` runs :func:`..parallel.flash_attention.flash_attention`
non-causal: on the card the hand-written forward, dQ and dK/dV kernels at
head dim 64, once per block and step, routed by dtype in
``flash_attention._FWD_ENTRY`` and ``_BWD_ENTRY``: bf16/fp16 to the Hopper
kernels ``hvd_flash_fwd_d64`` (``csrc/flash_fwd_d64.cu``) and
``hvd_flash_bwd_dq_d64``/``hvd_flash_bwd_dkv_d64``
(``csrc/flash_bwd_d64.cu``), f32 to the ``mma.sync`` kernels
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``).  An unknown ``attn_impl``
raises.  NHWC input as in the JAX
package; the logits come back in ``dtype``, as there.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.layers import (Conv, Dense, LayerNorm,
                                             init_and_place, nhwc_input)
from horovod_tpu_torch.parallel.flash_attention import flash_attention

ATTN_IMPLS = ("dense", "flash")


class _Attention(nn.Module):
    def __init__(self, dim: int, n_heads: int, dtype: torch.dtype,
                 attn_impl: str):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            # A typo must not silently run dense attention.
            raise ValueError(f"unknown attn_impl {attn_impl!r}; expected "
                             f"'dense' or 'flash'")
        self.n_heads, self.dtype, self.attn_impl = n_heads, dtype, attn_impl
        self.qkv = Dense(dim, 3 * dim, dtype)
        self.proj = Dense(dim, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, d = x.shape
        hd = d // self.n_heads
        q, k, v = (t.reshape(b, l, self.n_heads, hd)
                   for t in self.qkv(x).split(d, dim=-1))
        if self.attn_impl == "flash":
            # Bidirectional: every patch attends to all.
            out = flash_attention(q, k, v, causal=False)
        else:
            # The scale rounds to dtype first, as jnp.sqrt of a dtype array.
            scale = float(torch.tensor(hd, dtype=self.dtype).sqrt())
            scores = torch.einsum("blhd,bmhd->bhlm", q, k) / scale
            probs = torch.softmax(scores.float(), dim=-1).to(self.dtype)
            out = torch.einsum("bhlm,bmhd->blhd", probs, v)
        return self.proj(out.reshape(b, l, d))


class _Block(nn.Module):
    def __init__(self, dim: int, n_heads: int, mlp_ratio: int,
                 dtype: torch.dtype, attn_impl: str):
        super().__init__()
        self.ln1 = LayerNorm(dim, dtype)
        self.attn = _Attention(dim, n_heads, dtype, attn_impl)
        self.ln2 = LayerNorm(dim, dtype)
        self.fc1 = Dense(dim, mlp_ratio * dim, dtype)
        self.fc2 = Dense(mlp_ratio * dim, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        h = F.gelu(self.fc1(self.ln2(x)), approximate="tanh")
        return x + self.fc2(h)


class ViT(nn.Module):
    """Patchify → pre-LN encoder → mean-pool → linear head
    (``vit.py:81``).  ``image_size`` fixes the number of patches and so the
    position embedding's length."""

    def __init__(self, patch: int = 16, dim: int = 768, depth: int = 12,
                 n_heads: int = 12, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "dense",
                 *, image_size: int = 224, device=None,
                 seed: int | torch.Generator = 0):
        super().__init__()
        self.dtype, self.attn_impl = dtype, attn_impl
        n = (image_size // patch) ** 2
        self.patchify = Conv(3, dim, (patch, patch), (patch, patch),
                             dtype=dtype)
        self.pos_embed = nn.Parameter(torch.empty(1, n, dim))
        self.blocks = []
        for i in range(depth):
            blk = _Block(dim, n_heads, 4, dtype, attn_impl)
            self.add_module(f"block{i}", blk)
            self.blocks.append(blk)
        self.ln_out = LayerNorm(dim, dtype)
        self.head = Dense(dim, num_classes, dtype)
        gen = seed if isinstance(seed, torch.Generator) else \
            torch.Generator().manual_seed(seed)
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02, generator=gen)
        init_and_place(self, gen, device)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        del train                    # no dropout or BN: the ResNet's API
        x = self.patchify(nhwc_input(x, self.dtype))
        b, d = x.shape[:2]
        x = x.permute(0, 2, 3, 1).reshape(b, -1, d)    # patches in NHWC order
        x = x + self.pos_embed.to(self.dtype)
        for blk in self.blocks:
            x = blk(x)
        return self.head(self.ln_out(x).mean(dim=1))


def ViT_S16(**kw) -> ViT:
    """ViT-Small/16 (22M parameters)."""
    return ViT(patch=16, dim=384, depth=12, n_heads=6, **kw)


def ViT_B16(**kw) -> ViT:
    """ViT-Base/16 (86M parameters): the standard benchmark configuration,
    head dim 64."""
    return ViT(patch=16, dim=768, depth=12, n_heads=12, **kw)


def ViT_L16(**kw) -> ViT:
    """ViT-Large/16 (307M parameters)."""
    return ViT(patch=16, dim=1024, depth=24, n_heads=16, **kw)
