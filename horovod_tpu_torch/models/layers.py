"""The flax.linen layers the vision models use, with flax's semantics in torch.

The JAX vision models (``horovod_tpu/models/{mnist,resnet,vgg,inception,
vit}.py``) are written with ``flax.linen``; their port keeps flax's numbers
where torch's defaults differ:

* :class:`Conv`: ``padding="SAME"`` pads ``(total // 2, total - total // 2)``
  per spatial axis, so a stride-2 3×3 conv on an even input pads (0, 1) where
  torch's ``padding=1`` pads (1, 1); ``"VALID"`` pads nothing; explicit
  ``[(lo, hi), (lo, hi)]`` as given.  Bias on by default, as flax's.
* :class:`BatchNorm`: flax's ``momentum`` is the weight of the old running
  value (0.9 is torch's ``momentum=0.1``), and flax folds the *biased* batch
  variance into ``running_var`` where torch folds the unbiased one.  Its
  batch statistics are f32 whatever the input dtype, as flax computes them.
  In train mode with local statistics it is :func:`..ops.batch_norm.
  batch_norm_act` (``F.batch_norm`` on the CPU, the port's fused kernels on
  the card), with the model's ReLU and residual add after it fused in.
  With ``axis_name`` set and a world larger than one, the batch statistics
  are averaged over the world (cross-replica BN), differentiably.
* :class:`Dense`, :class:`LayerNorm` (epsilon 1e-6, statistics and affine
  in f32, the output in ``dtype``).
* ``dtype`` is the computation dtype; parameters and BN statistics stay f32
  and are cast at each use, as flax's ``dtype=jnp.bfloat16`` does.
* Initialisers are flax's defaults: LeCun normal (truncated at two standard
  deviations) for kernels, zeros for biases, ones for scales.

Tensors are NCHW, in ``channels_last`` memory on the card; the models take
the JAX package's NHWC input and return what it returns.  Submodules carry
flax's names (``Conv_0``, ``BatchNorm_1``, ``head``), so a flax variable tree
maps onto a ``state_dict`` key by key (:func:`..convert.vision_state_dict_from_flax`).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch._device import resolve_device
from horovod_tpu_torch.ops.batch_norm import batch_norm_act

# flax's lecun_normal: variance_scaling(1, "fan_in", "truncated_normal"),
# whose standard deviation is corrected for the truncation at ±2σ.
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                     generator=generator)


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """flax/XLA ``"SAME"``: output ``ceil(size / stride)``, the padding split
    with the odd element at the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """``flax.linen.Conv`` on NCHW tensors; weight OIHW."""

    def __init__(self, in_features: int, features: int,
                 kernel: Sequence[int], strides: Sequence[int] = (1, 1),
                 padding="SAME", use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel, self.strides = tuple(kernel), tuple(strides)
        self.padding, self.dtype = padding, dtype
        self.weight = nn.Parameter(torch.empty(features, in_features,
                                               *self.kernel))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def init_(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)

    def _pads(self, hw) -> list[tuple[int, int]]:
        if self.padding == "SAME":
            return [same_pads(n, k, s)
                    for n, k, s in zip(hw, self.kernel, self.strides)]
        if self.padding == "VALID":
            return [(0, 0), (0, 0)]
        return [tuple(p) for p in self.padding]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (ht, hb), (wl, wr) = self._pads(x.shape[2:])
        if ht != hb or wl != wr:
            x = F.pad(x, (wl, wr, ht, hb))
            ht = wl = 0
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), b,
                        self.strides, (ht, wl))


class Dense(nn.Module):
    """``flax.linen.Dense``; weight [out, in]."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))

    def init_(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight.shape[1], generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm`` over the channel axis of NCHW tensors."""

    def __init__(self, features: int, *, momentum: float = 0.9,
                 epsilon: float = 1e-5, dtype: torch.dtype = torch.float32,
                 axis_name: str | None = None, zero_scale: bool = False):
        super().__init__()
        self.momentum, self.epsilon, self.dtype = momentum, epsilon, dtype
        self.axis_name = axis_name
        self.weight = nn.Parameter(
            torch.zeros(features) if zero_scale else torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = True, *,
                relu: bool = False,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        """``relu`` and ``residual`` are the model's own graph: the output is
        ``relu(BN(x) + residual)``, fused into the normalisation where the
        statistics are local and the mode is train."""
        cross = (self.axis_name is not None and dist.is_initialized()
                 and dist.get_world_size() > 1)
        if train and not cross:
            return batch_norm_act(
                x, self.weight, self.bias, self.running_mean,
                self.running_var, momentum=self.momentum, eps=self.epsilon,
                relu=relu, residual=residual).to(self.dtype)
        if not train:
            y = F.batch_norm(x, self.running_mean, self.running_var,
                             self.weight, self.bias, False, 0.0, self.epsilon)
        else:
            y = self._cross_replica(x)
        y = y.to(self.dtype)
        if residual is not None:
            y = y + residual
        return F.relu(y) if relu else y

    def _cross_replica(self, x: torch.Tensor) -> torch.Tensor:
        """Batch statistics averaged over the world (flax's ``pmean`` of
        E[x] and E[x²] over ``axis_name``), gradients through them."""
        from torch.distributed.nn.functional import all_reduce

        xf = x.float()
        stats = torch.stack([xf.mean((0, 2, 3)), xf.square().mean((0, 2, 3))])
        stats = all_reduce(stats) / dist.get_world_size()
        mean, var = stats[0], torch.clamp(stats[1] - stats[0].square(), min=0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_(mean.detach(), alpha=1 - m)
            self.running_var.mul_(m).add_(var.detach(), alpha=1 - m)
        shape = (1, -1, 1, 1)
        return ((xf - mean.view(shape)) * torch.rsqrt(var + self.epsilon).view(
            shape) * self.weight.view(shape) + self.bias.view(shape))


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm`` over the last axis: statistics and affine in
    f32, epsilon 1e-6, the result in ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32,
                 epsilon: float = 1e-6):
        super().__init__()
        self.dtype, self.epsilon = dtype, epsilon
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight,
                            self.bias, self.epsilon).to(self.dtype)


def add_named(parent: nn.Module, prefix: str,
              modules: Sequence[nn.Module]) -> list[nn.Module]:
    """Register ``modules`` under flax's auto names ``<prefix>_<i>``."""
    for i, m in enumerate(modules):
        parent.add_module(f"{prefix}_{i}", m)
    return list(modules)


def init_and_place(model: nn.Module, seed: int | torch.Generator,
                   device) -> nn.Module:
    """flax's default initialisers (each :class:`Conv` and :class:`Dense` in
    registration order, from one CPU generator), then the model on
    ``device`` (the card unless the caller names the CPU), in
    ``channels_last`` memory on the card."""
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (Conv, Dense)):
            m.init_(gen)
    dev = resolve_device(device)
    if dev.type == "cuda":
        return model.to(device=dev, memory_format=torch.channels_last)
    return model.to(dev)


def nhwc_input(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The JAX package's NHWC images as an NCHW view (channels_last memory:
    no copy), in ``dtype``."""
    return x.to(dtype).permute(0, 3, 1, 2)


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """Flatten NCHW features in flax's NHWC order (H, W, C), so a Dense
    kernel carried over from flax reads the same features."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
