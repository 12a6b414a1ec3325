"""ResNet v1.5: port of ``horovod_tpu/models/resnet.py``.

``BottleneckBlock``, ``ResNet`` and ``ResNet50/101/152``, the reference's
benchmark models (``bench.py _bench_resnet`` trains ResNet-101).  NHWC
input as in the JAX package, NCHW in ``channels_last`` memory inside
(cuDNN's fast layout), ``dtype`` the computation dtype with f32 parameters
and BN statistics, f32 logits.  flax's conventions are kept
(:mod:`.layers`): ``"SAME"`` padding that pads a stride-2 3×3 conv on an
even input (0, 1), BN momentum 0.9 on the old value with the biased batch
variance, epsilon 1e-5, the max-pool padded with −∞, and the last BN of
each block starting from a zero scale.  ``bn_axis_name`` (any name, e.g.
``"hvd"``) averages the batch statistics over the world.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.layers import (BatchNorm, Conv, Dense,
                                             add_named, init_and_place,
                                             nhwc_input)


class BottleneckBlock(nn.Module):
    """1×1 → 3×3 (stride here, v1.5) → 1×1 ×4, BN after each, projection
    shortcut where the shape changes (``resnet.py:24``)."""

    def __init__(self, in_features: int, filters: int, strides: int = 1,
                 dtype: torch.dtype = torch.float32,
                 bn_axis_name: str | None = None):
        super().__init__()
        out = filters * 4

        def conv(i, o, k, s=1):
            return Conv(i, o, (k, k), (s, s), use_bias=False, dtype=dtype)

        def norm(f, zero_scale=False):
            return BatchNorm(f, momentum=0.9, epsilon=1e-5, dtype=dtype,
                             axis_name=bn_axis_name, zero_scale=zero_scale)

        self.convs = add_named(self, "Conv", [
            conv(in_features, filters, 1), conv(filters, filters, 3, strides),
            conv(filters, out, 1)])
        self.norms = add_named(self, "BatchNorm", [
            norm(filters), norm(filters), norm(out, zero_scale=True)])
        self.project = in_features != out or strides != 1
        if self.project:
            self.downsample_conv = conv(in_features, out, 1, strides)
            self.downsample_bn = norm(out)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        y = x
        for i, (conv, norm) in enumerate(zip(self.convs, self.norms)):
            y = norm(conv(y), train)
            if i < 2:
                y = F.relu(y)
        residual = x
        if self.project:
            residual = self.downsample_bn(self.downsample_conv(x), train)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """7×7/2 stem, 3×3/2 max-pool, four stages of bottleneck blocks, global
    mean, Dense head (``resnet.py:55``)."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 width: int = 64, dtype: torch.dtype = torch.float32,
                 bn_axis_name: str | None = None, *, device=None,
                 seed: int | torch.Generator = 0):
        super().__init__()
        self.dtype = dtype
        self.conv_init = Conv(3, width, (7, 7), (2, 2), [(3, 3), (3, 3)],
                              use_bias=False, dtype=dtype)
        self.bn_init = BatchNorm(width, momentum=0.9, epsilon=1e-5,
                                 dtype=dtype, axis_name=bn_axis_name)
        blocks, features = [], width
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                strides = 2 if i > 0 and j == 0 else 1
                blocks.append(BottleneckBlock(features, width * 2 ** i,
                                              strides, dtype, bn_axis_name))
                features = width * 2 ** i * 4
        self.blocks = add_named(self, "BottleneckBlock", blocks)
        self.head = Dense(features, num_classes, dtype)
        init_and_place(self, seed, device)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = F.relu(self.bn_init(self.conv_init(nhwc_input(x, self.dtype)),
                                train))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for block in self.blocks:
            x = block(x, train)
        return self.head(x.mean((2, 3))).float()


def ResNet50(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), **kw)


def ResNet101(**kw) -> ResNet:
    """The reference's published-number configuration; ``bench.py
    _bench_resnet``'s primary metric."""
    return ResNet(stage_sizes=(3, 4, 23, 3), **kw)


def ResNet152(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 8, 36, 3), **kw)
