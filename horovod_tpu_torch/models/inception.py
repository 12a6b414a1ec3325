"""Inception V3: port of ``horovod_tpu/models/inception.py``.

``ConvBN`` (conv → BN (epsilon 1e-3) → ReLU), ``InceptionA–E``,
``InceptionAux`` and ``InceptionV3`` (299 × 299 canonical; any side ≥ 75
works), with the JAX package's mix of ``"VALID"`` and ``"SAME"`` padding.
The 3×3 average pools of the A, C and E blocks are flax's ``avg_pool``
with ``"SAME"`` padding, which counts the padded zeros in the mean
(``count_include_pad``).  NHWC input, ``channels_last`` inside, f32 logits;
``aux_logits=True`` adds the auxiliary head in train mode, returned as a
second output.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.layers import (BatchNorm, Conv, Dense,
                                             add_named, init_and_place,
                                             nhwc_input)


class ConvBN(nn.Module):
    """conv (no bias) → BN → ReLU, the Inception building block."""

    def __init__(self, in_features: int, filters: int, kernel: Sequence[int],
                 strides: Sequence[int] = (1, 1), padding="SAME",
                 dtype: torch.dtype = torch.float32,
                 bn_axis_name: str | None = None):
        super().__init__()
        self.Conv_0 = Conv(in_features, filters, kernel, strides, padding,
                           use_bias=False, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(filters, momentum=0.9, epsilon=1e-3,
                                     dtype=dtype, axis_name=bn_axis_name)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        return F.relu(self.BatchNorm_0(self.Conv_0(x), train))


def _pool_avg(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=True)


def _pool_max(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)


class _Block(nn.Module):
    """A block of ConvBN units named ``ConvBN_<i>`` in the JAX module's call
    order; ``spec`` rows are ``(input, filters, kernel, strides, padding)``
    where ``input`` is -1 for the block's input channels."""

    def __init__(self, in_features: int, spec, dtype, bn_axis_name):
        super().__init__()
        units = []
        for i, (src, filters, kernel, strides, padding) in enumerate(spec):
            c = in_features if src < 0 else spec[src][1]
            units.append(ConvBN(c, filters, kernel, strides, padding, dtype,
                                bn_axis_name))
        self.units = add_named(self, "ConvBN", units)


_S1 = (1, 1)
_S2 = (2, 2)


class InceptionA(_Block):
    def __init__(self, in_features: int, pool_features: int,
                 dtype=torch.float32, bn_axis_name=None):
        super().__init__(in_features, [
            (-1, 64, (1, 1), _S1, "SAME"),
            (-1, 48, (1, 1), _S1, "SAME"), (1, 64, (5, 5), _S1, "SAME"),
            (-1, 64, (1, 1), _S1, "SAME"), (3, 96, (3, 3), _S1, "SAME"),
            (4, 96, (3, 3), _S1, "SAME"),
            (-1, pool_features, (1, 1), _S1, "SAME")], dtype, bn_axis_name)

    def forward(self, x, train=True):
        u = self.units
        b1 = u[0](x, train)
        b5 = u[2](u[1](x, train), train)
        b3 = u[5](u[4](u[3](x, train), train), train)
        bp = u[6](_pool_avg(x), train)
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(_Block):
    """Grid reduction 35 → 17."""

    def __init__(self, in_features: int, dtype=torch.float32,
                 bn_axis_name=None):
        super().__init__(in_features, [
            (-1, 384, (3, 3), _S2, "VALID"),
            (-1, 64, (1, 1), _S1, "SAME"), (1, 96, (3, 3), _S1, "SAME"),
            (2, 96, (3, 3), _S2, "VALID")], dtype, bn_axis_name)

    def forward(self, x, train=True):
        u = self.units
        b3 = u[0](x, train)
        bd = u[3](u[2](u[1](x, train), train), train)
        return torch.cat([b3, bd, _pool_max(x)], dim=1)


class InceptionC(_Block):
    """Factorized 7×7 (1×7 then 7×1) branches."""

    def __init__(self, in_features: int, channels_7x7: int,
                 dtype=torch.float32, bn_axis_name=None):
        c7 = channels_7x7
        super().__init__(in_features, [
            (-1, 192, (1, 1), _S1, "SAME"),
            (-1, c7, (1, 1), _S1, "SAME"), (1, c7, (1, 7), _S1, "SAME"),
            (2, 192, (7, 1), _S1, "SAME"),
            (-1, c7, (1, 1), _S1, "SAME"), (4, c7, (7, 1), _S1, "SAME"),
            (5, c7, (1, 7), _S1, "SAME"), (6, c7, (7, 1), _S1, "SAME"),
            (7, 192, (1, 7), _S1, "SAME"),
            (-1, 192, (1, 1), _S1, "SAME")], dtype, bn_axis_name)

    def forward(self, x, train=True):
        u = self.units
        b1 = u[0](x, train)
        b7 = u[3](u[2](u[1](x, train), train), train)
        bd = x
        for i in range(4, 9):
            bd = u[i](bd, train)
        bp = u[9](_pool_avg(x), train)
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(_Block):
    """Grid reduction 17 → 8."""

    def __init__(self, in_features: int, dtype=torch.float32,
                 bn_axis_name=None):
        super().__init__(in_features, [
            (-1, 192, (1, 1), _S1, "SAME"), (0, 320, (3, 3), _S2, "VALID"),
            (-1, 192, (1, 1), _S1, "SAME"), (2, 192, (1, 7), _S1, "SAME"),
            (3, 192, (7, 1), _S1, "SAME"), (4, 192, (3, 3), _S2, "VALID")],
            dtype, bn_axis_name)

    def forward(self, x, train=True):
        u = self.units
        b3 = u[1](u[0](x, train), train)
        b7 = x
        for i in range(2, 6):
            b7 = u[i](b7, train)
        return torch.cat([b3, b7, _pool_max(x)], dim=1)


class InceptionE(_Block):
    """Expanded filter banks (3×3 split into 1×3 ‖ 3×1)."""

    def __init__(self, in_features: int, dtype=torch.float32,
                 bn_axis_name=None):
        super().__init__(in_features, [
            (-1, 320, (1, 1), _S1, "SAME"),
            (-1, 384, (1, 1), _S1, "SAME"), (1, 384, (1, 3), _S1, "SAME"),
            (1, 384, (3, 1), _S1, "SAME"),
            (-1, 448, (1, 1), _S1, "SAME"), (4, 384, (3, 3), _S1, "SAME"),
            (5, 384, (1, 3), _S1, "SAME"), (5, 384, (3, 1), _S1, "SAME"),
            (-1, 192, (1, 1), _S1, "SAME")], dtype, bn_axis_name)

    def forward(self, x, train=True):
        u = self.units
        b1 = u[0](x, train)
        b3 = u[1](x, train)
        b3 = torch.cat([u[2](b3, train), u[3](b3, train)], dim=1)
        bd = u[5](u[4](x, train), train)
        bd = torch.cat([u[6](bd, train), u[7](bd, train)], dim=1)
        bp = u[8](_pool_avg(x), train)
        return torch.cat([b1, b3, bd, bp], dim=1)


class InceptionAux(_Block):
    def __init__(self, in_features: int, num_classes: int,
                 dtype=torch.float32, bn_axis_name=None):
        super().__init__(in_features, [
            (-1, 128, (1, 1), _S1, "SAME"), (0, 768, (5, 5), _S1, "VALID")],
            dtype, bn_axis_name)
        self.Dense_0 = Dense(768, num_classes, dtype)

    def forward(self, x, train=True):
        x = F.avg_pool2d(x, 5, 3)
        x = self.units[1](self.units[0](x, train), train)
        return self.Dense_0(x.mean((2, 3))).float()


class InceptionV3(nn.Module):
    """Standard Inception V3 (``inception.py:164``).  Returns logits, or
    ``(logits, aux_logits)`` when ``aux_logits`` and ``train``."""

    def __init__(self, num_classes: int = 1000, aux_logits: bool = False,
                 dtype: torch.dtype = torch.float32,
                 bn_axis_name: str | None = None, *, device=None,
                 seed: int | torch.Generator = 0):
        super().__init__()
        self.dtype, self.aux_logits = dtype, aux_logits
        kw = dict(dtype=dtype, bn_axis_name=bn_axis_name)
        self.stem = add_named(self, "ConvBN", [
            ConvBN(3, 32, (3, 3), _S2, "VALID", **kw),
            ConvBN(32, 32, (3, 3), _S1, "VALID", **kw),
            ConvBN(32, 64, (3, 3), _S1, "SAME", **kw),
            ConvBN(64, 80, (1, 1), _S1, "VALID", **kw),
            ConvBN(80, 192, (3, 3), _S1, "VALID", **kw)])
        a = add_named(self, "InceptionA", [
            InceptionA(192, 32, **kw), InceptionA(256, 64, **kw),
            InceptionA(288, 64, **kw)])
        b = add_named(self, "InceptionB", [InceptionB(288, **kw)])
        c = add_named(self, "InceptionC", [
            InceptionC(768, 128, **kw), InceptionC(768, 160, **kw),
            InceptionC(768, 160, **kw), InceptionC(768, 192, **kw)])
        if aux_logits:
            self.InceptionAux_0 = InceptionAux(768, num_classes, **kw)
        d = add_named(self, "InceptionD", [InceptionD(768, **kw)])
        e = add_named(self, "InceptionE", [InceptionE(1280, **kw),
                                           InceptionE(2048, **kw)])
        self.to_aux = a + b + c
        self.after_aux = d + e
        self.head = Dense(2048, num_classes, dtype)
        init_and_place(self, seed, device)

    def forward(self, x: torch.Tensor, train: bool = True):
        x = nhwc_input(x, self.dtype)
        s = self.stem
        x = s[2](s[1](s[0](x, train), train), train)
        x = F.max_pool2d(x, 3, 2)
        x = s[4](s[3](x, train), train)
        x = F.max_pool2d(x, 3, 2)
        for block in self.to_aux:
            x = block(x, train)
        aux = (self.InceptionAux_0(x, train)
               if self.aux_logits and train else None)
        for block in self.after_aux:
            x = block(x, train)
        logits = self.head(x.mean((2, 3))).float()
        return (logits, aux) if aux is not None else logits
