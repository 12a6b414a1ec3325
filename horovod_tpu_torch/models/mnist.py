"""MNIST models: port of ``horovod_tpu/models/mnist.py``.

``MnistConvNet`` (conv 32/64 5×5 SAME, 2×2 max-pools, fc 128, fc 10) and
``MnistMLP`` (Dense 512-512-10), the nets the reference's MNIST examples
train.  NHWC input ``[B, 28, 28, 1]`` as in the JAX package, f32 logits.
The conv net flattens its features in flax's NHWC order, so a Dense kernel
carried over from flax reads the same features.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.layers import (Conv, Dense, add_named,
                                             flatten_nhwc, init_and_place,
                                             nhwc_input)


class MnistConvNet(nn.Module):
    """The 2-conv + 2-fc MNIST net (``horovod_tpu/models/mnist.py:15``)."""

    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32, *, device=None,
                 seed: int | torch.Generator = 0):
        super().__init__()
        self.dtype = dtype
        self.convs = add_named(self, "Conv", [
            Conv(1, 32, (5, 5), dtype=dtype), Conv(32, 64, (5, 5), dtype=dtype)])
        self.denses = add_named(self, "Dense", [
            Dense(7 * 7 * 64, 128, dtype), Dense(128, num_classes, dtype)])
        init_and_place(self, seed, device)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = nhwc_input(x, self.dtype)
        for conv in self.convs:
            x = F.max_pool2d(F.relu(conv(x)), 2, 2)
        x = F.relu(self.denses[0](flatten_nhwc(x)))
        return self.denses[1](x).float()


class MnistMLP(nn.Module):
    """Dense-Dense-Dense (``horovod_tpu/models/mnist.py:38``)."""

    def __init__(self, num_classes: int = 10, hidden: int = 512,
                 dtype: torch.dtype = torch.float32, *, device=None,
                 seed: int | torch.Generator = 0):
        super().__init__()
        self.dtype = dtype
        self.denses = add_named(self, "Dense", [
            Dense(28 * 28, hidden, dtype), Dense(hidden, hidden, dtype),
            Dense(hidden, num_classes, dtype)])
        init_and_place(self, seed, device)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        x = F.relu(self.denses[0](x))
        x = F.relu(self.denses[1](x))
        return self.denses[2](x).float()
