"""VGG-16: port of ``horovod_tpu/models/vgg.py``.

The reference's fusion stress model: 138 M parameters, most of them in the
classifier, which is what Tensor Fusion exists for (BASELINE config 4).
NHWC input, ``channels_last`` inside, f32 logits.  The features are
flattened in flax's NHWC order before the first Dense, so a kernel carried
over from flax reads the same features.  Dropout draws its masks from the
module's own ``torch.Generator`` (``dropout_seed``), not the global one.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch._device import resolve_device
from horovod_tpu_torch.models.layers import (Conv, Dense, add_named,
                                             flatten_nhwc, init_and_place,
                                             nhwc_input)

# Channel plan per stage, 'M' = maxpool: the classic 16-layer configuration.
_VGG16_PLAN: Sequence = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                         512, 512, 512, "M", 512, 512, 512, "M")


class VGG16(nn.Module):
    """13 SAME 3×3 convs with ReLU and 2×2 max-pools, then Dense
    ``classifier_width`` ×2 with dropout 0.5, then the Dense head.
    ``image_size`` fixes the first Dense's input width (7·7·512 at 224)."""

    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32,
                 classifier_width: int = 4096, *, image_size: int = 224,
                 device=None, seed: int | torch.Generator = 0,
                 dropout_seed: int = 0):
        super().__init__()
        self.dtype = dtype
        convs, features, side = [], 3, image_size
        for step in _VGG16_PLAN:
            if step == "M":
                side //= 2
            else:
                convs.append(Conv(features, step, (3, 3), dtype=dtype))
                features = step
        self.convs = add_named(self, "Conv", convs)
        self.denses = add_named(self, "Dense", [
            Dense(side * side * features, classifier_width, dtype),
            Dense(classifier_width, classifier_width, dtype),
            Dense(classifier_width, num_classes, dtype)])
        init_and_place(self, seed, device)
        self.generator = torch.Generator(resolve_device(device)).manual_seed(
            dropout_seed)

    def _dropout(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if not train:
            return x
        keep = torch.empty_like(x).bernoulli_(0.5, generator=self.generator)
        return x * keep * 2.0

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = nhwc_input(x, self.dtype)
        convs = iter(self.convs)
        for step in _VGG16_PLAN:
            x = F.max_pool2d(x, 2, 2) if step == "M" else F.relu(next(convs)(x))
        x = flatten_nhwc(x)
        x = self._dropout(F.relu(self.denses[0](x)), train)
        x = self._dropout(F.relu(self.denses[1](x)), train)
        return self.denses[2](x).float()
