"""Gradient compression: cast to a 16-bit wire type around the collective.

Port of the dense subset of ``horovod_tpu/ops/compression.py``
(``Compressor``, ``NoneCompressor``, ``FP16Compressor``, ``BF16Compressor``
and the ``Compression`` registry with ``none``/``fp16``/``bf16``).  Top-k,
int8, int4 and PowerSGD come with a later slice of the port.
"""

from __future__ import annotations

from typing import Any

import torch


class Compressor:
    """Interface: compress before the wire transfer, decompress after."""

    @staticmethod
    def compress(tensor: torch.Tensor) -> tuple[torch.Tensor, Any]:
        raise NotImplementedError

    @staticmethod
    def decompress(tensor: torch.Tensor, ctx: Any) -> torch.Tensor:
        raise NotImplementedError


class NoneCompressor(Compressor):
    """Identity."""

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        del ctx
        return tensor


class _CastCompressor(Compressor):
    wire_dtype: Any = None

    @classmethod
    def compress(cls, tensor):
        ctx = tensor.dtype
        if tensor.is_floating_point() and tensor.dtype != cls.wire_dtype:
            return tensor.to(cls.wire_dtype), ctx
        return tensor, ctx

    @classmethod
    def decompress(cls, tensor, ctx):
        if ctx is not None and tensor.dtype != ctx:
            return tensor.to(ctx)
        return tensor


class FP16Compressor(_CastCompressor):
    """Cast down to float16 for the transfer, back after (Horovod's fp16)."""

    wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    """bfloat16 on the wire: fp32's exponent range, so no loss scaling."""

    wire_dtype = torch.bfloat16


class Compression:
    """Registry, Horovod's names."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
