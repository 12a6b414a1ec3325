"""Gradient compression: 16-bit casts, top-k sparse and int8/int4 wires.

Port of ``horovod_tpu/ops/compression.py``: ``Compressor``,
``NoneCompressor``, ``FP16Compressor``, ``BF16Compressor`` (a cast around
the collective), ``TopKCompressor`` (the fork's top-k sparse allreduce:
values and indices all-gathered, then added into a dense buffer),
``Int8Compressor`` and ``Int4Compressor`` (block-scaled codes on the wire,
one- or two-shot) and the ``Compression`` registry.  The stateful
compressors (error feedback, PowerSGD) are in :mod:`.powersgd`.

The top-k and quantized compressors change the collective itself, so their
``compress``/``decompress`` raise; :func:`.collective_ops.allreduce`
dispatches to ``quantized_allreduce`` and
:func:`..optim.distributed_optimizer.allreduce_gradients` to
``sparse_allreduce``.  Every collective here runs on the default group
(or on the group of the whole world a caller passes: the eager engine's),
one NCCL (CUDA) or gloo (CPU) call each.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F


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


def _all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order: ``[world, *x.shape]``
    (``group``: a group of the whole world, None the default one)."""
    n = dist.get_world_size(group)
    flat = x.contiguous().reshape(-1)
    out = torch.empty(n * flat.numel(), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, flat, group=group)
    return out.view((n,) + tuple(x.shape))


class TopKCompressor:
    """Top-k sparse gradients, the fork's headline feature.

    Each rank picks the k entries of largest magnitude, every rank gathers
    everyone's *signed* values and indices in rank order, and adds them
    into a zero buffer (the fork's mpi4py allgather and scatter-add,
    reference horovod/torch/__init__.py:46-83).  It changes the collective
    (an allgather, not an allreduce), so it exposes
    :meth:`sparse_allreduce` and the dense interface raises."""

    def __init__(self, ratio: float = 0.01, k: int | None = None):
        self.ratio = ratio
        self.k = k

    def _k_for(self, n: int) -> int:
        if self.k is not None:
            return max(1, min(self.k, n))
        return max(1, min(n, int(n * self.ratio)))

    def compress(self, tensor):
        raise NotImplementedError(
            "TopKCompressor changes the collective; use sparse_allreduce()."
        )

    decompress = compress

    def select(self, flat: torch.Tensor) -> torch.Tensor:
        """Indices of the k entries of largest magnitude of a 1-D tensor."""
        return torch.topk(flat.abs(), self._k_for(flat.numel())).indices

    def sparse_allreduce(self, tensor: torch.Tensor, *, average: bool = False,
                         group=None) -> torch.Tensor:
        flat = tensor.reshape(-1)
        idxs = self.select(flat)
        all_vals = _all_gather(flat[idxs], group).reshape(-1)   # [size*k]
        all_idxs = _all_gather(idxs, group).reshape(-1)         # [size*k]
        dense = torch.zeros_like(flat).index_add_(0, all_idxs, all_vals)
        if average:
            dense = dense / dist.get_world_size(group)
        return dense.reshape(tensor.shape)


class Int8Compressor(Compressor):
    """8-bit quantized all-reduce.

    Per-block max-abs scaling to int8 (1,024-element blocks, round half to
    even, clip to ±127), then the collective itself changes: every rank
    gathers the codes and scales and dequantizes and sums in f32, so no
    int8 overflow can occur.  Block scales keep a large layer from zeroing
    a small one when Tensor Fusion concatenates them into one buffer: each
    element's step is its own block's max-abs / 127.

    :func:`.collective_ops.allreduce` dispatches to
    :meth:`quantized_allreduce`; the dense interface raises."""

    BLOCK = 1024
    # 1/LEVELS of the block's max-abs is the quantization step.
    LEVELS = 127.0
    # Two-shot is the default only from this world size on (and only when
    # it moves fewer blocks than one-shot).
    TWO_SHOT_MIN_WORLD = 5

    @staticmethod
    def compress(tensor):
        raise NotImplementedError(
            "quantized compressors change the collective; pass them to "
            "allreduce() (compression=Compression.int8/int4), which "
            "dispatches automatically."
        )

    decompress = compress

    # -- wire format hooks (overridden by Int4Compressor) ------------------

    @classmethod
    def _encode(cls, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        """f32 block values [nb, B] → wire codes."""
        return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)

    @classmethod
    def _decode(cls, codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        """wire codes → f32 block values [nb, B] (already × scale)."""
        return codes.to(torch.float32) * scale

    @classmethod
    def _scale_for(cls, x: torch.Tensor) -> torch.Tensor:
        """Block scales for ``x`` [nb, B], all-zero blocks floored.  The
        divisor is a tensor on ``x``'s device: CUDA divides by a Python
        number as a product with its reciprocal, one ulp off the true
        quotient the JAX package and the CPU compute."""
        amax = x.abs().amax(dim=1, keepdim=True)
        return torch.clamp(amax / amax.new_full((), cls.LEVELS), min=1e-30)

    @classmethod
    def _block_quantize(cls, tensor: torch.Tensor, *, block_multiple: int = 1):
        """The wire's quantizer, the single definition of the format.

        Returns ``(codes [nb, ...], scale f32 [nb, 1], n)``, ``n`` the
        unpadded flat length.  ``block_multiple`` pads the block count so
        that ranks own equal shards (two-shot).  The collective and the
        error-feedback residual (:mod:`.powersgd`) both go through here."""
        flat = tensor.to(torch.float32).reshape(-1)
        n = flat.numel()
        nblocks = -(-n // cls.BLOCK)
        nblocks += (-nblocks) % block_multiple
        pad = nblocks * cls.BLOCK - n
        if pad:
            flat = F.pad(flat, (0, pad))
        x = flat.reshape(nblocks, cls.BLOCK)
        scale = cls._scale_for(x)
        return cls._encode(x, scale), scale, n

    @classmethod
    def _decode_sum(cls, codes: torch.Tensor, scales: torch.Tensor
                    ) -> torch.Tensor:
        """Σ over the leading (rank) axis of the decoded blocks, in rank
        order, in f32."""
        out = cls._decode(codes[0], scales[0])
        for i in range(1, codes.shape[0]):
            out = out + cls._decode(codes[i], scales[i])
        return out

    @classmethod
    def roundtrip(cls, tensor: torch.Tensor) -> torch.Tensor:
        """quant→dequant of ``tensor`` through the wire format: this rank's
        contribution as the collective sees it (the first quantization
        only; two-shot rounds the reduced shard once more)."""
        codes, scale, n = cls._block_quantize(tensor)
        out = cls._decode(codes, scale).reshape(-1)[:n]
        return out.reshape(tensor.shape)

    @classmethod
    def picks_two_shot(cls, size: int, numel: int) -> bool:
        """The automatic choice: two-shot from ``TWO_SHOT_MIN_WORLD`` ranks
        on, and only where it moves fewer blocks (one-shot receives
        (n−1)·nb₁ blocks, two-shot ~2·nb₂ with nb₂ padded to equal
        shards)."""
        nb1 = -(-numel // cls.BLOCK)
        nb2 = nb1 + (-nb1) % size
        return size >= cls.TWO_SHOT_MIN_WORLD and (size - 1) * nb1 > 2 * nb2

    @classmethod
    def one_shot(cls):
        """Variant pinned to the one-shot wire at every world size, for
        ``allreduce(compression=...)`` and ``DistributedOptimizer``, which
        take a compressor but no dataflow flag."""
        v = cls.__dict__.get("_one_shot_variant")
        if v is None:
            v = type(cls.__name__ + "OneShot", (cls,),
                     {"TWO_SHOT_MIN_WORLD": 1 << 62})
            cls._one_shot_variant = v
        return v

    @classmethod
    def quantized_allreduce(cls, tensor: torch.Tensor, *,
                            average: bool = False,
                            two_shot: bool | None = None,
                            group=None) -> torch.Tensor:
        """Quantized all-reduce, one of two dataflows (``two_shot=None``
        chooses by world size):

        * one-shot: all-gather the codes and scales, every rank
          dequantizes and sums in f32 (receives (n−1)·C for a payload C);
        * two-shot (n ≥ ``TWO_SHOT_MIN_WORLD`` and fewer blocks moved):
          all-to-all of the code shards, each rank sums its shard in f32,
          requantizes it and all-gathers the codes (~2C whatever n is, at
          the cost of a second rounding)."""
        orig_dtype, orig_shape = tensor.dtype, tensor.shape
        size = dist.get_world_size()
        if two_shot is None:
            two_shot = cls.picks_two_shot(size, tensor.numel())
        if not two_shot:
            codes, scale, n = cls._block_quantize(tensor)
            summed = cls._decode_sum(_all_gather(codes, group),
                                     _all_gather(scale, group))
            if average:
                summed = summed / size
            out = summed.reshape(-1)[:n]
            return out.reshape(orig_shape).to(orig_dtype)

        codes, scale, n = cls._block_quantize(tensor, block_multiple=size)
        m = codes.shape[0] // size
        # Shot 1, a quantized reduce-scatter: rank r receives every rank's
        # blocks [r·m, (r+1)·m) and sums them in f32.
        recv_codes = torch.empty_like(codes)
        recv_scale = torch.empty_like(scale)
        dist.all_to_all_single(recv_codes, codes, group=group)
        dist.all_to_all_single(recv_scale, scale, group=group)
        part = cls._decode_sum(recv_codes.reshape(size, m, -1),
                               recv_scale.reshape(size, m, 1))
        if average:
            part = part / size                      # [m, B] f32 shard sum
        # Shot 2: requantize the reduced shard, all-gather the codes.
        scale2 = cls._scale_for(part)
        codes2 = cls._encode(part, scale2)
        all_q = _all_gather(codes2, group).reshape(size * m, -1)
        all_s = _all_gather(scale2, group).reshape(size * m, 1)
        full = cls._decode(all_q, all_s).reshape(-1)[:n]
        return full.reshape(orig_shape).to(orig_dtype)


class Int4Compressor(Int8Compressor):
    """4-bit quantized all-reduce: codes in [−7, 7] (scale = block max-abs
    / 7), offset by +8 and packed two a byte as ``lo | hi << 4``; half
    int8's wire, the same dataflow.  Wrap it in
    :class:`.powersgd.ErrorFeedback` where accuracy matters."""

    LEVELS = 7.0

    @classmethod
    def _encode(cls, x, scale):
        q = (torch.clamp(torch.round(x / scale), -7, 7) + 8).to(torch.uint8)
        pairs = q.reshape(q.shape[0], -1, 2)       # [nb, B/2, 2]
        return pairs[:, :, 0] | (pairs[:, :, 1] << 4)

    @classmethod
    def _decode(cls, codes, scale):
        lo = (codes & 0xF).to(torch.int32) - 8
        hi = (codes >> 4).to(torch.int32) - 8
        q = torch.stack([lo, hi], dim=-1).reshape(codes.shape[0], -1)
        return q.to(torch.float32) * scale


class Compression:
    """Registry, Horovod's names."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    topk = TopKCompressor
    int8 = Int8Compressor
    int4 = Int4Compressor
