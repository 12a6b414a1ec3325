"""Eager collectives on the default ``torch.distributed`` group.

Port of the data-parallel subset of ``horovod_tpu/ops/collective_ops.py``:
the reduce ops (``Sum``, ``Average``, ``Min``, ``Max``, ``Product``),
``allreduce`` (``average=``/``op=``/``compression=``), ``grouped_allreduce``
through Tensor Fusion and ``broadcast``.  The JAX package emits these as XLA
collectives inside a compiled SPMD program; here each is one NCCL (CUDA) or
gloo (CPU) call from this process, Horovod's own model.  ``Average`` is a
SUM divided by ``size()``.  ``Adasum``, process sets, allgather, alltoall
and reducescatter come with a later slice of the port.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from horovod_tpu_torch import basics
from horovod_tpu_torch.ops import fusion
from horovod_tpu_torch.ops.compression import Compression, Compressor


class _ReduceOp:
    def __init__(self, name: str):
        self.name = name

    def __repr__(self) -> str:  # pragma: no cover
        return f"horovod_tpu_torch.{self.name}"


Sum = _ReduceOp("Sum")
Average = _ReduceOp("Average")
Min = _ReduceOp("Min")
Max = _ReduceOp("Max")
Product = _ReduceOp("Product")
Adasum = _ReduceOp("Adasum")

_TORCH_OP = {Sum: dist.ReduceOp.SUM, Average: dist.ReduceOp.SUM,
             Min: dist.ReduceOp.MIN, Max: dist.ReduceOp.MAX,
             Product: dist.ReduceOp.PRODUCT}


def _resolve_op(average: bool | None, op: _ReduceOp) -> _ReduceOp:
    if average is not None:
        op = Average if average else Sum
    if op is Adasum:
        raise NotImplementedError(
            "Adasum comes with a later slice of the port; use Sum or Average")
    if op not in _TORCH_OP:
        raise ValueError(f"unknown reduce op {op!r}")
    return op


def _reduce_flat(buf: torch.Tensor, op: _ReduceOp,
                 compression: Compressor) -> torch.Tensor:
    """All-reduce ``buf`` (which may be overwritten) and return the result.
    Compression applies to Sum and Average, as in the reference; Min, Max
    and Product reduce the tensor as it is."""
    if op not in (Sum, Average):
        dist.all_reduce(buf, op=_TORCH_OP[op])
        return buf
    wire, ctx = compression.compress(buf)
    dist.all_reduce(wire, op=dist.ReduceOp.SUM)
    if op is Average:
        n = basics.size()
        wire = wire.div_(n) if wire.is_floating_point() else wire / n
    return compression.decompress(wire, ctx)


def allreduce(
    tensor: torch.Tensor,
    average: bool | None = None,
    *,
    op: _ReduceOp = Sum,
    compression: Compressor = Compression.none,
) -> torch.Tensor:
    """All-reduce ``tensor`` over the world; returns a new tensor.

    ``average=True`` is the reference's flag, ``op=`` the forward-looking
    spelling; ``compression`` casts around the wire transfer."""
    basics._require_init()
    op = _resolve_op(average, op)
    return _reduce_flat(tensor.clone(), op, compression)


def grouped_allreduce(
    tensors: Sequence[torch.Tensor],
    average: bool | None = None,
    *,
    op: _ReduceOp = Sum,
    compression: Compressor = Compression.none,
    fusion_threshold_bytes: int | None = None,
) -> list[torch.Tensor]:
    """All-reduce many tensors as few fused transfers (Tensor Fusion):
    same-dtype neighbours are concatenated into buckets of at most
    ``fusion_threshold_bytes`` (``None``: ``HOROVOD_FUSION_THRESHOLD``,
    64 MiB by default) and each bucket is one collective.  Returns new
    tensors."""
    return _grouped(tensors, average, op, compression, fusion_threshold_bytes,
                    inplace=False)


def grouped_allreduce_(
    tensors: Sequence[torch.Tensor],
    average: bool | None = None,
    *,
    op: _ReduceOp = Sum,
    compression: Compressor = Compression.none,
    fusion_threshold_bytes: int | None = None,
) -> list[torch.Tensor]:
    """In-place :func:`grouped_allreduce` (Horovod's torch spelling): each
    bucket's result is written back into its tensors before the next bucket
    is fused, so the scratch is one bucket, not a copy of every tensor."""
    return _grouped(tensors, average, op, compression, fusion_threshold_bytes,
                    inplace=True)


def _grouped(tensors, average, op, compression, fusion_threshold_bytes, *,
             inplace):
    st = basics._require_init()
    op = _resolve_op(average, op)
    if fusion_threshold_bytes is None:
        fusion_threshold_bytes = st.config.fusion_threshold_bytes
    return fusion.fused_apply(
        list(tensors), lambda flat: _reduce_flat(flat, op, compression),
        threshold_bytes=fusion_threshold_bytes, inplace=inplace)


def broadcast(tensor: torch.Tensor, root_rank: int) -> torch.Tensor:
    """Every rank receives ``root_rank``'s value of ``tensor`` (a new
    tensor; the input is left as it is)."""
    return broadcast_(tensor.detach().clone(), root_rank)


def broadcast_(tensor: torch.Tensor, root_rank: int) -> torch.Tensor:
    """In-place :func:`broadcast`: ``tensor`` takes the root's value."""
    n = basics.size()
    if not 0 <= root_rank < n:
        raise ValueError(f"root_rank {root_rank} outside [0, {n})")
    dist.broadcast(tensor, src=root_rank)
    return tensor
