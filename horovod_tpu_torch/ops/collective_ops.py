"""Eager collectives on ``torch.distributed``.

Port of ``horovod_tpu/ops/collective_ops.py``: the reduce ops (``Sum``,
``Average``, ``Min``, ``Max``, ``Product``, ``Adasum``), ``allreduce``
(``average=``/``op=``/``compression=``/``process_set=``),
``grouped_allreduce`` through Tensor Fusion, ``ProcessSet``,
``adasum_allreduce``, ``allgather`` (ragged dim 0), ``broadcast``,
``alltoall``, ``reducescatter`` and ``barrier``.  The JAX package emits
these as XLA collectives inside a compiled SPMD program; here each is one
or a few NCCL (CUDA) or gloo (CPU) calls from this process, Horovod's own
model, and every rank of the world makes the same calls in the same order.
``Average`` is a SUM divided by the number of ranks that reduced.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from horovod_tpu_torch import basics
from horovod_tpu_torch.ops import fusion
from horovod_tpu_torch.parallel import _collectives
from horovod_tpu_torch.ops.compression import (Compression, Compressor,
                                               _all_gather)


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
    if op is not Adasum and op not in _TORCH_OP:
        raise ValueError(f"unknown reduce op {op!r}")
    return op


def _is_quantized(compression) -> bool:
    return callable(getattr(compression, "quantized_allreduce", None))


class ProcessSet:
    """A static subset of ranks that collectives can run over (Horovod
    0.22's ``hvd.ProcessSet``).

    It becomes a ``torch.distributed`` group, made by :meth:`group` the
    first time a collective uses the set and cached by its rank tuple.
    Making a group is itself a collective of the whole world, so every
    rank calls each process-set collective, as under the JAX package's
    SPMD model; non-members get their input back unchanged."""

    _groups: dict[tuple, object] = {}

    def __init__(self, ranks):
        rs = sorted(int(r) for r in ranks)
        if len(rs) != len(set(rs)):
            raise ValueError(f"duplicate ranks in process set: {ranks}")
        if not rs:
            raise ValueError("a process set needs at least one rank")
        if rs[0] < 0:
            raise ValueError(f"negative rank in process set: {ranks}")
        self.ranks = tuple(rs)

    def __repr__(self) -> str:  # pragma: no cover
        return f"ProcessSet{self.ranks}"

    def size(self) -> int:
        return len(self.ranks)

    def rank_of(self, global_rank: int) -> int:
        """Set-local rank of ``global_rank``, or -1 if not a member."""
        try:
            return self.ranks.index(global_rank)
        except ValueError:
            return -1

    def included(self, global_rank: int) -> bool:
        return global_rank in self.ranks

    def group(self):
        """The set's process group (every rank of the world must call
        this, in the same order), after checking the ranks against the
        world size."""
        world = basics.size()
        if self.ranks[-1] >= world:
            raise ValueError(
                f"process set {self.ranks} exceeds world size {world}")
        key = (basics._require_init().generation, self.ranks)
        g = ProcessSet._groups.get(key)
        if g is None:
            g = ProcessSet._groups[key] = dist.new_group(list(self.ranks))
        return g

    def is_member(self) -> bool:
        return self.included(basics.rank())


def _adasum_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The Adasum combination of two flat f32 gradients:

        adasum(a, b) = (1 − a·b / 2‖a‖²)·a + (1 − a·b / 2‖b‖²)·b

    a ⊥ b gives a+b, a ∥ b their average; a zero operand returns the
    other."""
    dot = torch.dot(a, b)
    na2 = torch.dot(a, a)
    nb2 = torch.dot(b, b)
    tiny = torch.tensor(1e-30, dtype=a.dtype, device=a.device)
    ca = 1.0 - dot / torch.maximum(2.0 * na2, tiny)
    cb = 1.0 - dot / torch.maximum(2.0 * nb2, tiny)
    return ca * a + cb * b


def adasum_allreduce(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Adasum reduction over the world (Horovod ≥ 0.20); ``group`` is a
    group of the whole world (None: the default one).

    A power-of-two world runs the butterfly: log₂ n rounds, rank r
    exchanging with r ^ 2ⁱ (``batch_isend_irecv``).  Other worlds gather
    and reduce the same fixed pairwise tree on every rank (an odd last
    element carries up a level).  Dot products and norms are over this
    tensor alone, so Adasum never joins fusion buckets.

    The wire carries the tensor's own floating dtype; arithmetic is f32.
    Each side combines the wire-dtype copy of itself with its partner's,
    so both compute on identical operands and stay identical."""
    n = basics.size()
    if n == 1:
        return tensor
    orig_dtype = tensor.dtype
    wire_dtype = orig_dtype if tensor.is_floating_point() else torch.float32
    v = tensor.reshape(-1).to(torch.float32)
    if n & (n - 1) == 0:
        me = basics.rank()
        for i in range(n.bit_length() - 1):
            partner = me ^ (1 << i)
            send = v.to(wire_dtype).contiguous()
            recv = torch.empty_like(send)
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, send, partner, group),
                    dist.P2POp(dist.irecv, recv, partner, group)]):
                req.wait()
            v = _adasum_pair(send.to(torch.float32), recv.to(torch.float32))
    else:
        vs = _all_gather(v.to(wire_dtype), group)          # [n, d]
        level = [vs[i].to(torch.float32) for i in range(n)]
        while len(level) > 1:
            nxt = [_adasum_pair(level[2 * j], level[2 * j + 1])
                   for j in range(len(level) // 2)]
            if len(level) % 2:
                nxt.append(level[-1])
            level = nxt
        v = level[0]
    return v.reshape(tensor.shape).to(orig_dtype)


def _reduce_start(buf: torch.Tensor, op: _ReduceOp, compression: Compressor,
                  process_set: ProcessSet | None = None, group=None):
    """Start the all-reduce of ``buf`` (which it may overwrite), in the JAX
    package's order: process set, Min/Max/Product (the tensor as it is),
    Adasum, a wire-format compressor, the cast path.  ``group``: the group
    it runs over (None: the default group, or the process set's own).

    Returns ``(work, finish)``: the collective's ``Work`` (None where the
    route ran to its end here) and ``finish()``, which gives the result
    once ``work`` has been waited on.  With a process set, members reduce
    together and non-members get their input back, through the
    compressor's cast as the JAX package's singleton groups do."""
    if process_set is not None:
        if op is Adasum or _is_quantized(compression):
            raise ValueError(
                "process_set does not compose with Adasum or wire-format "
                "compressors; use Sum/Average/Min/Max with none/fp16/bf16")
        if op not in (Sum, Average, Min, Max):
            raise ValueError(
                f"process_set supports Sum/Average/Min/Max, not {op}")
        if group is None:
            group = process_set.group()
        wire, ctx = compression.compress(buf)
        if not process_set.is_member():
            return None, lambda: compression.decompress(wire, ctx)
        work = dist.all_reduce(wire, op=_TORCH_OP[op], group=group,
                               async_op=True)

        def finish_set():
            out = wire / process_set.size() if op is Average else wire
            return compression.decompress(out, ctx)
        return work, finish_set
    if op in (Min, Max, Product):
        return (dist.all_reduce(buf, op=_TORCH_OP[op], group=group,
                                async_op=True), lambda: buf)
    if op is Adasum:
        if _is_quantized(compression):
            raise ValueError(
                "Adasum does not support wire-format compressors (int8): "
                "the combination needs full vectors on every exchange. "
                "Use Compression.fp16/bf16 — Adasum then moves 16-bit "
                "words on the wire.")
        wire, ctx = compression.compress(buf)
        out = compression.decompress(adasum_allreduce(wire, group), ctx)
        return None, lambda: out
    if _is_quantized(compression):
        out = compression.quantized_allreduce(buf, average=op is Average,
                                              group=group)
        return None, lambda: out
    wire, ctx = compression.compress(buf)
    work = dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=group,
                           async_op=True)

    def finish():
        out = wire
        if op is Average:
            n = dist.get_world_size(group)
            out = out.div_(n) if out.is_floating_point() else out / n
        return compression.decompress(out, ctx)
    return work, finish


def _reduce_flat(buf: torch.Tensor, op: _ReduceOp, compression: Compressor,
                 process_set: ProcessSet | None = None) -> torch.Tensor:
    """All-reduce ``buf`` (which may be overwritten) over the default group
    (or the process set's) and return the result: :func:`_reduce_start`,
    waited on."""
    work, finish = _reduce_start(buf, op, compression, process_set)
    if work is not None:
        work.wait()
    return finish()


def allreduce(
    tensor: torch.Tensor,
    average: bool | None = None,
    *,
    op: _ReduceOp = Sum,
    compression: Compressor = Compression.none,
    process_set: ProcessSet | None = None,
) -> torch.Tensor:
    """All-reduce ``tensor`` over the world; returns a new tensor.

    ``average=True`` is the reference's flag, ``op=`` the forward-looking
    spelling; ``compression`` casts around the wire transfer (fp16, bf16)
    or replaces it (int8, int4); ``process_set`` restricts the reduction to
    a subset of ranks, the others getting their input back."""
    basics._require_init()
    op = _resolve_op(average, op)
    return _reduce_flat(tensor.clone(), op, compression, process_set)


def grouped_allreduce(
    tensors: Sequence[torch.Tensor],
    average: bool | None = None,
    *,
    op: _ReduceOp = Sum,
    compression: Compressor = Compression.none,
    fusion_threshold_bytes: int | None = None,
    process_set: ProcessSet | None = None,
) -> list[torch.Tensor]:
    """All-reduce many tensors as few fused transfers (Tensor Fusion):
    same-dtype neighbours are concatenated into buckets of at most
    ``fusion_threshold_bytes`` (``None``: ``HOROVOD_FUSION_THRESHOLD``,
    64 MiB by default) and each bucket goes through :func:`allreduce`'s
    dispatch (so int8 blocks follow bucket boundaries).  Adasum never
    fuses: one collective per tensor.  Returns new tensors."""
    return _grouped(tensors, average, op, compression, fusion_threshold_bytes,
                    process_set, inplace=False)


def grouped_allreduce_(
    tensors: Sequence[torch.Tensor],
    average: bool | None = None,
    *,
    op: _ReduceOp = Sum,
    compression: Compressor = Compression.none,
    fusion_threshold_bytes: int | None = None,
    process_set: ProcessSet | None = None,
) -> list[torch.Tensor]:
    """In-place :func:`grouped_allreduce` (Horovod's torch spelling): each
    bucket's result is written back into its tensors before the next bucket
    is fused, so the scratch is one bucket, not a copy of every tensor."""
    return _grouped(tensors, average, op, compression, fusion_threshold_bytes,
                    process_set, inplace=True)


def _grouped(tensors, average, op, compression, fusion_threshold_bytes,
             process_set, *, inplace):
    st = basics._require_init()
    op = _resolve_op(average, op)
    if op is Adasum:
        # Adasum's dot products are per tensor; a fused buffer would mix
        # unrelated layers into one inner product.
        fusion_threshold_bytes = 0
    elif fusion_threshold_bytes is None:
        fusion_threshold_bytes = st.config.fusion_threshold_bytes
    return fusion.fused_apply(
        list(tensors),
        lambda flat: _reduce_flat(flat, op, compression, process_set),
        threshold_bytes=fusion_threshold_bytes, inplace=inplace)


def allgather(tensor: torch.Tensor) -> torch.Tensor:
    """Every rank's ``tensor`` concatenated along dim 0, in rank order.

    Ranks may disagree on dim 0 (the reference's allgather,
    tensorflow/mpi_ops.cc:334-391) but not on the other dims or the
    dtype: dtypes and shapes are negotiated first, in one object gather,
    so a mismatch raises the same ``ValueError`` on every rank before any
    data moves."""
    basics._require_init()
    heads = [None] * basics.size()
    dist.all_gather_object(heads, (tensor.dtype, tuple(tensor.shape)))
    dt0, sh0 = heads[0]
    if not sh0 or any(dt != dt0 or len(sh) != len(sh0) for dt, sh in heads):
        raise ValueError(
            "allgather needs tensors of one dtype and rank (at least 1) on "
            f"every rank; got (dtype, shape) {heads}")
    if any(sh[1:] != sh0[1:] for _, sh in heads):
        raise ValueError("allgather: ranks disagree beyond dim 0: "
                         f"{[sh for _, sh in heads]}")
    rows = [sh[0] for _, sh in heads]
    top = max(rows)
    x = tensor.contiguous()
    if x.shape[0] < top:
        x = torch.cat([x, x.new_zeros((top - x.shape[0],) + x.shape[1:])])
    out = _all_gather(x)
    return torch.cat([out[r, :rows[r]] for r in range(len(rows))])


def broadcast(tensor: torch.Tensor, root_rank: int, *,
              process_set: ProcessSet | None = None) -> torch.Tensor:
    """Every rank receives ``root_rank``'s value of ``tensor`` (a new
    tensor; the input is left as it is).  With ``process_set`` the root
    must be a member; members receive its value, non-members keep their
    own."""
    return broadcast_(tensor.detach().clone(), root_rank,
                      process_set=process_set)


def broadcast_(tensor: torch.Tensor, root_rank: int, *,
               process_set: ProcessSet | None = None) -> torch.Tensor:
    """In-place :func:`broadcast`: ``tensor`` takes the root's value.
    bool tensors travel as int8."""
    n = basics.size()
    if not 0 <= root_rank < n:
        raise ValueError(f"root_rank {root_rank} outside [0, {n})")
    group = None
    if process_set is not None:
        if not process_set.included(root_rank):
            raise ValueError(
                f"broadcast root_rank {root_rank} is not in {process_set!r}")
        group = process_set.group()
        if not process_set.is_member():
            return tensor
    wire = tensor.view(torch.int8) if tensor.dtype == torch.bool else tensor
    dist.broadcast(wire, src=root_rank, group=group)
    return tensor


def alltoall(tensor: torch.Tensor, *, split_axis: int = 0,
             concat_axis: int = 0) -> torch.Tensor:
    """All-to-all: ``tensor`` is split along ``split_axis`` into one chunk
    per rank, chunk j goes to rank j, and the chunks received are
    concatenated along ``concat_axis`` in rank order (what
    ``lax.all_to_all(..., tiled=True)`` computes)."""
    basics._require_init()
    return _collectives._all_to_all(tensor, split_axis % tensor.dim(),
                                    concat_axis % tensor.dim(), None)


def reducescatter(tensor: torch.Tensor, *, op: _ReduceOp = Sum
                  ) -> torch.Tensor:
    """Reduce-scatter along dim 0: rank r receives rows
    [r·d/n, (r+1)·d/n) of the sum (or the average) over the world."""
    if op not in (Sum, Average):
        raise ValueError("reducescatter supports Sum / Average")
    n = basics.size()
    if tensor.dim() == 0:
        raise ValueError(f"reducescatter: a 0-d tensor does not split over "
                         f"{n} ranks")
    out = _collectives._reduce_scatter(tensor, 0, None)
    return out / n if op is Average else out


def barrier(*, process_set: ProcessSet | None = None) -> None:
    """Every rank (every member, with ``process_set``) waits for all: a
    one-element all-reduce, as the JAX package's psum (not
    ``dist.barrier``, whose NCCL form wants device ids)."""
    group = None
    if process_set is not None:
        group = process_set.group()
        if not process_set.is_member():
            return
    one = torch.ones(1, dtype=torch.int32, device=basics.device())
    dist.all_reduce(one, group=group)
    one.item()
