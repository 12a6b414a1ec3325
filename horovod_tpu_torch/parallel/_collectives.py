"""Differentiable collectives over a process group: the port's ``lax``
collectives with their ``jax.grad`` transposes.

The JAX package differentiates ``lax.ppermute``, ``lax.all_to_all``,
``lax.all_gather``, ``lax.psum_scatter``, ``lax.psum`` and ``lax.pmean``
inside ``shard_map``; each is here a ``torch.autograd.Function`` whose
backward is the same transpose (as ``shard_map`` with ``check_vma=False``
computes it):

==================  ========================================
forward             backward
==================  ========================================
:func:`ppermute`    the inverse permutation
:func:`all_to_all`  the all-to-all with the two axes swapped
:func:`all_gather`  a reduce-scatter (sum)
:func:`reduce_scatter`  an all-gather
:func:`psum`        a psum
:func:`pmean`       a pmean
==================  ========================================

``group`` is a ``torch.distributed`` process group (``None``: the world);
ranks in a permutation are the group's own.  Every rank of the group must
reach every collective, forward and backward, in the same order: the
autograd engine visits a graph in an order fixed by its structure, so the
ranks must build the same graph.  :func:`ppermute` takes a tuple of
tensors so that tensors that travel together (ring attention's K and V)
are one node of that graph.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _group(group):
    """``(group, size, rank)``; ``None`` is the world."""
    return group, dist.get_world_size(group), dist.get_rank(group)


def _peer(group, r: int) -> int:
    """The world rank of the group's rank ``r`` (P2P ops take world ranks)."""
    if group is None or group is dist.group.WORLD:
        return r
    return dist.get_global_rank(group, r)


def _check_perm(perm, n: int) -> tuple:
    perm = tuple((int(s), int(d)) for s, d in perm)
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    if (len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts)
            or any(not 0 <= r < n for r in srcs + dsts)):
        raise ValueError(f"ppermute: {perm} is not a partial permutation "
                         f"of the ranks [0, {n})")
    return perm


def _ppermute(xs, perm, group):
    """Rank ``s`` sends each of ``xs`` to ``d`` for every ``(s, d)`` in
    ``perm``; a rank that receives nothing gets zeros (``lax.ppermute``).
    A hop to itself is a copy, never a send."""
    group, n, rank = _group(group)
    dst = [d for s, d in perm if s == rank]
    src = [s for s, d in perm if d == rank]
    outs, ops = [], []
    for x in xs:
        if dst == [rank]:
            outs.append(x.clone())
            continue
        out = torch.zeros_like(x) if not src else torch.empty_like(
            x, memory_format=torch.contiguous_format)
        if dst:
            ops.append(dist.P2POp(dist.isend, x.contiguous(),
                                  _peer(group, dst[0]), group))
        if src:
            ops.append(dist.P2POp(dist.irecv, out, _peer(group, src[0]),
                                  group))
        outs.append(out)
    if ops:
        # One batch: a cyclic ring cannot deadlock on gloo or NCCL.
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return tuple(outs)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, perm, group, *xs):
        ctx.perm, ctx.group = perm, group
        return _ppermute(xs, perm, group)

    @staticmethod
    def backward(ctx, *gs):
        inverse = tuple((d, s) for s, d in ctx.perm)
        return (None, None, *_ppermute(gs, inverse, ctx.group))


def ppermute(tensors, perm, group=None) -> tuple:
    """``lax.ppermute`` of a tuple of tensors as one autograd node:
    rank ``s`` sends to ``d`` for each ``(s, d)`` of ``perm``.  Returns a
    tuple (zeros on a rank nothing is sent to)."""
    _, n, _ = _group(group)
    tensors = tuple(tensors)
    return _PPermute.apply(_check_perm(perm, n), group, *tensors)


def _all_to_all(x, split_axis: int, concat_axis: int, group):
    group, n, _ = _group(group)
    if x.shape[split_axis] % n:
        raise ValueError(
            f"all_to_all: dim {split_axis} of {tuple(x.shape)} does not "
            f"split over {n} ranks")
    xs = x.movedim(split_axis, 0).contiguous()
    out = torch.empty_like(xs)
    dist.all_to_all_single(out, xs, group=group)
    return torch.cat([c.movedim(0, split_axis) for c in out.chunk(n)],
                     dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_axis, concat_axis, group):
        ctx.axes, ctx.group = (split_axis, concat_axis), group
        return _all_to_all(x, split_axis, concat_axis, group)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return (_all_to_all(g, concat_axis, split_axis, ctx.group), None,
                None, None)


def all_to_all(x: torch.Tensor, split_axis: int, concat_axis: int,
               group=None) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis, concat_axis, tiled=True)``: ``x`` is
    cut into one chunk per rank along ``split_axis``, chunk j goes to rank
    j, and the chunks received are concatenated along ``concat_axis`` in
    rank order."""
    return _AllToAll.apply(x, split_axis % x.dim(), concat_axis % x.dim(),
                           group)


def _all_gather(x, dim: int, group):
    group, n, _ = _group(group)
    xs = x.movedim(dim, 0).contiguous()
    out = torch.empty(n * xs.numel(), dtype=x.dtype, device=x.device)
    # gloo takes only a flat output; NCCL either.
    dist.all_gather_into_tensor(out, xs.reshape(-1), group=group)
    return out.view((n * xs.shape[0],) + xs.shape[1:]).movedim(0, dim)


def _reduce_scatter(x, dim: int, group):
    group, n, _ = _group(group)
    if x.shape[dim] % n:
        raise ValueError(
            f"reduce_scatter: dim {dim} of {tuple(x.shape)} does not split "
            f"over {n} ranks")
    xs = x.movedim(dim, 0).contiguous()
    out = torch.empty(xs.numel() // n, dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, xs.reshape(-1), group=group)
    return out.view((xs.shape[0] // n,) + xs.shape[1:]).movedim(0, dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


def all_gather(x: torch.Tensor, dim: int = 0, group=None) -> torch.Tensor:
    """``lax.all_gather(x, tiled=True, axis=dim)``: every rank's ``x``
    concatenated along ``dim`` in rank order; the backward reduce-scatters
    (sums) the gradient."""
    return _AllGather.apply(x, dim % x.dim(), group)


def reduce_scatter(x: torch.Tensor, dim: int = 0, group=None
                   ) -> torch.Tensor:
    """``lax.psum_scatter(x, scatter_dimension=dim, tiled=True)``: the sum
    over the ranks, rank r keeping the r-th of n chunks along ``dim``; the
    backward all-gathers the gradient."""
    return _ReduceScatter.apply(x, dim % x.dim(), group)


def _all_reduce(x, group, mean: bool):
    _, n, _ = _group(group)
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out / n if mean else out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, mean):
        ctx.group, ctx.mean = group, mean
        return _all_reduce(x, group, mean)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group, ctx.mean), None, None


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.psum``: the sum over the ranks; the backward is a psum."""
    return _AllReduce.apply(x, group, False)


def pmean(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.pmean``: the mean over the ranks; the backward is a pmean."""
    return _AllReduce.apply(x, group, True)
