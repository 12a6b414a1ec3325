"""ZeRO-style sharded optimizer: reduce-scatter → shard update → all-gather.

Port of ``horovod_tpu/optim/zero.py``.  Each step, on every rank:

1. the local backward, its gradients landing in one flat buffer;
2. the flat gradient, divided by n, is reduce-scattered: each rank keeps
   the reduced ``[per]`` shard it owns (``per = ceil(P/n)``, the flat
   vector padded with zeros to ``per·n``);
3. with ``clip_global_norm``, the global norm from one all-reduce of the
   shards' squared norms (:func:`clip_coefficient`: the reference's
   optax clip, in ``clip_grad_norm_``'s arithmetic);
4. the optimizer updates the rank's ``[per]`` shard of the parameters, so
   its state (Adam's moments) is ``[per]`` a rank; scalar state (the step
   count) stays replicated;
5. the shards are all-gathered back into the full parameters.

The reference builds the step from an optax transform; a torch optimizer
is built over the tensors it updates, so this takes ``make_optimizer``,
which builds it over the rank's shard (``make_optimizer([shard])``).  The
transform must be elementwise (Adam, AdamW, SGD, RMSprop), as there.

The parameters and their gradients live as views of one flat buffer each,
as Horovod's fusion buffer: the reduce-scatter reads the gradient buffer
and writes the rank's shard in place, the optimizer updates the parameter
buffer's shard in place, and the all-gather fills the rest of that buffer:
no flatten copy a step.  Leaves whose dtype is not the flat vector's
(``ravel_pytree``'s promotion of all the leaves' dtypes) are copied in and
out instead.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch
import torch.distributed as dist

from horovod_tpu_torch.optim.distributed_optimizer import tree_leaves
from horovod_tpu_torch.parallel import _collectives as coll


class ZeroStepResult(NamedTuple):
    params: Any
    opt_state: Any
    loss: torch.Tensor


def clip_coefficient(grads: list, sharded: list, max_norm: float,
                     group=None) -> torch.Tensor:
    """``torch.nn.utils.clip_grad_norm_``'s coefficient, ``min(1, max_norm /
    (‖g‖ + 1e-6))``, for a gradient spread over ``group``.

    ``grads``: each leaf's gradient held here, in the parameter tree's
    order (None: none of it here); ``sharded[i]``: whether leaf i's
    gradient is split over the group (its norm is then the all-reduced
    norm of the pieces) or whole on every rank.  ‖g‖ is the norm of the
    leaves' norms, as ``clip_grad_norm_`` takes it, so at a world of one
    the coefficient is the replicated route's bit for bit (the reference's
    optax clip has no 1e-6: a 1e-6/‖g‖ relative difference)."""
    dev = next(g.device for g in grads if g is not None)
    dtype = next(g.dtype for g in grads if g is not None)
    zero = torch.zeros((), dtype=dtype, device=dev)
    norms = [zero if g is None or g.numel() == 0
             else torch.nn.utils.get_total_norm([g]) for g in grads]
    split = [i for i, s in enumerate(sharded) if s]
    if split:
        sq = torch.stack([norms[i] for i in split]).square()
        dist.all_reduce(sq, group=group)
        for i, v in zip(split, sq.sqrt().unbind()):
            norms[i] = v                   # √(x²) is x exactly at n = 1
    total = torch.linalg.vector_norm(torch.stack(norms), 2.0)
    return torch.clamp(max_norm / (total + 1e-6), max=1.0)


@dataclasses.dataclass
class ZeroState:
    """The sharded optimizer state: ``optimizer`` over ``shard``, the
    rank's ``[per]`` slice of the flat parameter buffer ``flat``
    (``[per·n]``, the leaves' storage); ``grad``, the flat gradient
    buffer, and ``views``/``grad_views``, each leaf's segment of both."""

    optimizer: torch.optim.Optimizer
    flat: torch.Tensor
    grad: torch.Tensor
    shard: torch.Tensor
    grad_shard: torch.Tensor
    leaves: list                # the parameter tensors, tree_leaves order
    views: list
    grad_views: list


def _flatten(params, n: int, rank: int, make_optimizer) -> ZeroState:
    leaves = tree_leaves(params)
    dtype = leaves[0].dtype
    for t in leaves[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    total = sum(t.numel() for t in leaves)
    per = -(-total // n)                # the padded shard length
    flat = torch.zeros(per * n, dtype=dtype, device=leaves[0].device)
    grad = torch.zeros_like(flat)
    views, grad_views, off = [], [], 0
    with torch.no_grad():
        for t in leaves:
            seg = flat[off:off + t.numel()]
            seg.copy_(t.reshape(-1))
            if t.dtype == dtype:
                t.data = seg.view(t.shape)      # the leaf lives in ``flat``
            t.requires_grad_()
            views.append(seg)
            grad_views.append(grad[off:off + t.numel()])
            off += t.numel()
    shard = flat[rank * per:(rank + 1) * per]
    return ZeroState(make_optimizer([shard]), flat, grad, shard,
                     grad[rank * per:(rank + 1) * per], leaves, views,
                     grad_views)


def make_zero_train_step(
    loss_fn: Callable[..., torch.Tensor],
    make_optimizer: Callable[[list], torch.optim.Optimizer],
    *,
    clip_global_norm: float | None = None,
    group=None,
) -> tuple[Callable[..., ZeroStepResult], Callable[[Any], ZeroState]]:
    """Build a ZeRO train step over ``group`` (None: the world); returns
    ``(step, init_opt_state)``.

    ``init_opt_state(params)`` lays the parameter tree (nested dicts of
    tensors, as :func:`tree_leaves` reads them) out in the flat buffer, in
    place: afterwards its leaves are views of ``ZeroState.flat``.  It
    returns the :class:`ZeroState`, whose optimizer holds only this rank's
    ``[ceil(P/n)]`` shard.  ``step(params, opt_state, batch)`` runs
    ``loss_fn(params, batch)`` on this rank's batch and returns the
    updated params (in place), the state and the loss averaged over the
    group."""

    def init_opt_state(params) -> ZeroState:
        _, n, rank = coll._group(group)
        return _flatten(params, n, rank, make_optimizer)

    def step(params, opt_state: ZeroState, batch) -> ZeroStepResult:
        _, n, rank = coll._group(group)
        st = opt_state
        if [id(t) for t in tree_leaves(params)] != [id(t) for t in st.leaves]:
            raise ValueError("params are not the tree init_opt_state laid "
                             "out; call init_opt_state(params) first")
        own = [t.dtype == st.flat.dtype for t in st.leaves]
        st.grad.zero_()
        for t, g, view in zip(st.leaves, st.grad_views, own):
            # Gradients accumulate in place into the flat buffer.
            t.grad = g.view(t.shape) if view else None
        loss = loss_fn(params, batch)
        loss.backward()
        with torch.no_grad():
            for t, g, view in zip(st.leaves, st.grad_views, own):
                if not view and t.grad is not None:
                    g.copy_(t.grad.reshape(-1))
                    t.grad = None
            st.grad.div_(n)
            dist.reduce_scatter_tensor(st.grad_shard, st.grad, group=group)
            if clip_global_norm is not None:
                # Each leaf's piece of this rank's shard; the shards are
                # disjoint, so a leaf's ‖g‖² sums over the ranks.
                per = st.grad_shard.numel()
                pieces = []
                for g in st.grad_views:
                    off = g.storage_offset() - st.grad.storage_offset()
                    a, b = max(off, rank * per), min(off + g.numel(),
                                                     (rank + 1) * per)
                    pieces.append(st.grad[a:max(a, b)])  # may be empty
                coef = clip_coefficient(pieces, [True] * len(pieces),
                                        clip_global_norm, group)
                st.grad_shard.mul_(coef.to(st.grad_shard.dtype))
            st.shard.grad = st.grad_shard
            st.optimizer.step()
            st.shard.grad = None
            dist.all_gather_into_tensor(st.flat, st.shard, group=group)
            for t, seg, view in zip(st.leaves, st.views, own):
                if not view:
                    t.copy_(seg.view(t.shape))
            mean_loss = loss.detach().clone()
            dist.all_reduce(mean_loss, group=group)
        return ZeroStepResult(params, opt_state, mean_loss / n)

    return step, init_opt_state
