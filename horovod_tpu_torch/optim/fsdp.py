"""FSDP-style fully sharded data parallelism: parameters AND optimizer
state live as 1/n shards between steps.

Port of ``horovod_tpu/optim/fsdp.py``.  The memory ladder (a rank, Adam,
n ranks):

=====================  =========================================
replicated DP           params P + grads P + state 2P
ZeRO (optim/zero.py)    params P + grads P/n + state 2P/n
FSDP (this module)      params P/n + grads P/n + state 2P/n (+ the
                        gathered parameters during the step)
=====================  =========================================

The reference annotates shardings and lets GSPMD insert the gathers and
reduce-scatters.  Here the step does it with the differentiable
collectives of :mod:`..parallel._collectives`: each sharded leaf is
gathered by :func:`all_gather` at the step's start, the model runs on the
full tensors, and the backward of each gather reduce-scatters that leaf's
gradient into its shard.  The gathered copies are freed after the
backward.  (GSPMD gathers a stacked layer at its use; this gathers a whole
leaf, the granularity the model's plain tensors allow.)

    specs = fsdp_partition_specs(params)
    params = shard_params(params, specs)         # this rank's shards
    step, init = make_fsdp_train_step(loss_fn, make_optimizer)
    opt_state = init(params)                     # built over the shards
    out = step(params, opt_state, batch)         # everything stays sharded
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
import torch.distributed as dist

from horovod_tpu_torch.optim.distributed_optimizer import tree_leaves
from horovod_tpu_torch.optim.zero import clip_coefficient
from horovod_tpu_torch.parallel import _collectives as coll
from horovod_tpu_torch.utils.tree import tree_map


class FsdpStepResult(NamedTuple):
    params: Any          # sharded per fsdp_partition_specs
    opt_state: Any       # built over the shards
    loss: torch.Tensor


_OWN = object()      # no specs tree: each shard's own ``fsdp_dim``


def _with_dims(fn, params, specs):
    """``fn(leaf, dim)`` over the leaves of ``params`` (dicts, lists,
    tuples), ``dim`` from the same place of ``specs``, or, with ``specs``
    None, the leaf's own ``fsdp_dim`` (set by :func:`shard_params`)."""
    specs = _OWN if specs is None else specs
    return _walk(fn, params, specs)


def _walk(fn, params, specs):
    own = specs is _OWN
    if isinstance(params, dict):            # tree_leaves' order
        return {k: _walk(fn, params[k], specs if own else specs[k])
                for k in sorted(params)}
    if isinstance(params, (list, tuple)):
        return type(params)(_walk(fn, v, specs if own else specs[i])
                            for i, v in enumerate(params))
    if own:
        if not hasattr(params, "fsdp_dim"):
            raise ValueError(
                "an FSDP leaf has no spec: shard the parameters with "
                "shard_params, or pass specs= to make_fsdp_train_step")
        return fn(params, params.fsdp_dim)
    return fn(params, specs)


def fsdp_partition_specs(params: Any, *, min_shard_elems: int = 1024,
                         group=None) -> Any:
    """For each leaf, the dim sharded over ``group`` (None: the world): the
    LARGEST dim divisible by the group's size (the first of equal ones);
    None (replicated) for leaves of fewer than ``min_shard_elems``
    elements or with no divisible dim: gathering a bias costs more latency
    than its bytes save."""
    _, n, _ = coll._group(group)

    def spec(leaf):
        if leaf.numel() < min_shard_elems:
            return None
        dims = sorted(range(leaf.dim()), key=lambda d: leaf.shape[d],
                      reverse=True)
        return next((d for d in dims if leaf.shape[d] % n == 0), None)

    return tree_map(spec, params)


def shard_params(params: Any, specs: Any, *, group=None) -> Any:
    """This rank's shards of a full (replicated) parameter tree: the r-th
    of n chunks along each leaf's spec dim, a copy; replicated leaves are
    copied whole.  Each shard carries its spec as ``shard.fsdp_dim``, so
    the step knows how to gather it."""
    _, n, rank = coll._group(group)

    def shard(x, d):
        x = x.detach()
        out = (x if d is None else x.chunk(n, dim=d)[rank]).clone()
        out.fsdp_dim = d
        return out

    return _walk(shard, params, specs)


def make_fsdp_train_step(
    loss_fn: Callable[..., torch.Tensor],
    make_optimizer: Callable[[list], torch.optim.Optimizer],
    *,
    specs: Any = None,
    clip_global_norm: float | None = None,
    group=None,
) -> tuple[Callable[..., FsdpStepResult], Callable[[Any], Any]]:
    """Build ``(step, init)`` with everything sharded over ``group``.

    ``init(params)`` takes the shards (:func:`shard_params`) and builds the
    optimizer over them (``make_optimizer(leaves)``, in :func:`tree_leaves`
    order), so its state is the shards' size.  ``step(params, opt_state,
    batch)`` gathers every sharded leaf, runs ``loss_fn(full_params,
    batch)`` on this rank's rows, and backward; each sharded leaf's
    gradient comes back reduce-scattered, a replicated leaf's all-reduced,
    both divided by n (the reference's loss is the mean over the global
    batch), then the optimizer steps.  Returns the shards (updated in
    place), the optimizer and the loss averaged over the group.

    ``clip_global_norm``: ``optax.clip_by_global_norm`` ahead of the
    optimizer, as the reference chains it, in ``clip_grad_norm_``'s
    arithmetic (:func:`.zero.clip_coefficient`): each sharded leaf's norm
    from its shards' squared norms summed over the group, a replicated
    leaf's as it is.

    ``specs``: the :func:`fsdp_partition_specs` the shards were cut by;
    None reads each shard's ``fsdp_dim``.  Nothing is cached by shape, so
    one step function serves differently shaped models (the reference
    re-keys its compiled step by shape)."""

    def init(params) -> torch.optim.Optimizer:
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_()
        return make_optimizer(leaves)

    def step(params, opt_state, batch) -> FsdpStepResult:
        _, n, _ = coll._group(group)
        full = _with_dims(
            lambda x, d: x if d is None else coll.all_gather(x, d, group),
            params, specs)
        loss = loss_fn(full, batch)
        loss.backward()
        del full                    # the gathered copies go here
        with torch.no_grad():
            leaves = []                     # (grad, sharded), tree order
            _with_dims(lambda x, d: leaves.append((x.grad, d is not None)),
                       params, specs)
            replicated = [g for g, s in leaves if g is not None and not s]
            if replicated:
                flat = torch.cat([g.reshape(-1) for g in replicated])
                dist.all_reduce(flat, group=group)
                off = 0
                for g in replicated:
                    g.copy_(flat[off:off + g.numel()].view(g.shape))
                    off += g.numel()
            grads = [g for g, _ in leaves if g is not None]
            for g in grads:
                g.div_(n)
            if clip_global_norm is not None:
                coef = clip_coefficient([g for g, _ in leaves],
                                        [s for _, s in leaves],
                                        clip_global_norm, group)
                for g in grads:
                    g.mul_(coef.to(g.dtype))
            opt_state.step()
            opt_state.zero_grad(set_to_none=True)
            mean_loss = loss.detach().clone()
            dist.all_reduce(mean_loss, group=group)
        return FsdpStepResult(params, opt_state, mean_loss / n)

    return step, init
