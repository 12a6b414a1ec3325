"""Pipeline parallelism: a GPipe-style microbatch schedule over a group.

Port of ``horovod_tpu/parallel/pipeline.py``.  Stages are the ranks of a
process group (one process a stage); the schedule is ``M + S - 1`` ticks
(fill, steady state, drain), one :func:`._collectives.ppermute` hop
between neighbouring stages a tick.  The backward needs no code of its
own: the hop's backward is the reverse hop, as ``ppermute``'s transpose
under ``jax.grad``.

Where the reference runs every stage in one program under ``shard_map``,
each process here runs its own stage and passes its own stage's
parameters (row ``rank`` of :func:`stack_stage_params`, without the size-1
leading axis ``shard_map`` leaves).  Every stage builds the same autograd
graph, with the stage's choices made by ``torch.where`` on its rank as in
the reference, so that every rank reaches every hop's backward in the
same order.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.utils.checkpoint as ckpt

from horovod_tpu_torch.parallel import _collectives as coll


def pipeline_forward(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    x: torch.Tensor,
    *,
    group=None,
    remat: bool = False,
) -> torch.Tensor:
    """Run ``stage_fn`` as a pipeline over the ranks of ``group`` (None:
    the world), rank s being stage s.

    ``stage_fn(params, activations) -> activations`` keeps one shape
    across stages; ``x`` is the microbatched input ``[M, mb, ...]``, read
    on stage 0 (other stages pass the same array; it is ignored there).
    ``remat`` recomputes the stage body in the backward
    (``torch.utils.checkpoint``).  Returns ``[M, mb, ...]``, the outputs on
    the last stage and zeros elsewhere."""
    _, s, stage = coll._group(group)
    m = x.shape[0]
    perm = [(i, (i + 1) % s) for i in range(s)]
    if remat:
        def body(p, h):
            return ckpt.checkpoint(stage_fn, p, h, use_reentrant=False)
    else:
        body = stage_fn
    with torch.no_grad():
        probe = stage_fn(stage_params, x[0])
    recv = torch.zeros_like(probe)
    first = torch.tensor(stage == 0, device=x.device)
    last = stage == s - 1
    ys = [torch.zeros_like(probe) for _ in range(m)]
    for t in range(m + s - 1):
        # Stage 0 injects microbatch t; later stages take what the last
        # tick's hop delivered.
        inp = torch.where(first, x[min(t, m - 1)].to(recv.dtype), recv)
        out = body(stage_params, inp)
        slot = t - (s - 1)            # the last stage banks this slot
        if slot >= 0:
            ys[slot] = torch.where(torch.tensor(last, device=x.device),
                                   out, ys[slot])
        if t < m + s - 2:             # the last tick's hop is never read
            (recv,) = coll.ppermute((out,), perm, group)
    return torch.stack(ys)


def pipeline_loss_fn(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    loss_fn: Callable[[torch.Tensor, Any], torch.Tensor],
    *,
    group=None,
    remat: bool = False,
) -> Callable[[Any, tuple], torch.Tensor]:
    """A per-stage body and a final loss as one pipeline loss:
    ``fn(stage_params, (x_micro, target_micro)) -> scalar``.

    It runs the pipeline, takes ``loss_fn(outputs, targets)`` per
    microbatch on the last stage and returns the mean there, replicated to
    every stage by a ``psum``.  The value is the same on every stage; the
    gradient flows from the last stage's own term only (the psum's
    correction is detached), and reaches the earlier stages through the
    hops' backward: a gradient seeded on every stage and summed by the
    psum's backward would be S times too large."""

    def fn(stage_params, batch):
        x_micro, tgt_micro = batch
        ys = pipeline_forward(stage_fn, stage_params, x_micro, group=group,
                              remat=remat)
        _, s, stage = coll._group(group)
        losses = torch.stack([loss_fn(y, t) for y, t in zip(ys, tgt_micro)])
        local = losses.mean() * float(stage == s - 1)
        total = coll.psum(local.detach(), group)
        return local + (total - local).detach()

    return fn


def stack_stage_params(params_per_stage: list) -> Any:
    """Stack per-stage parameter trees (dicts, lists or tensors) along a
    new leading axis; row s is stage s's."""
    first = params_per_stage[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([p[k] for p in params_per_stage])
                for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_stage_params(list(ps))
                           for ps in zip(*params_per_stage))
    return torch.stack(params_per_stage)
