"""``fit`` and ``make_eval_step``: port of ``horovod_tpu/training.py``.

The reference's Keras integration core: one call wires up the broadcast at
train begin, the per-batch data-parallel step
(:func:`..optim.distributed_optimizer.make_train_step`: backward, gradient
allreduce in fusion buckets, update), per-epoch metric averaging and the LR
callbacks.  The callback state is ``(params, optimizer)``: the optimizer
holds its own state, as torch optimizers do, and callbacks change both in
place.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from horovod_tpu_torch import basics
from horovod_tpu_torch.callbacks import Callback
from horovod_tpu_torch.ops import collective_ops
from horovod_tpu_torch.ops.collective_ops import Average
from horovod_tpu_torch.optim.distributed_optimizer import make_train_step


def make_eval_step(metric_fn: Callable[[Any, Any], dict]
                   ) -> Callable[[Any, Any], dict]:
    """``step(params, batch) -> {name: float}``: ``metric_fn``'s scalars on
    this process's batch, without gradients, averaged over the world in one
    allreduce (the per-batch form of ``MetricAverageCallback``)."""

    @torch.no_grad()
    def step(params, batch):
        metrics = metric_fn(params, batch)
        vals = torch.stack([torch.as_tensor(v, dtype=torch.float64,
                                            device=basics.device()).reshape(())
                            for v in metrics.values()])
        vals = collective_ops.allreduce(vals, op=Average).tolist()
        return dict(zip(metrics, vals))

    return step


def fit(
    params: Any,
    optimizer,
    loss_fn: Callable[[Any, Any], torch.Tensor],
    train_loader,
    *,
    epochs: int = 1,
    initial_epoch: int = 0,
    opt_state: dict | None = None,
    callbacks: Sequence[Callback] = (),
    eval_loader=None,
    eval_metric_fn: Callable[[Any, Any], dict] | None = None,
    verbose: bool = True,
) -> tuple[Any, Any, list[dict]]:
    """Train ``params`` (a module or a tree of tensors that require grad)
    with ``optimizer`` (typically a ``DistributedOptimizer``) for epochs
    ``initial_epoch .. epochs-1``; returns ``(params, optimizer, history)``,
    one dict per epoch: ``loss`` (the mean of the steps' world-averaged
    losses) and ``val_<name>`` for each metric of ``eval_metric_fn`` (mean
    over the eval batches).

    ``train_loader`` yields this process's batches (:class:`..data.
    ShardedLoader`); its ``set_epoch`` is called per epoch.  ``opt_state``:
    an optimizer ``state_dict`` to resume from.  ``initial_epoch``: the
    Keras resume parameter, so epoch-indexed callbacks see the true epoch."""
    if opt_state is not None:
        optimizer.load_state_dict(opt_state)
    step = make_train_step(loss_fn, optimizer)
    state = (params, optimizer)
    for cb in callbacks:
        state = cb.on_train_begin(state)

    history: list[dict] = []
    for epoch in range(initial_epoch, epochs):
        if hasattr(train_loader, "set_epoch"):
            train_loader.set_epoch(epoch)
        for cb in callbacks:
            state = cb.on_epoch_begin(epoch, state)
        losses = []
        for i, batch in enumerate(train_loader):
            for cb in callbacks:
                state = cb.on_batch_begin(i, state)
            losses.append(step(state[0], batch).loss)
        metrics = ({"loss": float(torch.stack(losses).float().mean())}
                   if losses else {})
        if eval_loader is not None and eval_metric_fn is not None:
            accum: dict[str, list] = {}
            for batch in eval_loader:
                for k, v in eval_metric_fn(state[0], batch).items():
                    accum.setdefault(k, []).append(float(v))
            for k, vs in accum.items():
                metrics[f"val_{k}"] = sum(vs) / len(vs)
        for cb in callbacks:
            metrics = cb.on_epoch_end(epoch, state, metrics)
        history.append({k: float(v) if hasattr(v, "item") else v
                        for k, v in metrics.items()})
        if verbose and basics.rank() == 0:
            line = "  ".join(f"{k}={v:.4f}" for k, v in history[-1].items())
            print(f"Epoch {epoch + 1}/{epochs}  {line}")
    return state[0], state[1], history
