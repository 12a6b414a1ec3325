"""Training-loop callbacks and LR schedules: port of ``horovod_tpu/callbacks.py``.

The reference's Keras callback set:

* ``BroadcastGlobalVariablesCallback``: the root's parameters and optimizer
  state to every rank at train begin;
* ``MetricAverageCallback`` / :func:`average_metrics`: epoch metrics
  averaged over the world with one allreduce;
* ``LearningRateWarmupCallback``: the gradual ``lr → lr·size`` ramp;
* ``LearningRateScheduleCallback``: an epoch-window multiplier with
  momentum correction;
* ``ModelCheckpointCallback``: rank-0 checkpoints every few epochs.

Schedules are plain functions of the step (:func:`warmup_schedule`,
:func:`multiplier_schedule`), usable with ``torch.optim.lr_scheduler.LambdaLR``.
A callback's state is :func:`..training.fit`'s ``(params, optimizer)``;
where a callback is given no ``set_lr`` / ``scale_momentum`` it sets the
optimizer's learning rate and scales SGD's momentum buffers itself.
"""

from __future__ import annotations

import math
import numbers
from typing import Any, Callable, Mapping

import torch

from horovod_tpu_torch import basics
from horovod_tpu_torch.ops import collective_ops
from horovod_tpu_torch.ops.collective_ops import Average
from horovod_tpu_torch.optim.distributed_optimizer import (
    broadcast_optimizer_state, broadcast_parameters)


def warmup_schedule(base_lr: float, *, size: int | None = None,
                    warmup_epochs: float = 5.0, steps_per_epoch: int
                    ) -> Callable[[int], float]:
    """LR at step ``step``: linear from ``base_lr`` at epoch 0 to
    ``base_lr·size`` after ``warmup_epochs``, then flat (the reference's
    ``_keras/callbacks.py:149-168``)."""
    n = size if size is not None else basics.size()

    def schedule(step):
        ramp = min(step / steps_per_epoch / warmup_epochs, 1.0)
        return base_lr * (1.0 + ramp * (n - 1))

    return schedule


def multiplier_schedule(base_lr: float,
                        multiplier: Callable[[float], float] | float, *,
                        start_epoch: float = 0.0,
                        end_epoch: float | None = None, steps_per_epoch: int,
                        staircase: bool = True) -> Callable[[int], float]:
    """LR at step ``step``: ``base_lr·multiplier(epoch)`` inside
    [start_epoch, end_epoch), ``base_lr`` outside; ``staircase`` feeds
    whole epochs (the reference's ``_keras/callbacks.py:70-146``)."""
    end = math.inf if end_epoch is None else end_epoch

    def schedule(step):
        epoch = step / steps_per_epoch
        if staircase:
            epoch = math.floor(epoch)
        if not start_epoch <= epoch < end:
            return base_lr
        m = multiplier(epoch) if callable(multiplier) else multiplier
        return base_lr * m

    return schedule


def _optimizer(state):
    if isinstance(state, tuple) and len(state) == 2:
        return state[1]
    raise TypeError("a callback without set_lr/scale_momentum needs fit's "
                    "(params, optimizer) state")


def set_optimizer_lr(state, lr: float):
    """Default ``set_lr``: every param group of the state's optimizer."""
    for group in _optimizer(state).param_groups:
        group["lr"] = lr
    return state


@torch.no_grad()
def scale_momentum_buffers(state, factor: float):
    """Default ``scale_momentum``: multiply each SGD ``momentum_buffer`` of
    the state's optimizer by ``factor``."""
    for s in _optimizer(state).state.values():
        buf = s.get("momentum_buffer")
        if buf is not None:
            buf.mul_(factor)
    return state


class Callback:
    """The callback protocol of :func:`..training.fit` (the shape of
    ``keras.callbacks.Callback`` that the reference builds on)."""

    def on_train_begin(self, state: Any) -> Any:
        return state

    def on_epoch_begin(self, epoch: int, state: Any) -> Any:
        return state

    def on_batch_begin(self, batch: int, state: Any) -> Any:
        return state

    def on_epoch_end(self, epoch: int, state: Any, metrics: dict) -> dict:
        return metrics


class BroadcastGlobalVariablesCallback(Callback):
    """The root's parameters and optimizer state to every rank at train
    begin (the reference's ``_keras/callbacks.py:20-30``)."""

    def __init__(self, root_rank: int = 0):
        self.root_rank = root_rank

    def on_train_begin(self, state):
        params, optimizer = state
        broadcast_parameters(params, self.root_rank)
        broadcast_optimizer_state(optimizer, self.root_rank)
        return state


class MetricAverageCallback(Callback):
    """Epoch metrics averaged over the world (the reference's
    ``_keras/callbacks.py:33-67``)."""

    def on_epoch_end(self, epoch, state, metrics):
        return average_metrics(metrics)


def average_metrics(metrics: Mapping[str, Any]) -> dict:
    """Each numeric metric (Python number or one-element tensor) averaged
    over the world in one allreduce, as a float; others pass through."""
    keys = [k for k, v in metrics.items()
            if isinstance(v, numbers.Real) and not isinstance(v, bool)
            or isinstance(v, torch.Tensor) and v.numel() == 1]
    out = dict(metrics)
    if keys:
        vals = torch.tensor([float(metrics[k]) for k in keys],
                            dtype=torch.float64, device=basics.device())
        vals = collective_ops.allreduce(vals, op=Average).tolist()
        out.update(zip(keys, vals))
    return out


class LearningRateWarmupCallback(Callback):
    """Epoch-driven warm-up, the mirror of :func:`warmup_schedule` (the
    reference's ``_keras/callbacks.py:149-168``); past ``warmup_epochs`` it
    leaves the LR to other callbacks."""

    def __init__(self, base_lr: float, warmup_epochs: float = 5.0,
                 size: int | None = None, set_lr=None,
                 verbose: bool = False):
        self.base_lr = base_lr
        self.warmup_epochs = warmup_epochs
        self.size = size if size is not None else basics.size()
        self.set_lr = set_lr or set_optimizer_lr
        self.verbose = verbose

    def current_lr(self, epoch: float) -> float:
        ramp = min(epoch / self.warmup_epochs, 1.0)
        return self.base_lr * (1.0 + ramp * (self.size - 1))

    def on_epoch_begin(self, epoch, state):
        if epoch > self.warmup_epochs:
            return state
        lr = self.current_lr(epoch)
        if self.verbose and basics.rank() == 0:
            print(f"Epoch {epoch}: LearningRateWarmup sets lr={lr:.6g}")
        return self.set_lr(state, lr)


class LearningRateScheduleCallback(Callback):
    """Epoch-window multiplier (the reference's ``_keras/callbacks.py:
    70-146``).  When the LR changes by a factor f, momentum correction
    scales the momentum buffers by f (``:126-138``)."""

    def __init__(self, base_lr: float, multiplier, start_epoch: float = 0.0,
                 end_epoch: float | None = None, staircase: bool = True,
                 momentum_correction: bool = True, set_lr=None,
                 scale_momentum=None):
        self.base_lr = base_lr
        self.multiplier = multiplier
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        self.momentum_correction = momentum_correction
        self.set_lr = set_lr or set_optimizer_lr
        self.scale_momentum = scale_momentum or scale_momentum_buffers
        self._last_lr: float | None = None

    def current_lr(self, epoch: float) -> float | None:
        """The LR inside the window; None outside, where the callback does
        nothing, so stacked windows do not clobber each other."""
        e = math.floor(epoch) if self.staircase else epoch
        if e < self.start_epoch or (self.end_epoch is not None
                                    and e >= self.end_epoch):
            return None
        m = self.multiplier(e) if callable(self.multiplier) else self.multiplier
        return self.base_lr * m

    def on_epoch_begin(self, epoch, state):
        lr = self.current_lr(epoch)
        if lr is None:
            return state
        state = self.set_lr(state, lr)
        if self.momentum_correction and self._last_lr not in (None, lr):
            state = self.scale_momentum(state, lr / self._last_lr)
        self._last_lr = lr
        return state


class ModelCheckpointCallback(Callback):
    """Rank-0 periodic checkpoints from inside ``fit`` (the reference's
    ``keras.callbacks.ModelCheckpoint`` slot, examples/
    keras_imagenet_resnet50.py:155-158; the rank gate lives in
    ``save_checkpoint``).

    Writes fit's state ``(params, optimizer)`` to ``<path>/step_<epoch>``
    every ``every_epochs``; ``async_save`` writes in the background.
    Resume with ``latest_checkpoint`` and ``restore_checkpoint``."""

    def __init__(self, path: str, *, every_epochs: int = 1,
                 async_save: bool = False):
        if every_epochs < 1:
            raise ValueError(f"every_epochs must be >= 1, got {every_epochs}")
        self.path = path
        self.every_epochs = every_epochs
        self.async_save = async_save

    def on_epoch_end(self, epoch, state, metrics):
        if (epoch + 1) % self.every_epochs == 0:
            from horovod_tpu_torch.checkpoint import save_checkpoint

            save_checkpoint(self.path, state, step=epoch,
                            async_save=self.async_save)
        return metrics
