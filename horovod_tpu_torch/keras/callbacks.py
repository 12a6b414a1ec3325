"""Keras 3 callbacks with Horovod's callback surface, on the torch backend.

Port of ``horovod_tpu/keras/callbacks.py`` (the reference's
horovod/keras/callbacks.py and horovod/_keras/callbacks.py:1-168):

* ``BroadcastGlobalVariablesCallback``: rank 0's state to every rank at
  train begin;
* ``MetricAverageCallback``: epoch-end metrics averaged over the ranks;
* ``LearningRateScheduleCallback``: an epoch-window LR multiplier;
* ``LearningRateWarmupCallback``: the gradual ``lr / size → lr`` ramp.

On the torch backend the trainer runs eagerly and reads the optimizer's
variables at every step, so an LR assignment, staircase or per batch, is
seen by the next update without any state round trip.  Momentum
correction takes the reference's effect in buffer form: ``v *=
new_lr / old_lr`` just before the first update at the new LR (``v' =
m·(new/old)·v + g`` either way).

The classes subclass ``keras.callbacks.Callback`` and are made at their
first use (the module's ``__getattr__``), so importing this module never
imports keras.
"""

from __future__ import annotations

import math

import numpy as np

from horovod_tpu_torch import basics as _basics

__all__ = [
    "BroadcastGlobalVariablesCallback",
    "MetricAverageCallback",
    "LearningRateScheduleCallback",
    "LearningRateWarmupCallback",
]


def _var_value(v) -> np.ndarray:
    return np.asarray(v.numpy() if hasattr(v, "numpy") else v)


def _classes(Callback) -> dict:
    """The four callbacks over keras's ``Callback`` base."""

    class BroadcastGlobalVariablesCallback(Callback):
        """Broadcast all model (and built optimizer) variables from
        ``root_rank`` at train begin (reference _keras/callbacks.py:20-30)."""

        def __init__(self, root_rank: int = 0, device: str = ""):
            super().__init__()
            del device          # this process's device is basics.device()
            self.root_rank = root_rank
            self.broadcast_done = False

        def on_train_begin(self, logs=None):
            if self.broadcast_done:
                return
            from horovod_tpu_torch.keras import (_model_variables,
                                                 broadcast_variables)

            broadcast_variables(_model_variables(self.model), self.root_rank)
            self.broadcast_done = True

    class MetricAverageCallback(Callback):
        """Allreduce-average the numeric epoch metrics over the ranks, so
        that rank 0's logs (and checkpoint or early-stop decisions) see
        the global values (reference _keras/callbacks.py:33-67).  Every
        metric is posted first, then drained: one negotiation window, the
        keys sorted so that every rank enqueues them in one order."""

        def __init__(self, device: str = ""):
            super().__init__()
            del device

        def on_epoch_end(self, epoch, logs=None):
            if not logs:
                return
            import torch

            from horovod_tpu_torch import torch_frontend as hvd

            handles = {}
            for k in sorted(logs):
                v = logs[k]
                if isinstance(v, (int, float, np.floating, np.integer)) \
                        and not isinstance(v, bool):
                    t = torch.tensor([float(v)], dtype=torch.float64,
                                     device=_basics.device())
                    handles[k] = hvd.allreduce_async(
                        t, average=True, name=f"keras.metric.{k}")
            for k, h in handles.items():
                logs[k] = float(hvd.synchronize(h)[0])

    class LearningRateScheduleCallback(Callback):
        """``lr = initial_lr · multiplier(epoch)`` inside
        ``[start_epoch, end_epoch)`` (reference _keras/callbacks.py:70-146)."""

        def __init__(self, multiplier, start_epoch: int = 0,
                     end_epoch: int | None = None, staircase: bool = True,
                     momentum_correction: bool = True,
                     steps_per_epoch: int | None = None):
            super().__init__()
            self.start_epoch = start_epoch
            self.end_epoch = end_epoch
            self.staircase = staircase
            self.momentum_correction = momentum_correction
            self.steps_per_epoch = steps_per_epoch
            self.initial_lr: float | None = None
            self.current_epoch: int | None = None
            if not callable(multiplier):
                self.staircase = True
                self.multiplier = lambda epoch: multiplier
            else:
                self.multiplier = multiplier

        def _get_lr(self) -> float:
            return float(_var_value(self.model.optimizer.learning_rate))

        def _set_lr(self, value: float) -> None:
            # mutability is checked once, at on_train_begin
            self.model.optimizer.learning_rate.assign(value)

        def _momentum_buffers(self):
            opt = self.model.optimizer
            if not getattr(opt, "momentum", 0.0):
                return []
            bufs = getattr(opt, "momentums", None)
            if bufs:
                return list(bufs)
            return [v for v in opt.variables
                    if "momentum" in getattr(v, "path", "")]

        def _adjust_learning_rate(self, epoch: float) -> None:
            old_lr = self._get_lr()
            new_lr = self.initial_lr * float(self.multiplier(epoch))
            self._set_lr(new_lr)
            if self.momentum_correction and old_lr > 0 and new_lr != old_lr:
                scale = new_lr / old_lr
                for buf in self._momentum_buffers():
                    buf.assign(_var_value(buf) * scale)

        def _autodetect_steps_per_epoch(self) -> int:
            if self.params and self.params.get("steps"):
                return self.params["steps"]
            raise ValueError(
                "Could not autodetect steps_per_epoch; pass steps_per_epoch= "
                f"to {self.__class__.__name__}().")

        def on_train_begin(self, logs=None):
            if not hasattr(self.model.optimizer.learning_rate, "assign"):
                # fail at train begin, not mid-epoch: an optimizer built on
                # a LearningRateSchedule object owns the LR itself
                raise ValueError(
                    f"{self.__class__.__name__} requires a mutable "
                    "learning_rate variable; the optimizer was constructed "
                    "with a schedule object instead.")
            self.initial_lr = self._get_lr()
            if not self.staircase and not self.steps_per_epoch:
                self.steps_per_epoch = self._autodetect_steps_per_epoch()

        def on_epoch_begin(self, epoch, logs=None):
            self.current_epoch = epoch

        def on_train_batch_begin(self, batch, logs=None):
            if (self.current_epoch is None
                    or self.current_epoch < self.start_epoch
                    or (self.end_epoch is not None
                        and self.current_epoch >= self.end_epoch)):
                return
            if self.staircase and batch == 0:
                self._adjust_learning_rate(self.current_epoch)
            elif not self.staircase:
                self._adjust_learning_rate(
                    self.current_epoch + float(batch) / self.steps_per_epoch)

        def on_epoch_end(self, epoch, logs=None):
            if logs is not None:
                logs["lr"] = self._get_lr()

    class LearningRateWarmupCallback(LearningRateScheduleCallback):
        """Gradual ramp from ``initial_lr / size`` to ``initial_lr`` over
        ``warmup_epochs`` (reference _keras/callbacks.py:149-168; Goyal et
        al.: the user scales the configured LR by ``size``, the callback
        walks up to it from the one-worker value)."""

        def __init__(self, warmup_epochs: float = 5,
                     momentum_correction: bool = True,
                     steps_per_epoch: int | None = None, verbose: int = 0):
            def multiplier(epoch):
                # +1/steps so epoch-end values land on round numbers
                epoch += 1.0 / self.steps_per_epoch
                n = _basics.size()
                return 1.0 / n * (epoch * (n - 1) / warmup_epochs + 1)

            super().__init__(multiplier, start_epoch=0,
                             end_epoch=warmup_epochs, staircase=False,
                             momentum_correction=momentum_correction,
                             steps_per_epoch=steps_per_epoch)
            self.verbose = verbose

        def on_epoch_end(self, epoch, logs=None):
            super().on_epoch_end(epoch, logs)
            # ceil - 1: warmup_epochs may be fractional (2.5): the ramp
            # ends during epoch ceil(end) - 1
            if epoch == math.ceil(self.end_epoch) - 1 and self.verbose > 0 \
                    and _basics.rank() == 0:
                print(f"\nEpoch {epoch + 1}: finished gradual learning rate "
                      f"warmup to {self._get_lr():g}.")

    return {c.__name__: c for c in (
        BroadcastGlobalVariablesCallback, MetricAverageCallback,
        LearningRateScheduleCallback, LearningRateWarmupCallback)}


_CLASSES: dict | None = None


def __getattr__(name: str):
    global _CLASSES
    if name not in __all__:
        raise AttributeError(name)
    if _CLASSES is None:
        from horovod_tpu_torch.keras import _keras

        _CLASSES = _classes(_keras().callbacks.Callback)
    return _CLASSES[name]
