"""Elastic training over live torch objects: port of
``horovod_tpu/torch_elastic.py`` (``horovod.torch.elastic``, Horovod 0.20+).

:class:`TorchState` tracks a ``model`` and/or an ``optimizer`` IN PLACE
(restore loads state_dicts back into the live objects) plus named scalar
progress fields, and plugs into :func:`horovod_tpu_torch.elastic.run`
(reinit → restore → replay on
:class:`~horovod_tpu_torch.basics.HorovodInternalError`).

Rank 0 writes ``step_<N>.pt`` with ``torch.save`` of ``{model, optimizer,
scalars, commit_step}``, the reference's format, so that commits cross
between the JAX package's torch frontend and this package.  A resume loads
on the root and fans out through ``broadcast_parameters``,
``broadcast_optimizer_state`` and ``broadcast_object``: the other ranks'
disks never need the file.  Every snapshot is a host copy, whatever device
the model lives on.

Usage::

    import horovod_tpu_torch.torch_frontend as hvd

    state = hvd.elastic.TorchState(model=model, optimizer=optimizer,
                                   ckpt_dir="/ckpts/run1", epoch=0)

    @hvd.elastic.run
    def train(state):
        while state.epoch < epochs:
            train_one_epoch(state.model, state.optimizer)
            state.epoch += 1
            state.commit()

    train(state)
"""

from __future__ import annotations

from typing import Any

import torch

from horovod_tpu_torch import checkpoint
from horovod_tpu_torch import elastic as _elastic
from horovod_tpu_torch.basics import HorovodInternalError  # noqa: F401

__all__ = ["TorchState", "run", "HorovodInternalError"]

run = _elastic.run          # the retry loop is frontend-agnostic
BaseState = _elastic.BaseState


def _hvdt():
    # Imported at call time: torch_frontend exposes this module as its
    # ``elastic`` attribute, so a module-level import would be circular.
    import horovod_tpu_torch.torch_frontend as hvdt

    return hvdt


class TorchState(_elastic.LiveObjectState):
    """Elastic state over a live model and optimizer plus scalar progress
    fields.  The protocol (scalar guards, atomic rank-0 writes, durable
    walk, agreed outcome) is
    :class:`horovod_tpu_torch.elastic.LiveObjectState`'s; this class
    supplies the torch serializer and the two object slots."""

    _reserved = ("model", "optimizer")
    _suffix = "pt"

    def __init__(self, model: Any = None, optimizer: Any = None, *,
                 ckpt_dir: str | None = None, **scalars: Any) -> None:
        if model is None and optimizer is None and not scalars:
            raise ValueError("TorchState needs a model, an optimizer, or "
                             "at least one scalar field")
        object.__setattr__(self, "model", model)
        object.__setattr__(self, "optimizer", optimizer)
        self._init_live(ckpt_dir, scalars)

    def _rank0(self) -> bool:
        return _hvdt().rank() == 0

    def _broadcast_obj(self, obj: Any) -> Any:
        return _hvdt().broadcast_object(obj, root_rank=0)

    def _write_file(self, dst: str, snap: dict) -> None:
        _elastic.atomic_write(dst, lambda f: torch.save(snap, f))

    def _read_file(self, path: str) -> dict:
        return torch.load(path, map_location="cpu", weights_only=False)

    def _snapshot(self) -> dict:
        return {
            "model": (checkpoint._host_copy(self.model.state_dict())
                      if self.model is not None else None),
            "optimizer": (checkpoint._host_copy(self.optimizer.state_dict())
                          if self.optimizer is not None else None),
            "scalars": dict(object.__getattribute__(self, "_scalars")),
            "commit_step": self.commit_step,
        }

    def _load_local(self, snap: dict) -> None:
        if self.model is not None and snap.get("model") is not None:
            self.model.load_state_dict(snap["model"])
        if self.optimizer is not None and snap.get("optimizer") is not None:
            self.optimizer.load_state_dict(snap["optimizer"])
        self._adopt_scalars(snap["scalars"])
        object.__setattr__(self, "_commit_step",
                           int(snap.get("commit_step", self.commit_step)))

    def sync(self) -> None:
        """Fan the root's current state out to every rank (the reference
        resume recipe, pytorch_imagenet_resnet50.py:134-142)."""
        hvdt = _hvdt()
        if self.model is not None:
            hvdt.broadcast_parameters(self.model.state_dict(), root_rank=0)
        if self.optimizer is not None:
            hvdt.broadcast_optimizer_state(self.optimizer, root_rank=0)
        agreed = hvdt.broadcast_object(
            {"scalars": dict(object.__getattribute__(self, "_scalars")),
             "commit_step": self.commit_step}, root_rank=0)
        self._adopt_scalars(agreed["scalars"])
        object.__setattr__(self, "_commit_step",
                           int(agreed["commit_step"]))
