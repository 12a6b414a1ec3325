"""Elastic training for the Keras 3 frontend on the torch backend:
``hvd.elastic.KerasState``.

Port of ``horovod_tpu/keras_elastic.py`` (Horovod 0.20+'s
``KerasState``).  :class:`KerasState` tracks a live keras ``model``
(weights restored in place through ``get_weights``/``set_weights``, the
optimizer's slot variables one by one) plus named scalar progress fields,
and plugs into :func:`horovod_tpu_torch.elastic.run` (reinit → restore →
replay on :class:`~horovod_tpu_torch.basics.HorovodInternalError`).

Durability as the reference's: rank 0 writes ``step_<N>.npz`` atomically
(temporary file, fsync, rename).  An ``.npz`` is a zip, so the restore walk
keeps the torch path's torn-write rule: a file that is not a zip is a write
cut by a kill, and the walk falls back to the previous commit with a
warning; a zip whose payload does not load fails every rank (a silent
rollback would renumber later commits over the newer file).

Usage::

    import horovod_tpu_torch.keras as hvd

    model.compile(optimizer=hvd.DistributedOptimizer(opt), loss=...)
    state = hvd.elastic.KerasState(model, ckpt_dir="/ckpts/run1", epoch=0)

    @hvd.elastic.run
    def train(state):
        while state.epoch < epochs:
            model.fit(..., initial_epoch=state.epoch, epochs=state.epoch + 1)
            state.epoch += 1
            state.commit()

    train(state)
"""

from __future__ import annotations

import pickle
from typing import Any

import numpy as np

from horovod_tpu_torch import elastic as _elastic
from horovod_tpu_torch.basics import HorovodInternalError  # noqa: F401

__all__ = ["KerasState", "run", "HorovodInternalError"]

run = _elastic.run          # the retry loop is frontend-agnostic
BaseState = _elastic.BaseState


def _hvdk():
    # Imported at call time: keras/__init__.py exposes this module as its
    # ``elastic`` attribute, so a module-level import would be circular.
    import horovod_tpu_torch.keras as hvdk

    return hvdk


class KerasState(_elastic.LiveObjectState):
    """Elastic state over a live keras model plus scalar progress fields.
    The commit / restore protocol is
    :class:`horovod_tpu_torch.elastic.LiveObjectState`'s; this class
    supplies the npz serializer and the model slot."""

    _reserved = ("model",)
    _suffix = "npz"

    def __init__(self, model: Any = None, *, ckpt_dir: str | None = None,
                 **scalars: Any) -> None:
        if model is None and not scalars:
            raise ValueError(
                "KerasState needs a model or at least one scalar field")
        object.__setattr__(self, "model", model)
        self._init_live(ckpt_dir, scalars)

    def _rank0(self) -> bool:
        return _hvdk().rank() == 0

    def _broadcast_obj(self, obj: Any) -> Any:
        from horovod_tpu_torch.optim.distributed_optimizer import (
            broadcast_object)

        return broadcast_object(obj, root_rank=0)

    # -- snapshot plumbing ------------------------------------------------

    def _optimizer(self):
        m = self.model
        opt = getattr(m, "optimizer", None) if m is not None else None
        return opt if (opt is not None and getattr(opt, "built", False)) \
            else None

    def _ensure_built_optimizer(self):
        """Build a compiled but unbuilt optimizer (its slots appear at the
        first train step) before slot state is restored or broadcast: the
        relaunch flow runs ``restore()`` before any ``fit``, and skipping
        the committed slots would resume the moments from zero; a
        built-ness that differs across ranks would also misalign
        ``sync()``'s per-variable broadcasts."""
        m = self.model
        opt = getattr(m, "optimizer", None) if m is not None else None
        if opt is None:
            return None
        if not getattr(m, "built", True):
            # A deferred-build model (no Input layer, never called) has no
            # trainable variables yet: building the optimizer over them
            # would pin it to 0 slots.  Leave both unbuilt; _load_local
            # raises if a commit needs them.
            return None
        if not getattr(opt, "built", False):
            opt.build(m.trainable_variables)
        return opt

    def _snapshot(self) -> dict:
        opt = self._optimizer()
        return {
            "weights": ([np.asarray(w).copy()
                         for w in self.model.get_weights()]
                        if self.model is not None else None),
            "opt_vars": ([np.asarray(v.numpy()).copy()
                          for v in opt.variables]
                         if opt is not None else None),
            "scalars": dict(object.__getattribute__(self, "_scalars")),
            "commit_step": self.commit_step,
        }

    def _load_local(self, snap: dict) -> None:
        has_payload = (snap.get("weights") is not None
                       or snap.get("opt_vars") is not None)
        if has_payload and self.model is None:
            # restoring only the scalars of a commit that carries weights
            # would train on from fresh weights with the epoch claiming
            # otherwise
            raise ValueError(
                "commit contains model state but this KerasState has no "
                "model — pass the model to KerasState(...) before "
                "restore()")
        if self.model is not None and snap.get("weights") is not None:
            if not getattr(self.model, "built", True):
                raise ValueError(
                    "commit contains weights but the model is unbuilt — "
                    "build it (add an Input layer, call build(), or run "
                    "one batch) before restore()")
            self.model.set_weights(snap["weights"])
        opt_vars = snap.get("opt_vars")
        opt = (self._ensure_built_optimizer() if opt_vars is not None
               else self._optimizer())
        if opt_vars is not None and opt is None and self.model is not None:
            raise ValueError(
                "commit contains optimizer slot state but the model has "
                "no usable optimizer — compile() (and build) the model "
                "before restore()")
        if opt is not None and opt_vars is not None:
            if len(opt_vars) != len(opt.variables):
                raise ValueError(
                    f"optimizer state drift: commit has {len(opt_vars)} "
                    f"slot variables, live optimizer has "
                    f"{len(opt.variables)} — code/commit mismatch")
            for v, arr in zip(opt.variables, opt_vars):
                v.assign(arr)
        self._adopt_scalars(snap["scalars"])
        object.__setattr__(self, "_commit_step",
                           int(snap.get("commit_step", self.commit_step)))

    # -- commit / sync / restore -----------------------------------------

    def _write_file(self, dst: str, snap: dict) -> None:
        arrays = {}
        for i, w in enumerate(snap["weights"] or []):
            arrays[f"w_{i}"] = w
        for i, v in enumerate(snap["opt_vars"] or []):
            arrays[f"o_{i}"] = v
        arrays["meta"] = np.frombuffer(pickle.dumps({
            "n_w": len(snap["weights"] or []),
            "n_o": len(snap["opt_vars"] or []),
            "has_w": snap["weights"] is not None,
            "has_o": snap["opt_vars"] is not None,
            "scalars": snap["scalars"],
            "commit_step": snap["commit_step"],
        }), np.uint8)
        _elastic.atomic_write(dst, lambda f: np.savez(f, **arrays))

    @staticmethod
    def _read_file(path: str) -> dict:
        with np.load(path, allow_pickle=False) as z:
            meta = pickle.loads(bytes(bytearray(z["meta"])))
            return {
                "weights": ([z[f"w_{i}"] for i in range(meta["n_w"])]
                            if meta["has_w"] else None),
                "opt_vars": ([z[f"o_{i}"] for i in range(meta["n_o"])]
                             if meta["has_o"] else None),
                "scalars": meta["scalars"],
                "commit_step": meta["commit_step"],
            }

    def sync(self) -> None:
        """Fan the root's current state out to every rank."""
        from horovod_tpu_torch.keras import _model_variables

        hvdk = _hvdk()
        # build first: a built-ness that differs across ranks (root
        # restored, others fresh) would misalign the per-variable
        # broadcasts; the variable list is the broadcast callback's
        self._ensure_built_optimizer()
        variables = (_model_variables(self.model)
                     if self.model is not None else [])
        hvdk.broadcast_variables(variables, 0)
        agreed = self._broadcast_obj(
            {"scalars": dict(object.__getattribute__(self, "_scalars")),
             "commit_step": self.commit_step})
        self._adopt_scalars(agreed["scalars"])
        object.__setattr__(self, "_commit_step",
                           int(agreed["commit_step"]))

    # commit() / restore() come from LiveObjectState (one protocol copy).
