"""``import horovod_tpu_torch.keras as hvd``: Horovod's Keras frontend on
Keras 3's **torch** backend.

Port of ``horovod_tpu/keras/__init__.py`` (the reference's
horovod/keras/__init__.py:1-148 and horovod/_keras/__init__.py), with its
surface: ``init``/``shutdown``/``size``/``local_size``/``rank``/
``local_rank``, ``DistributedOptimizer``, ``broadcast_global_variables``,
value-level ``allreduce``/``allgather``/``broadcast``, ``load_model``
(the optimizer re-wrapped at deserialization, its slot state kept), the
four callbacks in :mod:`horovod_tpu_torch.keras.callbacks` and
``elastic`` (:mod:`horovod_tpu_torch.keras_elastic`).

The port runs one process per GPU, the reference's process model:
gradients are averaged through Horovod's eager engine
(:mod:`horovod_tpu_torch.ops.eager`, the route of
:mod:`horovod_tpu_torch.torch_frontend`) inside ``apply``, where the
reference splices its allreduce into ``get_gradients``.  Keras's torch
trainer runs eagerly, so the gradients ``apply`` sees are this process's
torch tensors and go to the engine as they are.  The JAX package's
second regime, one controller driving the mesh through
``keras.distribution.DataParallel``, exists in Keras only for the JAX
backend and has no counterpart here.

Keras is imported lazily, at the first call that needs it, so importing
this package never imports keras; a keras without the torch backend
(``KERAS_BACKEND=torch``, set before keras is first imported) raises
``ImportError``.  Keras must run on this process's device
(``basics.device()``): the torch backend picks the card when there is
one.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from horovod_tpu_torch import basics as _basics
from horovod_tpu_torch import torch_frontend as _hvd
from horovod_tpu_torch.ops import eager as _eager
from horovod_tpu_torch.ops.collective_ops import Average, Sum
from horovod_tpu_torch.ops.compression import Compression  # noqa: F401

init = _basics.init
shutdown = _basics.shutdown
size = _basics.size
local_size = _basics.local_size
rank = _basics.rank
local_rank = _basics.local_rank
is_initialized = _basics.is_initialized


def _keras():
    """Keras 3 on the torch backend, or ``ImportError``."""
    try:
        import keras
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.keras requires keras>=3 on the torch backend: "
            "install keras and set KERAS_BACKEND=torch before importing it"
        ) from e
    major = int(str(getattr(keras, "__version__", "0")).split(".")[0] or 0)
    if major < 3:
        raise ImportError(
            f"horovod_tpu_torch.keras requires keras>=3, found "
            f"{keras.__version__}")
    if keras.backend.backend() != "torch":
        raise ImportError(
            f"horovod_tpu_torch.keras requires Keras's torch backend (got "
            f"{keras.backend.backend()!r}): set KERAS_BACKEND=torch before "
            f"keras is first imported")
    return keras


def _check_device() -> None:
    """Keras's torch device must be this process's (``basics.device()``):
    the engine reduces tensors where they lie."""
    from keras.src.backend.torch.core import get_device

    kdev = torch.device(get_device())
    dev = _basics.device()
    if kdev.type == "cuda" and kdev.index is None:
        kdev = torch.device("cuda", torch.cuda.current_device())
    if kdev != dev:
        raise RuntimeError(
            f"keras computes on {kdev}, this process's device is {dev}: "
            f"run one process per GPU with keras on its card")


# ---------------------------------------------------------------------------
# Value-level collectives (reference horovod/keras/__init__.py:73-115): one
# value per process, through the eager engine.
# ---------------------------------------------------------------------------


def _to_tensor(value) -> tuple[torch.Tensor, np.ndarray]:
    arr = np.asarray(value.numpy() if hasattr(value, "numpy") else value)
    return torch.as_tensor(np.ascontiguousarray(arr),
                           device=_basics.device()), arr


def _back(out: torch.Tensor, arr: np.ndarray, scalar: bool):
    res = out.detach().cpu().numpy().astype(arr.dtype, copy=False)
    return res.item() if scalar else res


def allreduce(value, name: str | None = None, average: bool = True):
    """Allreduce a tensor-compatible value over the ranks (average by
    default); returns a numpy value of the input's dtype."""
    _basics._require_init()
    t, arr = _to_tensor(value)
    out = _hvd.allreduce(t.reshape(-1) if t.dim() == 0 else t, average,
                         name or "keras.allreduce")
    return _back(out.reshape(arr.shape), arr, np.ndim(value) == 0)


def allgather(value, name: str | None = None):
    """Allgather along dim 0; ranks may disagree on dim 0 (the sizes are
    negotiated through the engine)."""
    _basics._require_init()
    t, arr = _to_tensor(value)
    return _back(_hvd.allgather(t, name or "keras.allgather"), arr, False)


def broadcast(value, root_rank: int, name: str | None = None):
    """Broadcast a tensor-compatible value from ``root_rank``."""
    _basics._require_init()
    t, arr = _to_tensor(value)
    out = _hvd.broadcast(t.reshape(-1) if t.dim() == 0 else t, root_rank,
                         name or "keras.broadcast")
    return _back(out.reshape(arr.shape), arr, np.ndim(value) == 0)


def _model_variables(model) -> list:
    vs = list(model.variables)
    opt = getattr(model, "optimizer", None)
    if opt is not None and getattr(opt, "built", False):
        known = {id(v) for v in vs}
        vs += [v for v in opt.variables if id(v) not in known]
    return vs


def broadcast_variables(variables: Sequence[Any], root_rank: int = 0) -> None:
    """Assign every variable its ``root_rank`` value: all broadcasts are
    posted, then drained (Keras 3 keeps no global-variable registry, so
    the caller names the variables; see
    :func:`broadcast_global_variables`)."""
    _basics._require_init()
    handles = []
    for i, v in enumerate(variables):
        t = v.value if hasattr(v, "value") else torch.as_tensor(v)
        flat = t.detach().reshape(-1).contiguous()
        handles.append((v, t.shape, _hvd.broadcast_async(
            flat, root_rank, name=f"keras.bcast.{i}")))
    for v, shape, h in handles:
        v.assign(_hvd.synchronize(h).reshape(shape))


def broadcast_global_variables(root_rank: int, model=None) -> None:
    """Broadcast all of ``model``'s (and its built optimizer's) variables
    from ``root_rank`` (reference horovod/keras/__init__.py:62-70).  Keras
    3 keeps no global-variable collection, so the model must be passed (or
    use ``callbacks.BroadcastGlobalVariablesCallback``, which takes it from
    ``fit``)."""
    if model is None:
        _basics._require_init()
        if _basics.size() == 1:
            return      # nothing to sync and no registry to walk
        raise ValueError(
            "keras 3 has no global-variable registry; pass the model: "
            "broadcast_global_variables(root_rank, model=model), or use "
            "callbacks.BroadcastGlobalVariablesCallback.")
    broadcast_variables(_model_variables(model), root_rank)


# ---------------------------------------------------------------------------
# DistributedOptimizer (reference horovod/keras/__init__.py:32-59).
# ---------------------------------------------------------------------------


def _allreduce_gradients(grads: list, *, prefix: str, compression,
                         average: bool) -> list:
    """One fusion group a gradient burst (the grouped call fuses; the
    reference's tensor fusion), the rest of ``grads`` (None) kept."""
    _basics._require_init()
    idx = [i for i, g in enumerate(grads) if g is not None]
    if not idx:
        return grads
    tensors = [torch.as_tensor(grads[i]) for i in idx]
    reduced = _eager.grouped_allreduce_eager(
        [t.detach() for t in tensors],
        names=[f"{prefix}.grad_{i}" for i in idx],
        op=Average if average else Sum,
        compression=compression)
    out = list(grads)
    for j, i in enumerate(idx):
        out[i] = reduced[j]
    return out


_DIST_CLS_CACHE: dict[type, type] = {}


def _dist_class(cls: type) -> type:
    """One ``Distributed<Cls>`` subclass per wrapped optimizer class,
    registered with keras's serialization (registered name
    ``horovod_tpu_torch.keras>Distributed<Cls>``) so models saved with a
    wrapped optimizer load."""
    dc = _DIST_CLS_CACHE.get(cls)
    if dc is None:
        keras = _keras()
        dc = type("Distributed" + cls.__name__,
                  (_DistributedApplyMixin, cls), {})
        keras.saving.register_keras_serializable(
            package="horovod_tpu_torch.keras")(dc)
        _DIST_CLS_CACHE[cls] = dc
    return dc


class _DistributedApplyMixin:
    """Overrides ``apply``, the funnel both ``apply_gradients`` and the
    torch trainer's step drain through in Keras 3, to average the
    gradients over the ranks first."""

    _hvd_compression = Compression.none
    _hvd_average = True
    _hvd_prefix = "DistributedOptimizer"

    def apply(self, grads, trainable_variables=None):
        grads = _allreduce_gradients(
            list(grads), prefix=self._hvd_prefix,
            compression=self._hvd_compression, average=self._hvd_average)
        return super().apply(grads, trainable_variables)

    def get_config(self):
        # average/name survive a save → load_model round trip (sum becoming
        # mean would shrink the effective LR by size()).  Compression
        # objects are not config-serializable: load_model's compression=
        # restores one.
        cfg = super().get_config()
        cfg["hvd_average"] = self._hvd_average
        cfg["hvd_prefix"] = self._hvd_prefix
        return cfg

    @classmethod
    def from_config(cls, config, custom_objects=None):
        config = dict(config)
        average = config.pop("hvd_average", True)
        prefix = config.pop("hvd_prefix", None)
        try:
            inst = super().from_config(config, custom_objects)
        except TypeError:
            inst = super().from_config(config)
        inst._hvd_average = average
        if prefix:
            inst._hvd_prefix = prefix
        return inst


def DistributedOptimizer(optimizer, name: str | None = None,
                         device_dense: str = "", device_sparse: str = "",
                         compression=Compression.none,
                         sparse_as_dense: bool = False, *,
                         average: bool = True):
    """Wrap a keras optimizer so that gradients are averaged (summed with
    ``average=False``) over the ranks before the update (reference
    horovod/keras/__init__.py:32-59; ``device_dense``/``device_sparse``/
    ``sparse_as_dense`` are kept for the signature: this process's device
    is ``basics.device()``)."""
    del device_dense, device_sparse, sparse_as_dense
    _keras()
    if _basics.is_initialized():
        _check_device()
    cls = optimizer.__class__
    if isinstance(optimizer, _DistributedApplyMixin):
        raise ValueError(
            "optimizer is already a horovod_tpu_torch.keras "
            "DistributedOptimizer")
    wrapped = _dist_class(cls).from_config(optimizer.get_config())
    wrapped._hvd_compression = compression
    wrapped._hvd_average = average
    wrapped._hvd_prefix = name or ("Distributed" + cls.__name__)
    if getattr(optimizer, "built", False):
        # keep the slot state (momenta, iterations): wrapping a live
        # optimizer (load_model) resumes training
        wrapped.build(optimizer._trainable_variables)
        for sv, dv in zip(optimizer.variables, wrapped.variables):
            dv.assign(sv)
    return wrapped


# ---------------------------------------------------------------------------
# load_model (reference horovod/keras/__init__.py:116-148).
# ---------------------------------------------------------------------------


def load_model(filepath, custom_optimizers=None, custom_objects=None,
               compression=Compression.none):
    """Load a saved keras model with its optimizer wrapped in
    :func:`DistributedOptimizer`, the saved optimizer state (iterations,
    momenta) carried into the wrapper.  Keras restores the optimizer and
    its variables; a plain optimizer is then retyped in place, and a
    model saved with a wrapped one loads through the ``Distributed<Cls>``
    registry entries made here first."""
    keras = _keras()
    base = keras.optimizers.Optimizer
    for attr in dir(keras.optimizers):
        c = getattr(keras.optimizers, attr)
        if isinstance(c, type) and issubclass(c, base) and c is not base:
            _dist_class(c)
    for c in custom_optimizers or []:
        _dist_class(c)
    model = keras.saving.load_model(filepath, custom_objects=custom_objects)
    opt = getattr(model, "optimizer", None)
    if isinstance(opt, _DistributedApplyMixin):
        opt._hvd_compression = compression
    elif opt is not None:
        # Retype in place rather than swapping the attribute: the model
        # already tracks this optimizer's variables.  The subclass adds
        # behaviour only, no state.
        opt.__class__ = _dist_class(opt.__class__)
        opt._hvd_compression = compression
    return model


from horovod_tpu_torch.keras import callbacks  # noqa: E402,F401
from horovod_tpu_torch import keras_elastic as elastic  # noqa: E402,F401

__all__ = [
    "init", "shutdown", "size", "local_size", "rank", "local_rank",
    "is_initialized", "Compression", "DistributedOptimizer", "allreduce",
    "allgather", "broadcast", "broadcast_variables",
    "broadcast_global_variables", "load_model", "callbacks", "elastic",
]
