"""Checkpoint and resume conventions: port of ``horovod_tpu/checkpoint.py``.

The reference's conventions (SURVEY.md §5): rank-0-only writes
(reference examples/tensorflow_mnist.py:106-108), resume = find the last
checkpoint, load on the root, broadcast to all
(pytorch_imagenet_resnet50.py:134-142), and ``load_model``, which re-wraps
the optimizer in ``DistributedOptimizer`` (horovod/keras/__init__.py:
115-148).

Storage is ``torch.save`` of a host copy, read back with
``torch.load(weights_only=True)``: a checkpoint holds nested dicts, lists
and tuples of tensors and plain Python values.  A module or optimizer in
the state is saved as its ``state_dict()`` (a ``DistributedOptimizer``'s
carries a stateful compressor's state), and restored into with
``load_state_dict`` when the template holds it.  Checkpoints are files
``<path>/step_<n>``, each written to a temporary name and renamed, so a
torn write never shows as a checkpoint.
"""

from __future__ import annotations

import concurrent.futures
import os
import re
from typing import Any

import torch

from horovod_tpu_torch import basics
from horovod_tpu_torch.optim.distributed_optimizer import (
    DistributedOptimizer, _broadcast_tree, allgather_object,
    broadcast_object)
from horovod_tpu_torch.utils.tree import tree_map

_writer: concurrent.futures.ThreadPoolExecutor | None = None
_pending: list[concurrent.futures.Future] = []


def _has_state_dict(x: Any) -> bool:
    """A module or an optimizer (torch's or the port's wrapper)."""
    return hasattr(x, "state_dict") and hasattr(x, "load_state_dict")


def _host_copy(state: Any) -> Any:
    """``state`` as a tree of CPU tensors and plain values: modules and
    optimizers by their ``state_dict()``, tensors copied to the host."""
    if _has_state_dict(state):
        state = state.state_dict()
    if isinstance(state, dict):
        return {k: _host_copy(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_host_copy(v) for v in state)
    if isinstance(state, torch.Tensor):
        return state.detach().to("cpu", copy=True)
    return state


def _write(state: Any, target: str) -> None:
    tmp = f"{target}.tmp{os.getpid()}"
    torch.save(state, tmp)
    os.replace(tmp, target)


def save_checkpoint(path: str, state: Any, *, step: int | None = None,
                    async_save: bool = False) -> str | None:
    """Write ``state`` from rank 0 only (the reference's ``if hvd.rank() ==
    0: saver.save(...)``) to ``<path>/step_<step>``, or to ``path`` itself
    when ``step`` is None.  Returns the path written, or None on the other
    ranks.

    ``async_save=True`` returns once the state is copied to the host and
    writes it in one background thread, so training goes on during the
    disk write; :func:`wait_for_checkpoints` waits for the writes."""
    global _writer
    basics._require_init()
    if basics.rank() != 0:
        return None
    base = os.path.abspath(path)
    target = os.path.join(base, f"step_{step}") if step is not None else base
    os.makedirs(os.path.dirname(target), exist_ok=True)
    host = _host_copy(state)
    if async_save:
        if _writer is None:
            _writer = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="hvd-checkpoint")
        _pending.append(_writer.submit(_write, host, target))
        return target
    _write(host, target)
    return target


def wait_for_checkpoints() -> None:
    """Block until every pending :func:`save_checkpoint` async write has
    landed; re-raises a write's error."""
    while _pending:
        _pending.pop(0).result()


def list_checkpoints(path: str) -> list[str]:
    """Every ``step_<n>`` checkpoint under ``path``, newest first, as the
    root sees its disk (rank-0 writes: other disks may hold nothing); every
    rank receives the root's list."""
    basics._require_init()
    found: list[str] = []
    if basics.rank() == 0 and os.path.isdir(path):
        steps = [int(m.group(1)) for e in os.listdir(path)
                 if (m := re.fullmatch(r"step_(\d+)", e))]
        found = [os.path.join(os.path.abspath(path), f"step_{s}")
                 for s in sorted(steps, reverse=True)]
    return broadcast_object(found, root_rank=0)


def latest_checkpoint(path: str) -> str | None:
    """The newest ``step_<n>`` checkpoint under ``path`` (the resume scan
    of reference keras_imagenet_resnet50.py:66-70), agreed by every rank."""
    found = list_checkpoints(path)
    return found[0] if found else None


def _assign(template: Any, value: Any) -> Any:
    """``value`` (the root's tree, on this process's device) poured into
    ``template``'s objects: modules and optimizers load it in place, tensors
    take the template's device and dtype; returns the template's
    structure."""
    if _has_state_dict(template):
        template.load_state_dict(value)
        return template
    if isinstance(template, dict):
        return {k: _assign(template[k], value[k]) for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_assign(t, v) for t, v in zip(template, value))
    if isinstance(template, torch.Tensor):
        return value.to(template.device, template.dtype)
    return value


def restore_checkpoint(path: str, template: Any = None, *,
                       root_rank: int = 0) -> Any:
    """Load on the root, broadcast to every rank: the reference's
    load-then-``broadcast_parameters`` resume recipe as one call.

    With a ``template`` only the root reads the file (other disks may not
    hold it); the result has the template's structure, its modules and
    optimizers loaded in place.  Without one every rank reads (a shared
    file system) and the broadcast makes them agree.  The outcome of the
    read is agreed first (``allgather_object``), so a failed read raises
    the same ``RuntimeError`` on every rank instead of leaving the others
    in a collective."""
    basics._require_init()
    base = os.path.abspath(path)
    state, err = None, None
    if template is None or basics.rank() == root_rank:
        try:
            state = torch.load(base, map_location="cpu", weights_only=True)
        except Exception as e:   # reported on every rank below
            err = f"rank {basics.rank()}: {type(e).__name__}: {e}"
    bad = [e for e in allgather_object(err) if e]
    if bad:
        raise RuntimeError("checkpoint restore failed: " + "; ".join(bad))
    state = _broadcast_tree(state, root_rank)   # the root's, on this device
    return state if template is None else _assign(template, state)


def load_model(path: str, optimizer, template: Any = None, **dist_kwargs):
    """Restore a training state and re-wrap ``optimizer`` in
    :class:`DistributedOptimizer` (``hvd.load_model``, so a resume cannot
    run un-distributed).  Where ``template`` holds ``optimizer`` itself,
    the wrapper takes its place and loads the saved optimizer state,
    a stateful compressor's included.  Returns
    ``(state, distributed_optimizer)``."""
    dopt = DistributedOptimizer(optimizer, **dist_kwargs)
    if template is not None:
        template = tree_map(lambda x: dopt if x is optimizer else x, template)
    return restore_checkpoint(path, template), dopt
