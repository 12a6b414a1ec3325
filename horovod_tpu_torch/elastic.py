"""Elastic, fault-tolerant training: port of ``horovod_tpu/elastic.py``.

The ``hvd.elastic`` API Horovod grew in 0.20, shaped for gangs that a
launcher relaunches whole (``python -m horovod_tpu.launch --restarts N``):
state must survive the death of a process, not only a failed collective.
So :class:`State` commits through the rank-0 checkpoint pipeline
(:mod:`horovod_tpu_torch.checkpoint`), and every (re)start of a
:func:`run`-wrapped function resumes from the newest commit.

In-process retry covers failures that leave the process alive: a broken
control plane, a shutdown racing in-flight ops, surfaced as
:class:`~horovod_tpu_torch.basics.HorovodInternalError`.  :func:`run`
then shuts the eager engine and the process group down, brings them back
with the arguments of the last ``init`` (the same device and launcher
environment), restores the newest commit and replays.  A caller's mistake
(``ValueError``, a plain ``RuntimeError``) propagates.

Usage, advance-then-commit (progress counters move before the commit, so
a restore never replays work the commit covers)::

    state = elastic.State(ckpt_dir="/ckpts/run1", params=params,
                          opt_state=opt_state, epoch=0, batch=0)

    @elastic.run
    def train(state):
        while state.batch < batches:
            state.params, state.opt_state = step(state.params,
                                                 state.opt_state)
            state.batch += 1
            if state.batch % 10 == 0:
                state.commit()

    train(state)

:class:`LiveObjectState` is the protocol over live objects (a model and
its optimizer, :class:`horovod_tpu_torch.torch_elastic.TorchState`).
"""

from __future__ import annotations

import functools
import os
import re
import warnings
import zipfile
from typing import Any, Callable

import numpy as np
import torch

from horovod_tpu_torch import basics, checkpoint
from horovod_tpu_torch.basics import HorovodInternalError
from horovod_tpu_torch.optim.distributed_optimizer import (
    broadcast_optimizer_state)
from horovod_tpu_torch.utils.tree import tree_map

__all__ = ["BaseState", "LiveObjectState", "State", "run",
           "atomic_write", "restore_newest_commit", "HorovodInternalError"]

# Key under which State keeps its own bookkeeping inside the committed tree
# (beside the user's fields, so that one checkpoint is one commit).
_META = "__elastic__"


def _own(leaf: Any) -> Any:
    """A mutable copy of a numpy leaf that shares no memory with the commit
    snapshot: a later in-place change of the live field must not reach the
    rollback point."""
    if isinstance(leaf, np.ndarray):
        return np.array(leaf)
    return leaf


def _host_snapshot(tree: Any) -> Any:
    """The in-memory commit: tensors copied to the host (the counterpart of
    ``jax.device_get``; a copy on the card would die with the engine on
    reinit and double the memory it holds), numpy leaves copied."""
    return tree_map(_own, checkpoint._host_copy(tree))


def _map2(fn: Callable, cur: Any, new: Any) -> Any:
    """``fn(cur_leaf, new_leaf)`` over two trees of one structure; a
    ``ValueError`` where the structures differ."""
    if isinstance(cur, dict):
        if not isinstance(new, dict) or set(cur) != set(new):
            raise ValueError("dict keys differ")
        return {k: _map2(fn, cur[k], new[k]) for k in cur}
    if isinstance(cur, (tuple, list)):
        if not isinstance(new, (tuple, list)) or len(cur) != len(new):
            raise ValueError("sequence lengths differ")
        return type(cur)(_map2(fn, c, n) for c, n in zip(cur, new))
    if isinstance(new, (dict, tuple, list)):
        raise ValueError("a leaf became a container")
    return fn(cur, new)


class BaseState:
    """The interface :func:`run` keys on: ``commit`` / ``restore`` /
    ``sync`` (:class:`State` here, the torch objects'
    :class:`~horovod_tpu_torch.torch_elastic.TorchState`)."""

    def commit(self) -> None:
        raise NotImplementedError

    def restore(self) -> None:
        raise NotImplementedError

    def sync(self) -> None:
        raise NotImplementedError


class LiveObjectState(BaseState):
    """Elastic state over LIVE framework objects: declared scalar fields
    with completeness guards, in-memory and durable rank-0 commits, and the
    restore order (durable walk → in-memory commit → plain sync).
    Subclasses supply the serializer and the object slots."""

    _reserved: tuple = ()       # object-slot attribute names
    _suffix: str = "bin"        # step_<N>.<suffix> commit files

    def _init_live(self, ckpt_dir, scalars: dict) -> None:
        for k in scalars:
            if k.startswith("_") or k in self._reserved:
                raise ValueError(f"reserved field name: {k!r}")
        object.__setattr__(self, "_scalars", dict(scalars))
        object.__setattr__(self, "_ckpt_dir",
                           os.path.abspath(ckpt_dir) if ckpt_dir else None)
        object.__setattr__(self, "_mem_commit", None)
        object.__setattr__(self, "_commit_step", 0)

    def __getattr__(self, name: str):
        scalars = object.__getattribute__(self, "_scalars")
        if name in scalars:
            return scalars[name]
        raise AttributeError(name)

    def __setattr__(self, name: str, value) -> None:
        if name in type(self)._reserved or name.startswith("_"):
            object.__setattr__(self, name, value)
            return
        scalars = object.__getattribute__(self, "_scalars")
        if name in scalars:
            scalars[name] = value
        else:
            raise AttributeError(
                f"unknown state field {name!r}; declare every scalar in "
                f"{type(self).__name__}(...) so commits stay complete")

    @property
    def commit_step(self) -> int:
        return object.__getattribute__(self, "_commit_step")

    def _adopt_scalars(self, incoming: dict) -> None:
        # Only DECLARED fields are adopted: a commit from an older revision
        # must not slip undeclared keys past the __setattr__ guard.
        scalars = object.__getattribute__(self, "_scalars")
        for k in scalars:
            if k in incoming:
                scalars[k] = incoming[k]

    # -- subclass hooks ---------------------------------------------------

    def _snapshot(self) -> dict:
        raise NotImplementedError

    def _load_local(self, snap) -> None:
        raise NotImplementedError

    def _write_file(self, dst: str, snap) -> None:
        raise NotImplementedError

    def _read_file(self, path: str):
        raise NotImplementedError

    def _rank0(self) -> bool:
        raise NotImplementedError

    def _broadcast_obj(self, obj):
        raise NotImplementedError

    # -- the shared protocol ----------------------------------------------

    def commit(self) -> None:
        """Snapshot in host memory; rank 0 also writes ``step_N.<suffix>``
        atomically (temporary file, fsync, rename)."""
        object.__setattr__(self, "_commit_step", self.commit_step + 1)
        snap = self._snapshot()
        object.__setattr__(self, "_mem_commit", snap)
        ckpt_dir = object.__getattribute__(self, "_ckpt_dir")
        if ckpt_dir and self._rank0():
            os.makedirs(ckpt_dir, exist_ok=True)
            self._write_file(
                os.path.join(ckpt_dir,
                             f"step_{self.commit_step}.{self._suffix}"),
                snap)

    def restore(self) -> None:
        """Adopt the newest commit: durable ``step_N.<suffix>`` (the root
        reads, every rank receives through ``sync``) → in-memory snapshot
        → plain sync of the initial values."""
        ckpt_dir = object.__getattribute__(self, "_ckpt_dir")
        if ckpt_dir:
            outcome = restore_newest_commit(
                ckpt_dir, self._suffix, self._read_file, self._load_local,
                self._rank0(), self._broadcast_obj)
            if outcome == "ok":
                self.sync()         # the root's loaded values fan out
                return
            if outcome is not None:
                raise RuntimeError(
                    f"elastic restore failed on root: {outcome}")
        mem = object.__getattribute__(self, "_mem_commit")
        if mem is not None:
            self._load_local(mem)
        self.sync()


def atomic_write(dst: str, write_fn: Callable[[Any], None]) -> None:
    """Temporary file, fsync, rename, fsync of the directory: a renamed
    commit file is a complete file, and the rename itself survives a power
    loss."""
    with open(dst + ".tmp", "wb") as f:
        write_fn(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(dst + ".tmp", dst)
    try:
        dfd = os.open(os.path.dirname(dst) or ".", os.O_RDONLY)
    except OSError:
        return     # a platform without directory fds: best effort
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def restore_newest_commit(ckpt_dir: str, suffix: str,
                          read_file: Callable[[str], Any],
                          load_local: Callable[[Any], None],
                          is_root: bool,
                          broadcast_obj: Callable[[Any], Any]):
    """The durable-restore walk and its agreed outcome.

    Newest first over ``step_<N>.<suffix>``.  A file that is not a zip
    (``torch.save`` writes one) is a write torn by a kill: the walk goes on
    to the previous commit, with a warning.  A file that IS a zip but does
    not load is not truncation, so it fails every rank rather than rolling
    back silently.  Every root-side failure becomes an outcome value agreed
    through ``broadcast_obj``, which the root always reaches, so no rank is
    left waiting in a collective.  Returns the agreed outcome (None: no
    commit, "ok": loaded on the root, else an error string)."""
    outcome = None
    if is_root:
        try:
            snap = None
            if os.path.isdir(ckpt_dir):
                steps = sorted(
                    (int(m.group(1)) for m in (
                        re.fullmatch(rf"step_(\d+)\.{re.escape(suffix)}", e)
                        for e in os.listdir(ckpt_dir)) if m),
                    reverse=True)
                for s in steps:
                    path = os.path.join(ckpt_dir, f"step_{s}.{suffix}")
                    try:
                        snap = read_file(path)
                        break
                    except Exception as e:
                        if zipfile.is_zipfile(path):
                            raise
                        warnings.warn(
                            f"elastic restore: skipping unreadable "
                            f"checkpoint {path} ({type(e).__name__}: "
                            f"{e}); falling back to the previous commit",
                            stacklevel=2)
                        continue
            if snap is not None:
                load_local(snap)
                outcome = "ok"
        except Exception as e:
            outcome = f"{type(e).__name__}: {e}"
    return broadcast_obj(outcome)


class State(BaseState):
    """Named training state with commit / restore / sync.

    ``fields`` are trees of tensors (params, optimizer state) or plain
    Python scalars (epoch, batch), read and written as attributes.
    ``commit()`` snapshots them on the host; ``restore()`` rolls back to the
    newest commit; ``sync()`` broadcasts the root's values so that a
    (re)started gang agrees.

    With ``ckpt_dir`` each commit is also a rank-0 checkpoint
    (:func:`~horovod_tpu_torch.checkpoint.save_checkpoint`, written in the
    background unless ``sync_commits=True``) that survives a gang
    relaunch; without it commits live in host memory only."""

    def __init__(self, ckpt_dir: str | None = None, *,
                 sync_commits: bool = False, **fields: Any) -> None:
        if not fields:
            raise ValueError("State needs at least one field, e.g. "
                             "State(params=params, epoch=0)")
        for k in fields:
            if k.startswith("_") or k == _META:
                raise ValueError(f"reserved field name: {k!r}")
        object.__setattr__(self, "_fields", dict(fields))
        object.__setattr__(self, "_ckpt_dir",
                           os.path.abspath(ckpt_dir) if ckpt_dir else None)
        # sync_commits=True: commit() returns once the write is on disk,
        # for a gang the supervisor may kill at any moment.
        object.__setattr__(self, "_sync_commits", bool(sync_commits))
        object.__setattr__(self, "_mem_commit", None)
        object.__setattr__(self, "_commit_step", 0)

    def __getattr__(self, name: str) -> Any:
        fields = object.__getattribute__(self, "_fields")
        if name in fields:
            return fields[name]
        raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        if name in object.__getattribute__(self, "_fields"):
            object.__getattribute__(self, "_fields")[name] = value
        else:
            raise AttributeError(
                f"unknown state field {name!r}; declare every field in "
                f"State(...) so commits stay complete")

    @property
    def commit_step(self) -> int:
        """Monotonic count of commits (0 = never committed)."""
        return object.__getattribute__(self, "_commit_step")

    def _tree(self) -> dict:
        return {**object.__getattribute__(self, "_fields"),
                _META: {"commit_step": self.commit_step}}

    def commit(self) -> None:
        """Snapshot the fields as the rollback and resume point: on the
        host always, and with ``ckpt_dir`` as a rank-0 checkpoint too."""
        object.__setattr__(self, "_commit_step", self.commit_step + 1)
        snap = _host_snapshot(self._tree())
        object.__setattr__(self, "_mem_commit", snap)
        ckpt_dir = object.__getattribute__(self, "_ckpt_dir")
        if ckpt_dir:
            checkpoint.save_checkpoint(
                ckpt_dir, snap, step=self.commit_step,
                async_save=not object.__getattribute__(self, "_sync_commits"))

    def sync(self) -> None:
        """Broadcast every field from the root (the reference resume
        recipe, pytorch_imagenet_resnet50.py:134-142); scalars keep their
        types through the wire."""
        self._adopt(broadcast_optimizer_state(self._tree(), root_rank=0))

    def restore(self) -> None:
        """Adopt the newest commit, agreed across the gang: durable
        checkpoint → in-memory snapshot → plain :meth:`sync` of the initial
        values.  Ends with every rank holding the same values."""
        ckpt_dir = object.__getattribute__(self, "_ckpt_dir")
        if ckpt_dir:
            checkpoint.wait_for_checkpoints()   # a commit still in flight
            # Newest first, past torn checkpoints; every rank raises or
            # succeeds together inside restore_checkpoint.
            for cand in checkpoint.list_checkpoints(ckpt_dir):
                try:
                    self._adopt(checkpoint.restore_checkpoint(
                        cand, template=self._tree()))
                    return
                except HorovodInternalError:
                    # A collective that failed mid-restore is not a torn
                    # checkpoint: falling back would resume from an older
                    # commit.  run() reinitialises and tries the newest
                    # again.
                    raise
                except RuntimeError:
                    continue
        mem = object.__getattribute__(self, "_mem_commit")
        if mem is not None:
            # Process-local host memory; sync() re-establishes agreement.
            self._adopt(mem)
        self.sync()

    def _adopt(self, tree: dict) -> None:
        meta = tree.get(_META, {})
        object.__setattr__(
            self, "_commit_step", int(meta.get("commit_step",
                                               self.commit_step)))
        fields = object.__getattribute__(self, "_fields")

        def _coerce(cur: Any, new: Any) -> Any:
            # Declared Python scalars come back as their declared type;
            # tensors go onto the live field's device as fresh storage, so
            # neither aliases the snapshot.
            if isinstance(cur, (bool, int, float)):
                return type(cur)(new.item() if isinstance(new, torch.Tensor)
                                 else new)
            if isinstance(new, torch.Tensor):
                dev = cur.device if isinstance(cur, torch.Tensor) else None
                return new.to(dev, copy=True)
            return _own(new)

        def _fresh(new: Any) -> Any:
            return (new.clone() if isinstance(new, torch.Tensor)
                    else _own(new))

        for k in fields:
            if k in tree:
                try:
                    fields[k] = _map2(_coerce, fields[k], tree[k])
                except (ValueError, TypeError):
                    warnings.warn(
                        f"elastic state field {k!r}: restored structure "
                        f"does not match the declared field; adopting the "
                        f"restored value as-is (check for model/optimizer "
                        f"code drift between commit and restore)",
                        stacklevel=2)
                    fields[k] = tree_map(_fresh, tree[k])


def _reinit() -> None:
    """Shut the eager engine and the process group down (an engine that
    already died is tolerated) and bring them back with the last ``init``'s
    device and launcher environment.  A bare ``init()`` would put a CPU
    world on the card, or a launched world into a world of one."""
    args = basics._state.last_init_args
    try:
        basics.shutdown()
    except Exception:
        pass
    if args is None:
        basics.init()
    else:
        basics._init(*args)


def run(fn: Callable) -> Callable:
    """Decorator: ``fn(state, ...)`` survives environmental collective
    failures (:class:`HorovodInternalError`) by reinit → restore → replay,
    up to ``HVD_TORCH_ELASTIC_RETRIES`` consecutive times (default 3).

    The state is restored on entry, so a gang relaunched by the launcher
    resumes from the newest durable commit with no extra code, and a first
    start syncs the initial values from the root.  Mirrors
    ``horovod.elastic.run`` (Horovod 0.20+)."""

    @functools.wraps(fn)
    def wrapper(state: BaseState, *args: Any, **kwargs: Any) -> Any:
        if not isinstance(state, BaseState):
            raise TypeError("first argument to an elastic.run function "
                            "must be an elastic.State (or TorchState)")
        basics._require_init()
        retries = int(os.environ.get("HVD_TORCH_ELASTIC_RETRIES", "3"))
        attempt = 0
        last_fail_commit: int | None = None
        need_restore = True
        while True:
            try:
                # restore() runs collectives and may itself fail; inside
                # the retried region such a failure costs an attempt.
                if need_restore:
                    state.restore()
                    need_restore = False
                return fn(state, *args, **kwargs)
            except HorovodInternalError:
                # The budget bounds CONSECUTIVE unproductive failures:
                # progress since the previous failure (commit_step moved)
                # resets it.
                commit = getattr(state, "commit_step", None)
                if (last_fail_commit is not None and commit is not None
                        and commit > last_fail_commit):
                    attempt = 0
                last_fail_commit = commit
                attempt += 1
                if attempt > retries:
                    raise
                _reinit()
                need_restore = True

    return wrapper
