"""Multi-axis rank meshes: dp / tp / sp / ep / pp (+ the dcn nesting).

Port of ``horovod_tpu/parallel/mesh.py``.  The JAX package lays a
``jax.sharding.Mesh`` over devices; the port runs one process per GPU, so a
:class:`Mesh` here lays the same named axes over the world's **ranks**: for
each axis it holds the process group of this rank's line along that axis,
the axis size, and this rank's coordinate on it.  The axis order is the
reference's, ``('dcn', 'pp', 'dp', 'ep', 'sp', 'tp')``, with ``tp``
innermost, so a tensor-parallel group is consecutive ranks (on one host,
the GPUs NVLink joins).

Each axis carries two groups over the same ranks: ``group(name)`` on the
world's backend (NCCL on cards, gloo on the CPU) for tensors, and
``host_group(name)`` on gloo for host objects (the serving engine's
command channel).  ``dist.new_group`` is collective over the whole world:
every rank creates every axis's groups, its own or not, in one fixed order
(axis by axis, lines in rank order), so every rank must call the builder.
Meshes are cached per process group, so a second call with the same axes
returns the same groups and creates none.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch.distributed as dist

AXIS_NAMES = ("dcn", "pp", "dp", "ep", "sp", "tp")
#: The data-parallel world's axis name (``basics.AXIS_NAME`` of the JAX
#: package, which ``horovod_tpu.init`` builds its mesh with).
DP_AXIS_NAME = "hvd"

_CACHE: dict = {}


def _world_ranks() -> list[int]:
    """The world's ranks; a process with no process group is a world of
    one (rank 0)."""
    if not dist.is_initialized():
        return [0]
    return list(range(dist.get_world_size()))


class Mesh:
    """Named axes over ranks.  ``ranks``: the rank of every mesh position,
    shaped by the axes (``axis_names`` in order); ``shape``: axis name →
    size.  ``group(name)`` / ``host_group(name)``: this rank's process
    groups along an axis (None when this rank is not in the mesh, or when
    no process group exists: a world of one); ``coordinate(name)``: this
    rank's index along the axis (None outside the mesh)."""

    def __init__(self, ranks: np.ndarray, axis_names: tuple[str, ...],
                 groups: dict, host_groups: dict, coords: dict | None):
        self.ranks = ranks
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, ranks.shape))
        self._groups = groups
        self._host_groups = host_groups
        self._coords = coords

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def group(self, name: str):
        return self._groups.get(name)

    def host_group(self, name: str):
        return self._host_groups.get(name)

    def coordinate(self, name: str) -> int | None:
        return None if self._coords is None else self._coords[name]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks={self.ranks.tolist()})"


def _build(ranks: np.ndarray, axis_names: tuple[str, ...]) -> Mesh:
    """Make every axis's groups (collective over the world, in one fixed
    order) and this rank's coordinates; cached per process group."""
    key = (id(dist.group.WORLD) if dist.is_initialized() else None,
           axis_names, ranks.shape, tuple(ranks.reshape(-1).tolist()))
    hit = _CACHE.get(key)
    if hit is not None and hit[0] is (dist.group.WORLD
                                      if dist.is_initialized() else None):
        return hit[1]
    me = dist.get_rank() if dist.is_initialized() else 0
    where = np.argwhere(ranks == me)
    coords = (None if where.size == 0 else
              dict(zip(axis_names, (int(c) for c in where[0]))))
    groups: dict = {}
    host_groups: dict = {}
    if dist.is_initialized():
        for ax, name in enumerate(axis_names):
            lines = np.moveaxis(ranks, ax, -1).reshape(-1, ranks.shape[ax])
            for line in lines:
                members = [int(r) for r in line]
                g = dist.new_group(members)
                h = dist.new_group(members, backend="gloo")
                if me in members:
                    groups[name], host_groups[name] = g, h
    mesh = Mesh(ranks, axis_names, groups, host_groups, coords)
    _CACHE[key] = (dist.group.WORLD if dist.is_initialized() else None,
                   mesh)
    return mesh


def make_mesh(*, dp: int = 1, tp: int = 1, sp: int = 1, ep: int = 1,
              pp: int = 1, ranks: Sequence[int] | None = None,
              dcn_slices: int = 1) -> Mesh:
    """Build a named mesh ``(['dcn',] 'pp', 'dp', 'ep', 'sp', 'tp')``.

    Axes of size 1 are kept (specs stay uniform); ``tp`` is innermost, so
    tensor-parallel groups are consecutive ranks; ``dcn_slices`` adds the
    outermost axis of a multi-host job.  ``ranks`` defaults to the world's;
    their number must equal the product of the axis sizes exactly.
    Collective over the world: every rank calls it."""
    rks = list(ranks) if ranks is not None else _world_ranks()
    shape = [dcn_slices, pp, dp, ep, sp, tp]
    names = list(AXIS_NAMES)
    for name, size in zip(names, shape):
        if size < 1:
            raise ValueError(f"mesh axis {name!r} must be >= 1, got {size}")
    total = math.prod(shape)
    if len(rks) != total:
        raise ValueError(
            f"mesh axes {dict(zip(names, shape))} need "
            f"{total} ranks (product of axis sizes), have {len(rks)}: "
            f"rank count must equal the axis product exactly")
    if dcn_slices == 1:
        shape, names = shape[1:], names[1:]
    return _build(np.asarray(rks, dtype=np.int64).reshape(shape),
                  tuple(names))


def data_parallel_mesh(ranks: Sequence[int] | None = None) -> Mesh:
    """1-D data-parallel mesh with the Horovod axis name (``"hvd"``), over
    the world's ranks or the given ones."""
    rks = np.asarray(ranks if ranks is not None else _world_ranks())
    if rks.ndim != 1 or rks.size == 0:
        raise ValueError(
            f"data_parallel_mesh needs a non-empty flat rank list, got "
            f"{rks.size} ranks with shape {tuple(rks.shape)}")
    return _build(rks.astype(np.int64), (DP_AXIS_NAME,))


def tensor_parallel_mesh(tp_size: int,
                         ranks: Sequence[int] | None = None) -> Mesh:
    """Serving-facing 1-axis ``('tp',)`` mesh over the first ``tp_size``
    ranks (the world's, or the given ones).

    The serving engine shards attention heads, MLP columns and the paged
    KV pool over this one axis (``models/llama.py`` partition specs); one
    mesh is one replica, and the block pool stays on the host of the
    axis's rank 0.  Collective over the world: every rank calls it, those
    past ``tp_size`` too (their mesh has no groups and no coordinate)."""
    if tp_size < 1:
        raise ValueError(
            f"tensor_parallel_mesh needs tp_size >= 1, got {tp_size}")
    rks = list(ranks) if ranks is not None else _world_ranks()
    if len(rks) < tp_size:
        raise ValueError(
            f"tensor_parallel_mesh(tp_size={tp_size}) needs {tp_size} "
            f"ranks, have {len(rks)}")
    return _build(np.asarray(rks[:tp_size], dtype=np.int64), ("tp",))
