"""The port's ``cross_size``, ``cross_rank`` and ``mpi_threads_supported``,
and the package's re-exports, against the JAX package's.

The names mirror ``horovod_tpu/basics.py`` (exported through
``horovod_tpu/__init__.py``, ``horovod_tpu/torch.py`` and
``horovod_tpu/keras/__init__.py``).  In a world of one they answer what the
JAX package answers in ``tests/test_fusion_basics.py`` (1, 0, True); in a
gloo world of 4 numbered into nodes of 2 they answer Horovod's: 2 nodes,
this rank's node ``rank // 2``.
"""

from __future__ import annotations

import pytest

import horovod_tpu as jhvd
import horovod_tpu_torch as hvd
from horovod_tpu_torch import basics
from horovod_tpu_torch.basics import _cross
from torch_gloo_world import start_world

NAMES = ("cross_size", "cross_rank", "mpi_threads_supported")


def _names_rank(rank: int, world: int) -> dict:
    import horovod_tpu_torch.keras as hvdk
    import horovod_tpu_torch.torch_frontend as thvd

    out = {"cross_size": hvd.cross_size(), "cross_rank": hvd.cross_rank(),
           "mpi": hvd.mpi_threads_supported(),
           "local": (hvd.local_rank(), hvd.local_size()),
           "frontends": [(m.cross_size(), m.cross_rank(),
                          m.mpi_threads_supported())
                         for m in (thvd, hvdk)]}
    basics.shutdown()
    raised = []
    try:
        for name in NAMES:
            try:
                getattr(hvd, name)()
                raised.append(None)
            except basics.NotInitializedError as e:
                raised.append(type(e).__name__)
    finally:
        basics.init("cpu")
    out["raised"] = raised
    return out


def test_cross_names_in_a_world_of_four_on_nodes_of_two():
    res = start_world(_names_rank, 4, local_size=2)(timeout=120)
    for r, out in enumerate(res):
        assert out["cross_size"] == 2 and out["cross_rank"] == r // 2
        assert out["mpi"] is True
        assert out["local"] == (r % 2, 2)
        assert out["frontends"] == [(2, r // 2, True)] * 2
        assert out["raised"] == ["NotInitializedError"] * 3


def test_world_of_one_equals_the_jax_package():
    """The JAX package's single controller is one process: cross size 1,
    cross rank 0 (tests/test_fusion_basics.py)."""
    started = not basics.is_initialized()
    if started:
        basics.init("cpu")
    try:
        want = (jhvd.cross_size(), jhvd.cross_rank(),
                jhvd.mpi_threads_supported())
        assert want == (1, 0, True)
        assert (hvd.cross_size(), hvd.cross_rank(),
                hvd.mpi_threads_supported()) == want
    finally:
        if started:
            basics.shutdown()


@pytest.mark.parametrize("size,local", [(1, 1), (4, 2), (6, 3), (3, 2),
                                        (5, 2), (7, 3), (4, 4), (2, 1)])
def test_cross_group_is_horovods_cross_communicator(size, local):
    """Horovod splits the world by local rank (reference
    operations.cc:1558-1590): the cross group of a rank is every rank that
    shares its local rank, ordered by rank.  Where ``local`` does not
    divide ``size`` the last node is partial and ranks of different local
    rank see different cross sizes."""
    for r in range(size):
        group = [q for q in range(size) if q % local == r % local]
        assert _cross(r, size, local) == (group.index(r), len(group))
        if size % local == 0:
            assert _cross(r, size, local) == (r // local, size // local)


def test_the_package_re_exports_the_data_helpers():
    from horovod_tpu_torch import data

    assert hvd.ShardedLoader is data.ShardedLoader
    assert hvd.shard_indices is data.shard_indices
    assert hvd.prefetch_to_device is data.prefetch_to_device
    for name in (*NAMES, "ShardedLoader", "shard_indices",
                 "prefetch_to_device"):
        assert name in hvd.__all__ and hasattr(jhvd, name)
