"""The port's Adasum, process sets and remaining collectives, against the
JAX package's on gloo worlds of 2, 3 and 4 processes.

Mirrors ``tests/test_adasum.py``, ``tests/test_process_set.py``,
``tests/test_allgather_broadcast.py`` and ``tests/test_spmd_ops.py``,
with the reference's negative cases.  Per-rank inputs come from seeded
numpy; the JAX side runs under ``shard_map`` on as many CPU devices, rank
r of the port held against row r.  One spawn per world for the file.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from horovod_tpu_torch import basics
from horovod_tpu_torch.ops import collective_ops as C
from horovod_tpu_torch.ops.compression import Compression
from horovod_tpu_torch.optim.distributed_optimizer import (allgather_object,
                                                           broadcast_object)
from torch_gloo_world import jax_spmd, start_world

WORLDS = (2, 3, 4)
SHAPE = (5, 7)
SET = (0, 2, 3)                 # the process set, in a world of 4
PS_OPS = ("Sum", "Average", "Min", "Max")
# Adasum's dot products and norms sum in another order than XLA's, and a
# world of 4 takes two rounds.
ADASUM_RTOL = 1e-5
# Through fp16 the result is cast to fp16 at the end: one fp16 ulp.
ADASUM_FP16_RTOL = 2 ** -10
ALLTOALL_AXES = ((0, 0), (1, 1), (0, 1), (1, 0))
# A process-set sum in fp16 over three members: gloo rounds to fp16 after
# each add, XLA once; within two fp16 ulps at the sums' magnitude (< 4).
PS_FP16_ATOL = 2 ** -8


def _x(rank, world, shape=SHAPE, seed=0):
    rng = np.random.RandomState(seed + 10 * world + rank)
    return rng.randn(*shape).astype(np.float32)


def _a2a_input(rank, world):
    return np.arange(2 * world * 3 * world, dtype=np.float32).reshape(
        2 * world, 3 * world) + 1000 * rank


def _raises(call):
    try:
        call()
    except Exception as e:      # recorded and held by the tests
        return type(e).__name__, str(e)
    return None


def _worker(rank, world):
    seen = {}
    x = torch.from_numpy(_x(rank, world))
    y = torch.from_numpy(_x(rank, world, (11,), seed=50))
    seen["adasum"] = C.allreduce(x, op=C.Adasum).numpy()
    seen["adasum_fp16"] = C.allreduce(x, op=C.Adasum,
                                      compression=Compression.fp16).numpy()
    seen["adasum_grouped"] = [t.numpy() for t in C.grouped_allreduce(
        [x, y], op=C.Adasum, fusion_threshold_bytes=1 << 20)]
    seen["adasum_y"] = C.allreduce(y, op=C.Adasum).numpy()
    if world == 4:
        ps = C.ProcessSet(SET)
        for name in PS_OPS:
            seen[("ps", name)] = C.allreduce(
                x, op=getattr(C, name), process_set=ps).numpy()
        seen[("ps", "fp16")] = C.allreduce(
            x, average=True, compression=Compression.fp16,
            process_set=ps).numpy()
        seen[("ps", "grouped")] = [t.numpy() for t in C.grouped_allreduce(
            [x, y], op=C.Sum, process_set=ps)]
        seen[("ps", "bcast")] = C.broadcast(x, 2, process_set=ps).numpy()
        C.barrier(process_set=ps)
        seen[("ps", "errors")] = [_raises(c) for c in (
            lambda: C.broadcast(x, 1, process_set=ps),
            lambda: C.allreduce(x, op=C.Adasum, process_set=ps),
            lambda: C.allreduce(x, compression=Compression.int8,
                                process_set=ps),
            lambda: C.allreduce(x, op=C.Product, process_set=ps),
            lambda: C.allreduce(x, process_set=C.ProcessSet([1, 4])))]
    seen["bcast"] = C.broadcast(x, world - 1).numpy()
    seen["bcast_bool"] = C.broadcast(x > 0, 1).numpy()
    seen["gather"] = C.allgather(torch.full((rank + 1, 3), float(rank))
                                 ).numpy()
    seen["gather_int"] = C.allgather(torch.arange(rank + 2)).numpy()
    seen["gather_bool"] = C.allgather(torch.tensor([rank % 2 == 0] * (rank + 1))
                                      ).numpy()
    a2a = torch.from_numpy(_a2a_input(rank, world))
    for sa, ca in ALLTOALL_AXES:
        seen[("a2a", sa, ca)] = C.alltoall(a2a, split_axis=sa,
                                           concat_axis=ca).numpy()
    rs = torch.from_numpy(_x(rank, world, (2 * world, 3)))
    seen["rs_sum"] = C.reducescatter(rs).numpy()
    seen["rs_avg"] = C.reducescatter(rs, op=C.Average).numpy()
    C.barrier()
    seen["barrier"] = True
    seen["bcast_obj"] = broadcast_object({"from": rank, "s": "x" * rank},
                                         root_rank=world - 1)
    seen["gather_obj"] = allgather_object(("r", rank, list(range(rank))))
    seen["errors"] = [_raises(c) for c in (
        lambda: C.allgather(torch.zeros(2, 3 + rank)),
        lambda: C.allgather(torch.zeros(2, dtype=torch.float32 if rank
                                        else torch.float64)),
        lambda: C.reducescatter(rs, op=C.Min),
        lambda: C.alltoall(torch.zeros(world + 1)),
        lambda: C.allreduce(x, op=C.Adasum, compression=Compression.int8),
        lambda: C.broadcast(x, world))]
    # Every collective still works after the refusals (nothing half-sent).
    seen["after_errors"] = C.allreduce(torch.ones(2), average=True).numpy()
    return seen


def _jax_side(world):
    import jax.numpy as jnp

    import horovod_tpu as hvd
    from horovod_tpu.ops import collective_ops as J

    xs = jnp.asarray(np.stack([_x(r, world) for r in range(world)]))
    ys = jnp.asarray(np.stack([_x(r, world, (11,), seed=50)
                               for r in range(world)]))
    out = {"adasum": jax_spmd(lambda x: J.allreduce(x, op=J.Adasum),
                              world, xs),
           "adasum_fp16": jax_spmd(
               lambda x: J.allreduce(x, op=J.Adasum,
                                     compression=hvd.Compression.fp16),
               world, xs),
           "adasum_y": jax_spmd(lambda x: J.allreduce(x, op=J.Adasum),
                                world, ys),
           "bcast": jax_spmd(lambda x: J.broadcast(x, world - 1), world, xs),
           "bcast_bool": jax_spmd(lambda x: J.broadcast(x > 0, 1), world,
                                  xs)}
    if world == 4:
        ps = J.ProcessSet(SET)
        for name in PS_OPS:
            out[("ps", name)] = jax_spmd(
                lambda x: J.allreduce(x, op=getattr(J, name), process_set=ps),
                world, xs)
        out[("ps", "fp16")] = jax_spmd(
            lambda x: J.allreduce(x, average=True,
                                  compression=hvd.Compression.fp16,
                                  process_set=ps), world, xs)
        out[("ps", "bcast")] = jax_spmd(
            lambda x: J.broadcast(x, 2, process_set=ps), world, xs)
    a2a = jnp.asarray(np.stack([_a2a_input(r, world) for r in range(world)]))
    for sa, ca in ALLTOALL_AXES:
        out[("a2a", sa, ca)] = jax_spmd(
            lambda x: J.alltoall(x, split_axis=sa, concat_axis=ca), world,
            a2a)
    rs = jnp.asarray(np.stack([_x(r, world, (2 * world, 3))
                               for r in range(world)]))
    out["rs_sum"] = jax_spmd(lambda x: J.reducescatter(x), world, rs)
    out["rs_avg"] = jax_spmd(lambda x: J.reducescatter(x, op=J.Average),
                             world, rs)
    return out


@pytest.fixture(scope="module")
def worlds():
    joins = {w: start_world(_worker, w) for w in WORLDS}
    jx = {w: _jax_side(w) for w in WORLDS}
    return {w: (joins[w](), jx[w]) for w in WORLDS}


@pytest.mark.parametrize("world", WORLDS)
def test_adasum_matches_jax(worlds, world):
    """Butterfly at 2 and 4, the gather tree at 3."""
    ranks, jx = worlds[world]
    for r, seen in enumerate(ranks):
        np.testing.assert_allclose(seen["adasum"], jx["adasum"][r],
                                   rtol=ADASUM_RTOL, atol=ADASUM_RTOL)
        np.testing.assert_allclose(seen["adasum_fp16"], jx["adasum_fp16"][r],
                                   rtol=ADASUM_FP16_RTOL, atol=1e-4)
        assert seen["adasum_fp16"].dtype == np.float32
    for seen in ranks[1:]:      # the result is replicated
        np.testing.assert_array_equal(seen["adasum"], ranks[0]["adasum"])


@pytest.mark.parametrize("world", WORLDS)
def test_adasum_grouped_never_fuses(worlds, world):
    ranks, jx = worlds[world]
    for r, seen in enumerate(ranks):
        np.testing.assert_array_equal(seen["adasum_grouped"][0],
                                      seen["adasum"])
        np.testing.assert_array_equal(seen["adasum_grouped"][1],
                                      seen["adasum_y"])
        np.testing.assert_allclose(seen["adasum_y"], jx["adasum_y"][r],
                                   rtol=ADASUM_RTOL, atol=ADASUM_RTOL)


def test_adasum_pair_orthogonal_adds_parallel_averages():
    a = torch.tensor([1.0, 0.0, 0.0])
    b = torch.tensor([0.0, 2.0, 0.0])
    torch.testing.assert_close(C._adasum_pair(a, b), a + b)
    torch.testing.assert_close(C._adasum_pair(a, 3 * a), 2 * a)
    torch.testing.assert_close(C._adasum_pair(torch.zeros(3), b), b)


@pytest.mark.parametrize("op", PS_OPS + ("fp16",))
def test_process_set_allreduce_matches_jax(worlds, op):
    ranks, jx = worlds[4]
    atol = PS_FP16_ATOL if op == "fp16" else 1e-6
    for r, seen in enumerate(ranks):
        np.testing.assert_allclose(seen[("ps", op)], jx[("ps", op)][r],
                                   rtol=1e-6, atol=atol)
        if r not in SET:        # non-members: their input through the cast
            np.testing.assert_array_equal(seen[("ps", op)],
                                          jx[("ps", op)][r])
    xs = [_x(r, 4) for r in range(4)]
    np.testing.assert_array_equal(ranks[1][("ps", "Sum")], xs[1])


def test_process_set_grouped_and_broadcast(worlds):
    ranks, jx = worlds[4]
    ys = [_x(r, 4, (11,), seed=50) for r in range(4)]
    for r, seen in enumerate(ranks):
        np.testing.assert_array_equal(seen[("ps", "bcast")],
                                      jx[("ps", "bcast")][r])
        want = sum(ys[i] for i in SET) if r in SET else ys[r]
        np.testing.assert_allclose(seen[("ps", "grouped")][1], want,
                                   rtol=1e-6)


def test_process_set_negative_cases(worlds):
    ranks, _ = worlds[4]
    for seen in ranks:
        errs = seen[("ps", "errors")]
        assert [e and e[0] for e in errs] == ["ValueError"] * 5, errs
        assert "not in" in errs[0][1]
        assert "exceeds world size" in errs[4][1]


def test_process_set_validation():
    with pytest.raises(ValueError, match="duplicate"):
        C.ProcessSet([0, 0])
    with pytest.raises(ValueError, match="at least one"):
        C.ProcessSet([])
    with pytest.raises(ValueError, match="negative"):
        C.ProcessSet([-1, 0])
    ps = C.ProcessSet([3, 1])
    assert ps.ranks == (1, 3) and ps.size() == 2
    assert ps.rank_of(3) == 1 and ps.rank_of(0) == -1
    assert ps.included(1) and not ps.included(2)


@pytest.mark.parametrize("world", WORLDS)
def test_broadcast_matches_jax(worlds, world):
    ranks, jx = worlds[world]
    for r, seen in enumerate(ranks):
        np.testing.assert_array_equal(seen["bcast"], jx["bcast"][r])
        np.testing.assert_array_equal(seen["bcast_bool"], jx["bcast_bool"][r])
        assert seen["bcast_bool"].dtype == np.bool_


@pytest.mark.parametrize("world", WORLDS)
def test_ragged_allgather(worlds, world):
    """Ranks disagree on dim 0: rank r gives r+1 rows (the reference's
    unequal-first-dim allgather)."""
    ranks, _ = worlds[world]
    want = np.concatenate([np.full((r + 1, 3), float(r), np.float32)
                           for r in range(world)])
    want_int = np.concatenate([np.arange(r + 2) for r in range(world)])
    want_bool = np.concatenate([[r % 2 == 0] * (r + 1) for r in range(world)])
    for seen in ranks:
        np.testing.assert_array_equal(seen["gather"], want)
        np.testing.assert_array_equal(seen["gather_int"], want_int)
        np.testing.assert_array_equal(seen["gather_bool"], want_bool)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("axes", ALLTOALL_AXES)
def test_alltoall_matches_jax(worlds, world, axes):
    ranks, jx = worlds[world]
    for r, seen in enumerate(ranks):
        np.testing.assert_array_equal(seen[("a2a", *axes)],
                                      jx[("a2a", *axes)][r])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("op", ["rs_sum", "rs_avg"])
def test_reducescatter_matches_jax(worlds, world, op):
    ranks, jx = worlds[world]
    for r, seen in enumerate(ranks):
        assert seen[op].shape == (2, 3)
        np.testing.assert_allclose(seen[op], jx[op][r], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_object_collectives(worlds, world):
    ranks, _ = worlds[world]
    for seen in ranks:
        assert seen["barrier"] is True
        assert seen["bcast_obj"] == {"from": world - 1,
                                     "s": "x" * (world - 1)}
        assert seen["gather_obj"] == [("r", r, list(range(r)))
                                      for r in range(world)]


@pytest.mark.parametrize("world", WORLDS)
def test_negative_cases_raise_on_every_rank(worlds, world):
    ranks, _ = worlds[world]
    for seen in ranks:
        errs = seen["errors"]
        assert [e and e[0] for e in errs] == ["ValueError"] * len(errs), errs
        assert "beyond dim 0" in errs[0][1]
        assert "dtype" in errs[1][1]
        assert "wire-format" in errs[4][1]
        np.testing.assert_array_equal(seen["after_errors"], [1.0, 1.0])


def test_world_of_one_identities(monkeypatch):
    """A world of one: Adasum returns its input, the object collectives
    return ``obj`` and ``[obj]``, the others are identities."""
    for var in ("HOROVOD_TPU_PROCESS_ID", "HOROVOD_TPU_NUM_PROCESSES",
                "HOROVOD_TPU_COORDINATOR", "RANK", "WORLD_SIZE",
                "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    basics.init("cpu")
    try:
        x = torch.from_numpy(_x(0, 1))
        assert torch.equal(C.allreduce(x, op=C.Adasum), x)
        assert torch.equal(C.adasum_allreduce(x), x)
        assert torch.equal(C.allgather(x), x)
        assert torch.equal(C.alltoall(x, split_axis=1, concat_axis=0), x)
        assert torch.equal(C.reducescatter(x, op=C.Average), x)
        C.barrier()
        obj = {"a": [1, 2]}
        assert broadcast_object(obj) is obj
        assert allgather_object(obj) == [obj]
    finally:
        basics.shutdown()


def test_package_exports_the_reduction_surface():
    """``horovod_tpu_torch`` exports what ``horovod_tpu`` exports for this
    surface, under the same names."""
    import horovod_tpu as hvd

    import horovod_tpu_torch as port

    names = ("Adasum", "ProcessSet", "allgather", "alltoall",
             "reducescatter", "barrier", "ErrorFeedback",
             "PowerSGDCompressor", "broadcast_object", "allgather_object",
             "save_checkpoint", "wait_for_checkpoints", "list_checkpoints",
             "latest_checkpoint", "restore_checkpoint", "load_model",
             "ModelCheckpointCallback", "DistributedOptimizer",
             "Compression")
    for name in names:
        assert hasattr(hvd, name) and hasattr(port, name), name
        assert name in port.__all__
