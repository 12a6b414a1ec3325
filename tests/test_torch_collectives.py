"""The port's process model, collectives and fusion on a 2-rank gloo world.

Two CPU processes under ``torch.multiprocessing.spawn`` rendezvous through
the JAX launcher's variables (``HOROVOD_TPU_COORDINATOR`` and friends), run
every collective once (module-scoped: one spawn for the file) and write
what they saw; the tests hold that against values computed here from the
same seeded numpy inputs.  ``plan_buckets`` is held *equal* to the JAX
package's for the same shapes and dtypes.  The workers import only torch
and the port; JAX is imported in the tests that compare with it.
"""

from __future__ import annotations

import os
import pickle
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from horovod_tpu_torch import basics
from horovod_tpu_torch.ops import collective_ops as C
from horovod_tpu_torch.ops import fusion
from horovod_tpu_torch.ops.compression import Compression

WORLD = 2
COMPRESSIONS = {"none": Compression.none, "fp16": Compression.fp16,
                "bf16": Compression.bf16}
OPS = {"Sum": C.Sum, "Average": C.Average, "Min": C.Min, "Max": C.Max,
       "Product": C.Product}
# Mixed dtypes and sizes: with a 64-byte threshold they fall into several
# buckets (f32 runs split by size, the f64 tensor alone).
GROUP_SHAPES = [((3,), np.float32), ((4, 2), np.float32), ((5,), np.float32),
                ((2,), np.float64), ((7,), np.float32), ((1,), np.float32)]
LAUNCH_VARS = ("HOROVOD_TPU_PROCESS_ID", "HOROVOD_TPU_NUM_PROCESSES",
               "HOROVOD_TPU_COORDINATOR", "HOROVOD_TPU_LOCAL_RANK",
               "HOROVOD_TPU_LOCAL_SIZE", "RANK", "WORLD_SIZE", "MASTER_ADDR",
               "MASTER_PORT", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_input(rank: int, shape=(6,), dtype=np.float32, seed=0):
    rng = np.random.RandomState(seed + rank)
    return (rng.randn(*shape) + 1.5).astype(dtype)


def _worker(rank: int, port: int, out_dir: str) -> None:
    os.environ.update(
        HOROVOD_TPU_PROCESS_ID=str(rank), HOROVOD_TPU_NUM_PROCESSES=str(WORLD),
        HOROVOD_TPU_COORDINATOR=f"127.0.0.1:{port}",
        HOROVOD_TPU_LOCAL_RANK=str(rank), HOROVOD_TPU_LOCAL_SIZE=str(WORLD))
    seen = {}
    try:
        basics.size()
    except basics.NotInitializedError:
        seen["not_initialized_raised"] = True
    basics.init("cpu")
    seen["ids"] = (basics.rank(), basics.size(), basics.local_rank(),
                   basics.local_size())
    x = torch.from_numpy(_rank_input(rank))
    for oname, op in OPS.items():
        seen[("allreduce", oname, "none")] = C.allreduce(x, op=op).numpy()
    for cname, comp in COMPRESSIONS.items():
        for oname in ("Sum", "Average"):
            seen[("allreduce", oname, cname)] = C.allreduce(
                x, op=OPS[oname], compression=comp).numpy()
    seen["average_flag"] = C.allreduce(x, average=True).numpy()
    seen["input_untouched"] = x.numpy().copy()
    group = [torch.from_numpy(_rank_input(rank, s, dt, seed=10 + i))
             for i, (s, dt) in enumerate(GROUP_SHAPES)]
    for cname, comp in COMPRESSIONS.items():
        out = C.grouped_allreduce(group, op=C.Average, compression=comp,
                                  fusion_threshold_bytes=64)
        seen[("grouped", cname)] = [t.numpy() for t in out]
    inplace = [t.clone() for t in group]
    C.grouped_allreduce_(inplace, op=C.Sum, fusion_threshold_bytes=64)
    seen["grouped_inplace"] = [t.numpy() for t in inplace]
    seen["broadcast"] = C.broadcast(x, root_rank=1).numpy()
    seen["adasum"] = C.allreduce(x, op=C.Adasum).numpy()
    for name, call in (("bad_op", lambda: C.allreduce(x, op=object())),
                       ("bad_root", lambda: C.broadcast(x, root_rank=2))):
        try:
            call()
        except (NotImplementedError, ValueError) as e:
            seen[name] = (type(e).__name__, str(e))
    basics.shutdown()
    seen["after_shutdown"] = basics.is_initialized()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(seen, f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("collectives")
    mp.spawn(_worker, args=(_free_port(), str(out)), nprocs=WORLD, join=True)
    result = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            result.append(pickle.load(f))
    return result


def _cast(a, dtype):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _expected(op, comp, xs):
    """The reduction of the per-rank inputs as the wire sees them."""
    if op in ("Min", "Max", "Product"):
        fn = {"Min": np.minimum, "Max": np.maximum, "Product": np.multiply}[op]
        return fn(xs[0], xs[1])
    wire = {"none": None, "fp16": torch.float16, "bf16": torch.bfloat16}[comp]
    if wire is None:
        total = xs[0] + xs[1]
        return total / WORLD if op == "Average" else total
    total = _cast(xs[0], wire) + _cast(xs[1], wire)
    if op == "Average":
        total = total / WORLD
    return total.to(torch.from_numpy(xs[0]).dtype).numpy()


def test_ids_and_lifecycle(ranks):
    for r, seen in enumerate(ranks):
        assert seen["ids"] == (r, WORLD, r, WORLD)
        assert seen["not_initialized_raised"]
        assert seen["after_shutdown"] is False


@pytest.mark.parametrize("op", list(OPS))
def test_allreduce_ops(ranks, op):
    xs = [_rank_input(r) for r in range(WORLD)]
    want = _expected(op, "none", xs)
    for seen in ranks:
        np.testing.assert_allclose(seen[("allreduce", op, "none")], want,
                                   rtol=1e-6)


@pytest.mark.parametrize("comp", list(COMPRESSIONS))
@pytest.mark.parametrize("op", ["Sum", "Average"])
def test_allreduce_with_compression(ranks, op, comp):
    """fp16/bf16 cast each rank's tensor, reduce in the wire dtype and cast
    back: exact against the same casts done here."""
    xs = [_rank_input(r) for r in range(WORLD)]
    want = _expected(op, comp, xs)
    for seen in ranks:
        got = seen[("allreduce", op, comp)]
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_average_flag_and_out_of_place(ranks):
    xs = [_rank_input(r) for r in range(WORLD)]
    for r, seen in enumerate(ranks):
        np.testing.assert_allclose(seen["average_flag"], (xs[0] + xs[1]) / 2,
                                   rtol=1e-6)
        np.testing.assert_array_equal(seen["input_untouched"], xs[r])


@pytest.mark.parametrize("comp", list(COMPRESSIONS))
def test_grouped_allreduce_several_buckets(ranks, comp):
    plans = fusion.plan_buckets(
        [torch.zeros(s, dtype=getattr(torch, np.dtype(d).name))
         for s, d in GROUP_SHAPES], 64)
    assert len(plans) >= 3            # the threshold really splits the group
    for i, (shape, dt) in enumerate(GROUP_SHAPES):
        xs = [_rank_input(r, shape, dt, seed=10 + i) for r in range(WORLD)]
        want = _expected("Average", comp, xs)
        for seen in ranks:
            got = seen[("grouped", comp)][i]
            assert got.shape == shape and got.dtype == dt
            np.testing.assert_allclose(got, want, rtol=1e-6)


def test_grouped_allreduce_in_place(ranks):
    for i, (shape, dt) in enumerate(GROUP_SHAPES):
        xs = [_rank_input(r, shape, dt, seed=10 + i) for r in range(WORLD)]
        for seen in ranks:
            np.testing.assert_allclose(seen["grouped_inplace"][i],
                                       xs[0] + xs[1], rtol=1e-6)


def test_broadcast_from_root_one(ranks):
    for seen in ranks:
        np.testing.assert_array_equal(seen["broadcast"], _rank_input(1))


def test_negative_cases_raise(ranks):
    """Unknown ops and roots raise; Adasum, refused by earlier slices, now
    combines the two ranks' tensors (held against JAX in
    test_torch_collectives_more.py, here against its formula)."""
    a, b = (_rank_input(r).astype(np.float64) for r in range(WORLD))
    dot = a @ b
    want = (1 - dot / (2 * a @ a)) * a + (1 - dot / (2 * b @ b)) * b
    for seen in ranks:
        np.testing.assert_allclose(seen["adasum"], want, rtol=1e-5)
        assert seen["bad_op"][0] == "ValueError"
        assert seen["bad_root"][0] == "ValueError"


def test_world_of_one_without_launcher_env(monkeypatch):
    """No launcher variables: ``init`` makes a world of one on an in-process
    store, and collectives are the identity."""
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(basics.NotInitializedError):
        basics.rank()
    basics.init("cpu")
    try:
        assert (basics.rank(), basics.size(), basics.local_rank(),
                basics.local_size()) == (0, 1, 0, 1)
        x = torch.arange(4.0)
        np.testing.assert_array_equal(C.allreduce(x, average=True).numpy(),
                                      x.numpy())
        np.testing.assert_array_equal(C.broadcast(x, 0).numpy(), x.numpy())
    finally:
        basics.shutdown()
    assert not basics.is_initialized()


def test_fusion_threshold_env_knob(monkeypatch):
    from horovod_tpu_torch.utils import env

    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "1234")
    assert env.EngineConfig.from_env().fusion_threshold_bytes == 1234
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "junk")
    assert (env.EngineConfig.from_env().fusion_threshold_bytes
            == env.DEFAULT_FUSION_THRESHOLD_BYTES == 64 * 1024 * 1024)


@pytest.mark.parametrize("threshold", [0, None, 1, 24, 64, 100, 1 << 20])
def test_plan_buckets_equal_to_jax(threshold):
    """The planner is a pure function: equal plans for the same sizes and
    dtypes, threshold 0 (fusion off) and None (the 64 MiB default)
    included."""
    import jax.numpy as jnp

    from horovod_tpu.ops import fusion as jfusion

    specs = [((3,), "float32"), ((4, 2), "float32"), ((5,), "float32"),
             ((2,), "int32"), ((2,), "int32"), ((7,), "float32"),
             ((6,), "bfloat16"), ((3,), "float16"), ((1,), "float32"),
             ((16,), "float32")]
    jt = [jnp.zeros(s, getattr(jnp, d)) for s, d in specs]
    tt = [torch.zeros(s, dtype=getattr(torch, d)) for s, d in specs]
    assert (fusion.plan_buckets(tt, threshold)
            == jfusion.plan_buckets(jt, threshold))
