"""``HOROVOD_HIERARCHICAL_ALLREDUCE`` in the port's eager engine.

A 4-rank gloo world numbered into two nodes of two ranks (local size 2)
reduces fused buckets in two levels: reduce-scatter within the node,
allreduce across the nodes, allgather within the node (reference
operations.cc:1070-1223).  Three oracles: the same ops in a flat 4-rank
world (hierarchical off), the JAX engine's (dcn, ici) dispatch on four of
the eight CPU devices fed the same rank-major numpy inputs (as
``tests/test_fusion_basics.py``'s ``test_hierarchical_allreduce_engine``
sets it up), and exact arithmetic.  A 3-rank world does not factor into
nodes of two: the engine warns, as the JAX engine does, and reduces flat.

Tolerances: integers and every op outside the two-level route are bit
equal to the flat world (the route is the flat one); f32 sums differ by
summation order only, within 1e-6 of Σ_r |x_r| elementwise; the fp16 wire
within two of its ulps (2⁻⁹) of Σ_r |x_r|, as ``test_torch_eager.py``
holds it.
"""

from __future__ import annotations

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from torch_gloo_world import start_world

WORLD = 4
LOCAL = 2
# One fused bucket of mixed sizes, none a multiple of the node size.
SIZES = [(5,), (3, 3), (7,)]
F32_RTOL = 1e-6
FP16_RTOL = 2 ** -9
HIER = {"HVD_TORCH_NATIVE_CONTROLLER": "off",
        "HOROVOD_HIERARCHICAL_ALLREDUCE": "1"}
FLAT = {"HVD_TORCH_NATIVE_CONTROLLER": "off"}
DTYPES = ("float32", "float64", "int32", "int64", "float16", "bfloat16")


def _x(rank, shape, seed=0):
    rng = np.random.RandomState(seed + 100 * rank)
    return rng.randn(*shape).astype(np.float32)


def _ints(rank, shape, seed=0):
    rng = np.random.RandomState(seed + 100 * rank)
    return rng.randint(-1000, 1000, shape).astype(np.int64)


def _bucket(rank, dtype):
    if dtype.startswith("int"):
        return [torch.from_numpy(_ints(rank, s, i)).to(getattr(torch, dtype))
                for i, s in enumerate(SIZES)]
    # halves of whole numbers: exact in every float dtype and every order
    vals = [np.round(_x(rank, s, i) * 8) / 2 for i, s in enumerate(SIZES)]
    if dtype in ("float32", "float64"):
        vals = [_x(rank, s, i) for i, s in enumerate(SIZES)]
    return [torch.from_numpy(v).to(getattr(torch, dtype)) for v in vals]


def _worker(rank, world):
    from horovod_tpu_torch import torch_frontend as F
    from horovod_tpu_torch.ops import collective_ops as C
    from horovod_tpu_torch.ops import eager as E
    from horovod_tpu_torch.ops.compression import Compression

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        eng = E._engine()
    out = {"local": eng.hier_local, "stderr": err.getvalue(),
           "two_level": eng.local_group is not None}
    for dtype in DTYPES:
        for op in ("Sum", "Average"):
            got = E.grouped_allreduce_eager(_bucket(rank, dtype),
                                            op=getattr(C, op))
            out[("bucket", dtype, op)] = [g.float().numpy() for g in got]
    for op in ("Sum", "Average"):
        got = E.grouped_allreduce_eager(
            _bucket(rank, "float32"), op=getattr(C, op),
            compression=Compression.fp16)
        out[("fp16", op)] = [g.numpy() for g in got]
    if world != WORLD:
        return out
    x = torch.from_numpy(_x(rank, (6, 5), seed=9))
    # every other op kind
    for op in ("Min", "Max", "Product", "Adasum"):
        out[("op", op)] = F.allreduce(x, op=getattr(C, op),
                                      name=f"op.{op}").numpy()
    out["int8"] = F.allreduce(x, average=True, name="int8",
                              compression=Compression.int8).numpy()
    ps = C.ProcessSet((0, 2, 3))
    out["ps"] = F.allreduce(x, op=C.Sum, name="ps", process_set=ps).numpy()
    out["sparse"] = F.sparse_allreduce(x.reshape(-1), name="sp",
                                       k=7).numpy()
    out["bcast"] = F.broadcast(x, 2, name="bc").numpy()
    out["gather"] = F.allgather(x[:rank + 1], name="ag").numpy()
    out["a2a"] = F.alltoall(x[:4], name="a2a").numpy()
    out["rs"] = F.reducescatter(torch.from_numpy(_x(rank, (8, 3), 5)),
                                name="rs", op=C.Sum).numpy()
    return out


def _jax_buckets():
    """The JAX engine's two-level dispatch on the same rank-major inputs."""
    import jax

    import horovod_tpu as hvd
    from horovod_tpu.ops import eager as jeager

    def rm(fn):
        return hvd.from_per_rank([fn(r) for r in range(WORLD)])

    saved = {k: os.environ.get(k) for k in
             ("HOROVOD_HIERARCHICAL_ALLREDUCE",
              "HOROVOD_TPU_HIERARCHY_LOCAL_SIZE")}
    os.environ.update(HOROVOD_HIERARCHICAL_ALLREDUCE="1",
                      HOROVOD_TPU_HIERARCHY_LOCAL_SIZE=str(LOCAL))
    hvd.shutdown()
    hvd.init(devices=jax.devices()[:WORLD])
    try:
        assert jeager._engine()._axis == ("dcn", "ici")
        out = {}
        for dtype in ("float32", "int32"):
            ins = [rm(lambda r, i=i: _bucket(r, dtype)[i].numpy())
                   for i in range(len(SIZES))]
            for op in ("Sum", "Average"):
                got = hvd.grouped_allreduce_eager(ins, op=getattr(hvd, op))
                out[(dtype, op)] = [np.asarray(jax.device_get(g))
                                    for g in got]
        for op in ("Sum", "Average"):
            ins = [rm(lambda r, i=i: _bucket(r, "float32")[i].numpy())
                   for i in range(len(SIZES))]
            got = hvd.grouped_allreduce_eager(
                ins, op=getattr(hvd, op), compression=hvd.Compression.fp16)
            out[("fp16", op)] = [np.asarray(jax.device_get(g)) for g in got]
        return out
    finally:
        hvd.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        hvd.init()


@pytest.fixture(scope="module")
def worlds():
    hier = start_world(_worker, WORLD, env=HIER, local_size=LOCAL)
    flat = start_world(_worker, WORLD, env=FLAT, local_size=LOCAL)
    odd = start_world(_worker, 3, env=HIER, local_size=LOCAL)
    jx = _jax_buckets()
    return (hier(timeout=150), flat(timeout=150), odd(timeout=150), jx)


def _abs_sum(dtype, i):
    return sum(np.abs(_bucket(r, dtype)[i].float().numpy())
               for r in range(WORLD))


def _sum_close(got, want, abs_terms, rtol):
    bound = rtol * abs_terms + 1e-30
    assert np.all(np.abs(got - want) <= bound), np.max(np.abs(got - want)
                                                        - bound)


def test_the_engine_builds_node_and_cross_groups(worlds):
    hier, flat, _, _ = worlds
    for seen in hier:
        assert seen["local"] == LOCAL and seen["two_level"]
        assert "ignored" not in seen["stderr"]
    for seen in flat:
        assert not seen["two_level"]


@pytest.mark.parametrize("op", ["Sum", "Average"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_buckets_equal_the_flat_allreduce(worlds, dtype, op):
    hier, flat, _, _ = worlds
    exact = dtype.startswith("int") or dtype in ("float16", "bfloat16")
    for h, f in zip(hier, flat):
        for i, (got, want) in enumerate(zip(h[("bucket", dtype, op)],
                                            f[("bucket", dtype, op)])):
            assert got.shape == SIZES[i]
            if exact:
                np.testing.assert_array_equal(got, want)
            else:
                scale = WORLD if op == "Average" else 1
                _sum_close(got, want, _abs_sum(dtype, i) / scale, F32_RTOL)
    for h in hier[1:]:              # every rank holds the same result
        for a, b in zip(h[("bucket", dtype, op)],
                        hier[0][("bucket", dtype, op)]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("op", ["Sum", "Average"])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_fused_buckets_equal_the_jax_two_level_dispatch(worlds, dtype, op):
    hier, _, _, jx = worlds
    for seen in hier:
        for i, (got, want) in enumerate(zip(seen[("bucket", dtype, op)],
                                            jx[(dtype, op)])):
            want = np.asarray(want).astype(np.float32)
            if dtype == "int32":
                np.testing.assert_array_equal(got, want)
            else:
                scale = WORLD if op == "Average" else 1
                _sum_close(got, want, _abs_sum(dtype, i) / scale, F32_RTOL)


@pytest.mark.parametrize("op", ["Sum", "Average"])
def test_fp16_wire_equals_flat_and_jax(worlds, op):
    hier, flat, _, jx = worlds
    scale = WORLD if op == "Average" else 1
    for h, f in zip(hier, flat):
        for i, (got, want, jwant) in enumerate(zip(
                h[("fp16", op)], f[("fp16", op)], jx[("fp16", op)])):
            assert got.dtype == np.float32
            a = _abs_sum("float32", i) / scale
            _sum_close(got, want, a, FP16_RTOL)
            _sum_close(got, np.asarray(jwant), a, FP16_RTOL)


@pytest.mark.parametrize("key", [("op", "Min"), ("op", "Max"),
                                 ("op", "Product"), ("op", "Adasum"),
                                 "int8", "ps", "sparse", "bcast", "gather",
                                 "a2a", "rs"])
def test_other_op_kinds_equal_the_flat_world(worlds, key):
    """The JAX engine runs these over the (dcn, ici) mesh too, where their
    results equal the flat ones; the port keeps them on the flat route."""
    hier, flat, _, _ = worlds
    for h, f in zip(hier, flat):
        np.testing.assert_array_equal(h[key], f[key])


def test_a_world_that_does_not_factor_warns_and_goes_flat(worlds):
    _, _, odd, _ = worlds
    for seen in odd:
        assert not seen["two_level"] and seen["local"] == 1
        assert ("WARNING: HOROVOD_HIERARCHICAL_ALLREDUCE=1 ignored"
                in seen["stderr"])
        assert "world of 3 ranks" in seen["stderr"]
    want = sum(_bucket(r, "int64")[0].numpy() for r in range(3))
    for seen in odd:
        np.testing.assert_array_equal(seen[("bucket", "int64", "Sum")][0],
                                      want.astype(np.float32))


def test_hierarchical_knob_no_longer_raises_in_a_world_of_one(monkeypatch):
    """A world of one (one card) does not factor: the engine warns and
    reduces exactly as the flat route does."""
    from horovod_tpu_torch import basics
    from horovod_tpu_torch import torch_frontend as F
    from horovod_tpu_torch.ops import eager as E

    monkeypatch.setenv("HOROVOD_HIERARCHICAL_ALLREDUCE", "1")
    basics.init("cpu")
    try:
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            x = torch.arange(5.0)
            out = F.allreduce(x, average=False, name="one")
        assert "ignored" in err.getvalue()
        assert E._engine().local_group is None
        np.testing.assert_array_equal(out.numpy(), x.numpy())
    finally:
        basics.shutdown()
