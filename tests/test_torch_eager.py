"""The port's eager engine and Horovod frontend against the JAX eager engine,
on a 4-rank gloo world coordinated in Python (no native controller).

The JAX side is its eager engine under a single controller on 4 virtual
CPU devices, fed rank-major arrays (row r = rank r's tensor); the port
runs one process a rank, each with its own tensor, through
``horovod_tpu_torch.ops.eager`` and ``horovod_tpu_torch.torch_frontend``.
Inputs are seeded numpy.  Mirrors ``tests/test_allreduce.py``,
``tests/test_allgather_broadcast.py``, ``tests/test_spmd_ops.py`` and
``tests/test_process_set.py`` at the eager surface.

Tolerances: f32 sums differ by summation order only, within 1e-6 of
Σ_r |x_r| elementwise (4 ranks round at most 3 partial sums, each within
2⁻²⁴ of Σ|x|); fp16 and bf16 wires within two of their ulps of Σ|x| (gloo
rounds after each add, XLA once: 2⁻⁹ and 2⁻⁶ of Σ|x|); what passes
through exact arithmetic (Min, Max, Product of powers of two, broadcast,
gathers, all-to-all, int64 sums) bit for bit.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from torch_gloo_world import start_world

WORLD = 4
SHAPE = (5, 7)
OPS = ("Sum", "Average", "Min", "Max", "Product")
SET = (0, 2, 3)
PS_OPS = ("Sum", "Average", "Min", "Max")
# S[r][j]: rows rank r sends to rank j (an uneven all-to-all).
SPLITS = [[1, 0, 2, 3], [0, 2, 1, 1], [3, 1, 0, 0], [2, 2, 2, 2]]
RAGGED = [1, 3, 0, 2]           # allgather: each rank's dim 0
TOPK = 6
F32_RTOL = 1e-6
FP16_RTOL = 2 ** -9
BF16_RTOL = 2 ** -6
ENV = {"HVD_TORCH_NATIVE_CONTROLLER": "off"}


def _x(rank, shape=SHAPE, seed=0):
    rng = np.random.RandomState(seed + 100 * rank)
    return rng.randn(*shape).astype(np.float32)


def _pow2(rank):
    """Powers of two with signs: their product is exact in f32."""
    rng = np.random.RandomState(7 + rank)
    return (np.exp2(rng.randint(-3, 4, SHAPE)) * rng.choice([-1, 1], SHAPE)
            ).astype(np.float32)


def _rows(rank, n):
    return (np.arange(n * 3, dtype=np.float32).reshape(n, 3) + 100 * rank)


def _raises(call):
    try:
        call()
    except Exception as e:      # recorded and held by the tests
        return type(e).__name__, str(e)
    return None


def _worker(rank, world):
    from horovod_tpu_torch import torch_frontend as F
    from horovod_tpu_torch.ops import eager as E
    from horovod_tpu_torch.ops import collective_ops as C
    from horovod_tpu_torch.ops.compression import Compression

    seen = {}
    x = torch.from_numpy(_x(rank))
    handles = {op: E.allreduce_async(x, name=f"ar.{op}", op=getattr(C, op))
               for op in OPS}
    for op, h in handles.items():
        seen[("ar", op)] = E.synchronize(h).numpy()
    seen["prod_pow2"] = E.allreduce(torch.from_numpy(_pow2(rank)),
                                    op=C.Product).numpy()
    for comp in ("fp16", "bf16"):
        seen[("ar", comp)] = E.allreduce(
            x, average=True, compression=getattr(Compression, comp)).numpy()
    big = torch.tensor([2 ** 40 + rank, -(2 ** 35) * rank, 7],
                       dtype=torch.int64)
    seen["int64"] = E.allreduce(big, op=C.Sum).numpy()
    ys = [torch.from_numpy(_x(rank, (11,), seed=1)),
          torch.from_numpy(_x(rank, (3, 2), seed=2))]
    seen["grouped"] = [t.numpy() for t in
                       E.grouped_allreduce_eager([x, *ys], average=True)]
    seen["gather"] = E.allgather(torch.from_numpy(_rows(rank, RAGGED[rank]))
                                 ).numpy()
    seen["gather_int"] = E.allgather(torch.arange(rank + 1)).numpy()
    seen["bcast"] = E.broadcast(x, 2).numpy()
    a2a = torch.from_numpy(_rows(rank, 2 * world))
    seen["a2a"] = E.alltoall(a2a).numpy()
    uneven = torch.from_numpy(_rows(rank, sum(SPLITS[rank])))
    seen["a2a_uneven"] = E.alltoall(uneven, splits=SPLITS[rank]).numpy()
    rs = torch.from_numpy(_x(rank, (2 * world, 3), seed=3))
    seen["rs_sum"] = E.reducescatter(rs, op=C.Sum).numpy()
    seen["rs_avg"] = E.reducescatter(rs).numpy()
    sp = torch.from_numpy(_x(rank, (40,), seed=4))
    seen["sparse"] = E.sparse_allreduce(sp, k=TOPK).numpy()
    seen["sparse_avg"] = E.sparse_allreduce(sp, k=TOPK, average=True).numpy()
    ps = C.ProcessSet(SET)
    for op in PS_OPS:
        seen[("ps", op)] = E.allreduce(x, op=getattr(C, op),
                                       process_set=ps).numpy()
    seen[("ps", "bcast")] = E.broadcast(x, 2, process_set=ps).numpy()
    seen[("ps", "gather")] = E.allgather(x, process_set=ps).numpy()

    # The frontend, Horovod's own spelling.
    y = x.clone()
    h = F.allreduce_async_(y, name="fe.inplace")
    while not F.poll(h):
        time.sleep(0.001)
    assert F.synchronize(h) is y
    seen["fe_inplace"] = y.numpy()
    seen["fe_sum"] = F.allreduce(x, average=False).numpy()
    z = x.clone()
    F.broadcast_(z, 1)
    seen["fe_bcast_"] = z.numpy()
    seen["fe_grouped_gather"] = [t.numpy() for t in F.grouped_allgather(
        [torch.from_numpy(_rows(rank, RAGGED[rank])), x])]
    seen["fe_grouped_rs"] = [t.numpy() for t in F.grouped_reducescatter(
        [rs, rs * 2], op=C.Sum)]
    seen["fe_grouped_ar"] = [t.numpy() for t in F.grouped_allreduce(
        [x, *ys])]
    seen["fe_a2a"] = F.alltoall(uneven, splits=SPLITS[rank]).numpy()
    seen["fe_sparse"] = F.sparse_allreduce(sp, k=TOPK).numpy()
    F.barrier()

    # Refusals raise on every rank, and the engine goes on after them.
    seen["errors"] = [_raises(c) for c in (
        lambda: E.allgather(torch.zeros(2, 3 + rank)),
        lambda: E.allgather(torch.zeros(2, dtype=torch.float32 if rank
                                        else torch.float64)),
        lambda: E.alltoall(torch.zeros(4), splits=[4 - rank, rank, 0, 0]
                           if rank != 1 else [1, 1, 1, 0]),
        lambda: E.reducescatter(rs, op=C.Min),
        lambda: E.broadcast(x, world))]
    seen["after_errors"] = E.allreduce(torch.ones(2), average=True).numpy()
    seen["stats"] = E.engine_stats()
    return seen


def _jax_side():
    import jax
    import jax.numpy as jnp

    import horovod_tpu as hvd

    def rm(fn):
        return hvd.from_per_rank([fn(r) for r in range(WORLD)])

    def host(a):
        return np.asarray(jax.device_get(a))

    out = {}
    xs = rm(_x)
    for op in OPS:
        out[("ar", op)] = host(hvd.allreduce(xs, op=getattr(hvd, op)))
    out["prod_pow2"] = host(hvd.allreduce(rm(_pow2), op=hvd.Product))
    for comp in ("fp16", "bf16"):
        out[("ar", comp)] = host(hvd.allreduce(
            xs, average=True, compression=getattr(hvd.Compression, comp)))
    out["grouped"] = [host(t) for t in hvd.grouped_allreduce_eager(
        [xs, rm(lambda r: _x(r, (11,), seed=1)),
         rm(lambda r: _x(r, (3, 2), seed=2))], average=True)]
    out["gather"] = host(hvd.allgather([_rows(r, RAGGED[r])
                                        for r in range(WORLD)]))
    out["gather_int"] = host(hvd.allgather(
        [np.arange(r + 1, dtype=np.int32) for r in range(WORLD)]))
    out["bcast"] = host(hvd.broadcast(xs, 2))
    out["a2a"] = host(hvd.alltoall(rm(lambda r: _rows(r, 2 * WORLD))))
    # The uneven all-to-all as the JAX frontend runs it: every chunk
    # padded to the largest, one equal all-to-all, the chunks cut out.
    maxc = max(max(r) for r in SPLITS)

    def padded(r):
        src = _rows(r, sum(SPLITS[r]))
        buf = np.zeros((WORLD * maxc, 3), np.float32)
        off = 0
        for j, c in enumerate(SPLITS[r]):
            buf[j * maxc:j * maxc + c] = src[off:off + c]
            off += c
        return buf

    got = host(hvd.alltoall(rm(padded)))
    out["a2a_uneven"] = [np.concatenate(
        [got[r][s * maxc:s * maxc + SPLITS[s][r]] for s in range(WORLD)])
        for r in range(WORLD)]
    rs = rm(lambda r: _x(r, (2 * WORLD, 3), seed=3))
    out["rs_sum"] = host(hvd.reducescatter(rs, op=hvd.Sum))
    out["rs_avg"] = host(hvd.reducescatter(rs))
    sp = rm(lambda r: _x(r, (40,), seed=4))
    out["sparse"] = host(hvd.sparse_allreduce(sp, k=TOPK))
    out["sparse_avg"] = host(hvd.sparse_allreduce(sp, k=TOPK, average=True))
    ps = hvd.ProcessSet(SET)
    for op in PS_OPS:
        out[("ps", op)] = host(hvd.allreduce(xs, op=getattr(hvd, op),
                                             process_set=ps))
    out[("ps", "bcast")] = host(hvd.broadcast(xs, 2, process_set=ps))
    out[("ps", "gather")] = host(hvd.allgather(
        [_x(r) for r in range(WORLD)], process_set=ps))
    out["xs_abs"] = host(jnp.abs(xs))
    return out


@pytest.fixture(scope="module")
def world():
    import jax

    import horovod_tpu as hvd

    join = start_world(_worker, WORLD, env=ENV)
    hvd.shutdown()
    hvd.init(devices=jax.devices()[:WORLD])
    try:
        jx = _jax_side()
    finally:
        hvd.shutdown()
        hvd.init()
    return join(timeout=120), jx


def _sum_close(got, want, abs_terms, rtol):
    bound = rtol * abs_terms.sum(axis=0) + 1e-30
    assert np.all(np.abs(got - want) <= bound), np.max(np.abs(got - want)
                                                        - bound)


def test_allreduce_ops_match_jax(world):
    ranks, jx = world
    for seen in ranks:
        _sum_close(seen[("ar", "Sum")], jx[("ar", "Sum")], jx["xs_abs"],
                   F32_RTOL)
        _sum_close(seen[("ar", "Average")], jx[("ar", "Average")],
                   jx["xs_abs"] / WORLD, F32_RTOL)
        for op in ("Min", "Max"):
            np.testing.assert_array_equal(seen[("ar", op)], jx[("ar", op)])
        np.testing.assert_allclose(seen[("ar", "Product")],
                                   jx[("ar", "Product")], rtol=F32_RTOL)
        np.testing.assert_array_equal(seen["prod_pow2"], jx["prod_pow2"])
    for seen in ranks[1:]:          # replicated on every rank
        for op in OPS:
            np.testing.assert_array_equal(seen[("ar", op)],
                                          ranks[0][("ar", op)])


@pytest.mark.parametrize("comp,rtol", [("fp16", FP16_RTOL),
                                       ("bf16", BF16_RTOL)])
def test_compressed_allreduce_matches_jax(world, comp, rtol):
    ranks, jx = world
    for seen in ranks:
        got = seen[("ar", comp)]
        assert got.dtype == np.float32
        _sum_close(got, jx[("ar", comp)], jx["xs_abs"] / WORLD, rtol)


def test_int64_sum_is_exact(world):
    ranks, _ = world
    want = sum(np.array([2 ** 40 + r, -(2 ** 35) * r, 7], np.int64)
               for r in range(WORLD))
    for seen in ranks:
        assert seen["int64"].dtype == np.int64
        np.testing.assert_array_equal(seen["int64"], want)


def test_grouped_allreduce_matches_jax(world):
    ranks, jx = world
    abs_terms = [jx["xs_abs"],
                 np.abs(np.stack([_x(r, (11,), seed=1) for r in range(WORLD)])),
                 np.abs(np.stack([_x(r, (3, 2), seed=2)
                                  for r in range(WORLD)]))]
    for seen in ranks:
        for key in ("grouped", "fe_grouped_ar"):
            for got, want, a in zip(seen[key], jx["grouped"], abs_terms):
                _sum_close(got, want, a / WORLD, F32_RTOL)


def test_gathers_broadcast_alltoall_are_bit_equal(world):
    ranks, jx = world
    for r, seen in enumerate(ranks):
        np.testing.assert_array_equal(seen["gather"], jx["gather"])
        np.testing.assert_array_equal(seen["gather_int"], jx["gather_int"])
        assert seen["gather_int"].dtype == np.int64
        np.testing.assert_array_equal(seen["bcast"], jx["bcast"])
        np.testing.assert_array_equal(seen["a2a"], jx["a2a"][r])
        np.testing.assert_array_equal(seen["a2a_uneven"],
                                      jx["a2a_uneven"][r])
        np.testing.assert_array_equal(seen["fe_a2a"], jx["a2a_uneven"][r])
        np.testing.assert_array_equal(seen["fe_bcast_"], _x(1))
        g0, g1 = seen["fe_grouped_gather"]
        np.testing.assert_array_equal(g0, jx["gather"])
        np.testing.assert_array_equal(
            g1, np.concatenate([_x(q) for q in range(WORLD)]))


def test_reducescatter_matches_jax(world):
    ranks, jx = world
    rs_abs = np.abs(np.stack([_x(q, (2 * WORLD, 3), seed=3)
                              for q in range(WORLD)]))
    for r, seen in enumerate(ranks):
        shard = rs_abs[:, 2 * r:2 * r + 2]
        _sum_close(seen["rs_sum"], jx["rs_sum"][r], shard, F32_RTOL)
        _sum_close(seen["rs_avg"], jx["rs_avg"][r], shard / WORLD, F32_RTOL)
        fe_sum, fe_double = seen["fe_grouped_rs"]
        np.testing.assert_array_equal(fe_sum, seen["rs_sum"])
        _sum_close(fe_double, 2 * jx["rs_sum"][r], 2 * shard, F32_RTOL)


def test_sparse_topk_matches_jax(world):
    ranks, jx = world
    terms = np.abs(np.stack([_x(q, (40,), seed=4) for q in range(WORLD)]))
    for seen in ranks:
        _sum_close(seen["sparse"], jx["sparse"], terms, F32_RTOL)
        _sum_close(seen["fe_sparse"], jx["sparse"], terms, F32_RTOL)
        _sum_close(seen["sparse_avg"], jx["sparse_avg"], terms / WORLD,
                   F32_RTOL)
        assert np.count_nonzero(seen["sparse"]) <= WORLD * TOPK


def test_process_set_matches_jax(world):
    ranks, jx = world
    members = np.abs(np.stack([_x(q) for q in SET]))
    for r, seen in enumerate(ranks):
        for op in PS_OPS:
            want = jx[("ps", op)][r]
            if r not in SET or op in ("Min", "Max"):
                np.testing.assert_array_equal(seen[("ps", op)], want)
            else:
                scale = len(SET) if op == "Average" else 1
                _sum_close(seen[("ps", op)], want, members / scale, F32_RTOL)
        np.testing.assert_array_equal(seen[("ps", "bcast")],
                                      jx[("ps", "bcast")][r])
        np.testing.assert_array_equal(seen[("ps", "gather")],
                                      jx[("ps", "gather")])


def test_frontend_inplace_async_and_sum(world):
    ranks, jx = world
    for seen in ranks:
        _sum_close(seen["fe_inplace"], jx[("ar", "Average")],
                   jx["xs_abs"] / WORLD, F32_RTOL)
        np.testing.assert_array_equal(seen["fe_sum"], ranks[0]["fe_sum"])
        _sum_close(seen["fe_sum"], jx[("ar", "Sum")], jx["xs_abs"], F32_RTOL)


def test_refusals_raise_on_every_rank(world):
    ranks, _ = world
    kinds = [[e and e[0] for e in seen["errors"]] for seen in ranks]
    assert all(k == ["ValueError"] * 5 for k in kinds), kinds
    assert "trailing" in ranks[0]["errors"][0][1]
    assert "dtype" in ranks[0]["errors"][1][1]
    assert "splits sum" in ranks[0]["errors"][2][1]
    for seen in ranks:
        np.testing.assert_array_equal(seen["after_errors"], [1.0, 1.0])


def test_engine_stats_count_the_traffic(world):
    ranks, _ = world
    for seen in ranks:
        st = seen["stats"]
        assert st["errors"] == 0 and st["stall_warnings"] == 0
        assert st["ops_enqueued"] >= 40
        # Without a controller, only the caller-delimited groups fuse.
        assert st["tensors_fused"] == 6
        assert st["allreduce_bytes"] > 0


def test_idle_engine_cycle_sleeps_until_an_enqueue(monkeypatch):
    """Without a controller the cycle thread flushes only after an enqueue:
    an idle engine takes no ticks (and so no GIL) from the training loop."""
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.ops import eager as E

    monkeypatch.setenv("HOROVOD_CYCLE_TIME", "1")
    monkeypatch.setenv("HVD_TORCH_NATIVE_CONTROLLER", "off")
    basics.init("cpu")
    try:
        x = torch.arange(6.0)
        assert torch.equal(E.allreduce(x, name="idle.warm"), x)
        eng = E._engine()
        flushes = []
        flush = eng.flush
        monkeypatch.setattr(eng, "flush", lambda: (flushes.append(1),
                                                   flush())[1])
        time.sleep(0.05)            # a tick may be in flight: at most one
        idle = len(flushes)
        time.sleep(0.2)             # 200 cycles of 1 ms
        assert len(flushes) == idle <= 1
        h = E.allreduce_async(x, name="idle.wake")
        deadline = time.monotonic() + 10
        while not flushes[idle:] and time.monotonic() < deadline:
            time.sleep(1e-3)
        assert len(flushes) > idle      # the cycle thread woke up
        assert torch.equal(E.synchronize(h), x)
    finally:
        basics.shutdown()
