"""The native coordination engine through the port's own loader, and the
port's eager engine negotiating through it on a 4-rank gloo world.

Part one mirrors ``tests/test_native_controller.py:76-261`` (and its
``set_tuned`` case) on :mod:`horovod_tpu_torch.native`: N threads, each a
rank's controller over the in-process transport (or TCP), the single-host
analogue of ``mpirun -np N``.  Part two runs the eager engine with
``HVD_TORCH_NATIVE_CONTROLLER=on`` over a TCP control plane: ranks enqueue
the same names in different orders and get the same results and the same
batches; a shape mismatch raises on every rank; an op one rank never
enqueues ends in the stall report and ``stall_warnings``, not a hang; and
``join`` with uneven step counts matches the JAX eager engine's allreduce
of the same inputs with zeros for the joined ranks.  Every world and thread
has a timeout.
"""

from __future__ import annotations

import threading
import time
import uuid

import numpy as np
import pytest
import torch

from horovod_tpu_torch import native
from torch_gloo_world import free_port, start_world

AR = native.KIND_ALLREDUCE
AG = native.KIND_ALLGATHER
BC = native.KIND_BROADCAST
WORLD = 4
ORDER_NAMES = [f"ord.{c}" for c in "abcde"]
JOIN_STEPS = [1, 2, 3, 4]       # rank r runs JOIN_STEPS[r] steps, then joins
# f32 sums of 4 ranks differ by summation order only (see test_torch_eager).
F32_RTOL = 1e-6


def run_ranks(size, body, *, transport=None, threshold=1 << 20, stall_s=60.0):
    """One thread a rank, each with its own controller; the per-rank
    results of ``body(rank, controller)``."""
    spec = transport or f"local:{uuid.uuid4().hex}"
    results = [None] * size
    errors = []

    def runner(rank):
        try:
            ctrl = native.NativeController(
                rank=rank, size=size, transport_spec=spec,
                fusion_threshold_bytes=threshold, stall_warning_s=stall_s)
            try:
                results[rank] = body(rank, ctrl)
            finally:
                ctrl.close()
        except Exception as e:  # pragma: no cover - surfaced via errors
            errors.append((rank, e))

    threads = [threading.Thread(target=runner, args=(r,)) for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "rank thread hung (negotiation deadlock)"
    assert not errors, f"rank errors: {errors}"
    return results


def drain(ctrl, n_names):
    """Tick until ``n_names`` names have been batched; the batches."""
    out, got = [], 0
    while got < n_names:
        for b in ctrl.tick().batches:
            out.append(b)
            got += len(b.names)
    return out


def test_agreement_and_fusion_across_ranks():
    def body(rank, ctrl):
        names = ["gr.a", "gr.b", "gr.c"]
        for n in names[rank % 3:] + names[:rank % 3]:
            ctrl.submit(AR, "float32", n, (8, 4))
        return drain(ctrl, 3)

    results = run_ranks(4, body)
    assert len(results[0]) == 1
    assert sorted(results[0][0].names) == ["gr.a", "gr.b", "gr.c"]
    for r in range(1, 4):
        assert [b.names for b in results[r]] == [b.names for b in results[0]]


def test_fusion_respects_threshold_and_dtype():
    def body(rank, ctrl):
        ctrl.submit(AR, "float32", "t.f32a", (100,))   # 400 B
        ctrl.submit(AR, "float32", "t.f32b", (100,))   # 400 B: splits
        ctrl.submit(AR, "bfloat16", "t.bf16", (100,))  # another dtype
        return drain(ctrl, 3)

    assert [len(b.names) for b in run_ranks(2, body, threshold=600)[0]] == [
        1, 1, 1]

    def body2(rank, ctrl):
        ctrl.submit(AR, "float32", "u.a", (10,))
        ctrl.submit(AR, "float32", "u.b", (10,))
        ctrl.submit(AR, "bfloat16", "u.c", (10,))
        return drain(ctrl, 3)

    batches = run_ranks(2, body2)[0]
    assert [sorted(b.names) for b in batches] == [["u.a", "u.b"], ["u.c"]]


def test_fusion_respects_group():
    def body(rank, ctrl):
        ctrl.submit(AR, "float32", "g.sum", (4,), group=0)
        ctrl.submit(AR, "float32", "g.min", (4,), group=1)
        return drain(ctrl, 2)

    assert [b.names for b in run_ranks(2, body)[0]] == [["g.sum"], ["g.min"]]


@pytest.mark.parametrize("kind,a,b,dtypes,match", [
    (AR, (4,), (8,), ("float32", "float32"),
     "Mismatched allreduce tensor shapes"),
    (AR, (4,), (4,), ("float32", "int32"), "Mismatched tensor dtypes"),
])
def test_mismatch_is_error_on_all_ranks(kind, a, b, dtypes, match):
    def body(rank, ctrl):
        ctrl.submit(kind, dtypes[rank % 2], "bad", a if rank % 2 == 0 else b)
        return drain(ctrl, 1)

    for batches in run_ranks(2, body):
        assert match in batches[0].error


def test_ragged_allgather_allowed_but_trailing_dims_checked():
    def body(rank, ctrl):
        ctrl.submit(AG, "float32", "ag.ok", (rank + 1, 7))
        ctrl.submit(AG, "float32", "ag.bad", (2, rank + 3))
        return drain(ctrl, 2)

    for batches in run_ranks(2, body):
        by_name = {b.names[0]: b for b in batches}
        assert by_name["ag.ok"].error == ""
        assert "trailing dims" in by_name["ag.bad"].error


def test_broadcast_root_mismatch_is_error():
    def body(rank, ctrl):
        ctrl.submit(BC, "float32", "bc.bad", (4,), root_rank=rank)
        return drain(ctrl, 1)

    for batches in run_ranks(2, body):
        assert "root_rank" in batches[0].error


def test_duplicate_submit_does_not_release_early():
    def body(rank, ctrl):
        ctrl.submit(AR, "float32", "dup.x", (4,))
        if rank == 0:
            ctrl.submit(AR, "float32", "dup.x", (4,))
        got = list(ctrl.tick().batches)
        while not got:
            got = list(ctrl.tick().batches)
        return got

    for batches in run_ranks(2, body):
        assert "Duplicate tensor name" in batches[0].error


def test_uint32_and_bad_dtype():
    def body(rank, ctrl):
        ctrl.submit(AR, "uint32", "u32.x", (4,))
        return drain(ctrl, 1)

    assert run_ranks(2, body)[0][0].error == ""
    ctrl = native.NativeController(0, 1, f"local:{uuid.uuid4().hex}", 1 << 20)
    try:
        with pytest.raises(ValueError, match="not supported"):
            ctrl.submit(AR, "complex64", "c", (2,))
    finally:
        ctrl.close()


def test_tick_trace_records_per_rank_arrivals():
    def body(rank, ctrl):
        if rank == 0:
            ctrl.enable_tick_trace()
        ctrl.submit(AR, "float32", "tt.a", (4,))
        drain(ctrl, 1)
        return ctrl.drain_ticks()

    results = run_ranks(3, body)
    assert sorted(r for _, r in results[0]) == [0, 1, 2]
    assert all(n == "tt.a" for n, _ in results[0])
    assert results[1] == [] and results[2] == []


def test_tick_trace_disabled_by_default():
    def body(rank, ctrl):
        ctrl.submit(AR, "float32", "tt.b", (4,))
        drain(ctrl, 1)
        return ctrl.drain_ticks()

    assert run_ranks(2, body) == [[], []]


def test_stall_report_names_missing_ranks():
    def body(rank, ctrl):
        if rank == 0:
            ctrl.submit(AR, "float32", "lonely", (4,))
        ctrl.tick()
        return ctrl.stall_report()

    reports = run_ranks(3, body, stall_s=0.0)
    assert "lonely" in reports[0] and "missing ranks: 1 2" in reports[0]
    assert reports[1] == "" and reports[2] == ""


def test_shutdown_propagates_to_all_ranks():
    def body(rank, ctrl):
        if rank == 1:
            ctrl.request_shutdown()
        return ctrl.tick().shutdown

    assert all(run_ranks(3, body))


def test_tcp_transport_agreement():
    def body(rank, ctrl):
        ctrl.submit(AR, "float32", "tcp.x", (4,))
        ctrl.submit(AR, "float32", "tcp.y", (4,))
        return drain(ctrl, 2)

    results = run_ranks(2, body, transport=f"tcp:127.0.0.1:{free_port()}")
    assert [b.names for b in results[0]] == [b.names for b in results[1]]


def test_transport_failure_raises_not_shutdown():
    """A dead control plane is an error tick, not an empty list or a clean
    shutdown: outstanding handles must fail, not hang."""
    spec = f"tcp:127.0.0.1:{free_port()}"
    closed = threading.Event()
    outcome = {}

    def rank1():
        ctrl = native.NativeController(rank=1, size=2, transport_spec=spec,
                                       fusion_threshold_bytes=1 << 20)
        ctrl.close()
        closed.set()

    def rank0():
        ctrl = native.NativeController(rank=0, size=2, transport_spec=spec,
                                       fusion_threshold_bytes=1 << 20)
        assert closed.wait(30)
        try:
            bl = ctrl.tick()
            outcome["result"] = ("tick", bl.shutdown, len(bl.batches))
        except RuntimeError as e:
            outcome["result"] = ("raised", str(e))
        finally:
            ctrl.close()

    threads = [threading.Thread(target=rank1), threading.Thread(target=rank0)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "transport-failure test hung"
    assert outcome["result"][0] == "raised", outcome


def test_set_tuned_piggyback_and_rebucketing():
    def body(rank, ctrl):
        seen = []
        if rank == 1:
            ctrl.set_tuned(1, 99.0)          # off rank 0: a no-op
        ctrl.submit(AR, "float32", "a", (256,))
        ctrl.submit(AR, "float32", "b", (256,))
        batches = drain(ctrl, 2)
        seen.append(sorted(batches[0].names) if len(batches) == 1 else None)
        if rank == 0:
            ctrl.set_tuned(1, 0.057)
        ctrl.tick()
        ctrl.submit(AR, "float32", "c", (256,))
        ctrl.submit(AR, "float32", "d", (256,))
        seen.append([b.names for b in drain(ctrl, 2)])
        bl = ctrl.tick()
        seen.append((bl.tuned_threshold_bytes, bl.tuned_cycle_ms))
        return seen

    for r in run_ranks(2, body):
        assert r == [["a", "b"], [["c"], ["d"]], (1, 0.057)], r


# ---------------------------------------------------------------------------
# The eager engine over the controller, a 4-rank gloo world.
# ---------------------------------------------------------------------------


def _x(rank, shape=(6, 5), seed=0):
    rng = np.random.RandomState(seed + 100 * rank)
    return rng.randn(*shape).astype(np.float32)


def _engine_worker(rank, world):
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.ops import collective_ops as C
    from horovod_tpu_torch.ops import eager as E

    seen = {}
    eng = E._engine()
    assert eng.controller is not None
    log = []
    tick = eng.controller.tick

    def recording_tick():
        bl = tick()
        log.extend([b.names for b in bl.batches])
        return bl
    eng.controller.tick = recording_tick

    # Each rank enqueues the same names in its own order.
    order = ORDER_NAMES[rank:] + ORDER_NAMES[:rank]
    hs = {n: E.allreduce_async(
        torch.from_numpy(_x(rank, seed=ORDER_NAMES.index(n))), name=n,
        average=True) for n in order}
    seen["ordered"] = {n: E.synchronize(h).numpy() for n, h in hs.items()}
    seen["batches"] = [b for b in log if any(n in ORDER_NAMES for n in b)]

    bad = E.allreduce_async(torch.zeros(4 + rank % 2), name="bad.shape")
    try:
        E.synchronize(bad)
        seen["mismatch"] = None
    except RuntimeError as e:
        seen["mismatch"] = str(e)

    # Ragged gather and a broadcast through negotiation.
    seen["gather"] = E.allgather(torch.full((rank + 1, 2), float(rank))
                                 ).numpy()
    seen["bcast"] = E.broadcast(torch.from_numpy(_x(rank)), 3).numpy()

    # An op only rank 0 enqueues: the stall report, not a hang.
    if rank == 0:
        h = E.allreduce_async(torch.ones(3), name="lonely")
        deadline = time.monotonic() + 20
        while (E.engine_stats()["stall_warnings"] == 0
               and time.monotonic() < deadline):
            time.sleep(0.05)
        seen["stall_warnings"] = E.engine_stats()["stall_warnings"]
        seen["stall_report"] = eng.controller.stall_report()
        E.release(h)
    E.barrier()

    # join with uneven steps: rank r runs JOIN_STEPS[r] steps.
    seen["join_steps"] = [E.allreduce(torch.from_numpy(_x(rank, seed=50 + s)),
                                      name=f"join.{s}", op=C.Sum).numpy()
                          for s in range(JOIN_STEPS[rank])]
    seen["last_joined"] = E.join()
    seen["after_join"] = E.allreduce(torch.ones(2), name="after").numpy()
    seen["world"] = basics.size()
    return seen


@pytest.fixture(scope="module")
def engine_world():
    import jax

    import horovod_tpu as hvd

    env = {"HVD_TORCH_NATIVE_CONTROLLER": "on",
           "HVD_TORCH_CONTROLLER_TRANSPORT": f"tcp:127.0.0.1:{free_port()}",
           "HOROVOD_STALL_CHECK_TIME": "1.0"}
    join = start_world(_engine_worker, WORLD, env=env)
    hvd.shutdown()
    hvd.init(devices=jax.devices()[:WORLD])
    try:
        jx = {}
        for n in ORDER_NAMES:
            i = ORDER_NAMES.index(n)
            jx[n] = np.asarray(hvd.allreduce(hvd.from_per_rank(
                [_x(r, seed=i) for r in range(WORLD)]), average=True))
        jx["join"] = [np.asarray(hvd.allreduce(hvd.from_per_rank(
            [_x(r, seed=50 + s) if JOIN_STEPS[r] > s
             else np.zeros((6, 5), np.float32) for r in range(WORLD)]),
            op=hvd.Sum)) for s in range(max(JOIN_STEPS))]
    finally:
        hvd.shutdown()
        hvd.init()
    return join(timeout=120), jx


def test_different_orders_same_results_and_batches(engine_world):
    ranks, jx = engine_world
    for seen in ranks:
        for n in ORDER_NAMES:
            i = ORDER_NAMES.index(n)
            terms = np.abs(np.stack([_x(r, seed=i) for r in range(WORLD)]))
            bound = F32_RTOL * terms.sum(axis=0) / WORLD
            assert np.all(np.abs(seen["ordered"][n] - jx[n]) <= bound)
            np.testing.assert_array_equal(seen["ordered"][n],
                                          ranks[0]["ordered"][n])
        assert seen["batches"] == ranks[0]["batches"]
    assert sorted(n for b in ranks[0]["batches"] for n in b) == ORDER_NAMES


def test_shape_mismatch_raises_on_every_rank(engine_world):
    ranks, _ = engine_world
    for seen in ranks:
        assert "Mismatched allreduce tensor shapes" in seen["mismatch"]


def test_negotiated_gather_and_broadcast(engine_world):
    ranks, _ = engine_world
    want = np.concatenate([np.full((r + 1, 2), float(r))
                           for r in range(WORLD)])
    for seen in ranks:
        np.testing.assert_array_equal(seen["gather"], want)
        np.testing.assert_array_equal(seen["bcast"], _x(3))


def test_stall_is_reported_not_hung(engine_world):
    ranks, _ = engine_world
    assert ranks[0]["stall_warnings"] >= 1
    assert "lonely (missing ranks: 1 2 3)" in ranks[0]["stall_report"]


def test_join_with_uneven_steps_matches_jax(engine_world):
    ranks, jx = engine_world
    for r, seen in enumerate(ranks):
        assert len(seen["join_steps"]) == JOIN_STEPS[r]
        for s, got in enumerate(seen["join_steps"]):
            terms = np.abs(np.stack([_x(q, seed=50 + s) for q in range(WORLD)
                                     if JOIN_STEPS[q] > s]))
            assert np.all(np.abs(got - jx["join"][s])
                          <= F32_RTOL * terms.sum(axis=0))
        assert seen["last_joined"] == WORLD - 1
        np.testing.assert_array_equal(seen["after_join"], [4.0, 4.0])


@pytest.mark.parametrize("mode", ["auto", "on"])
def test_unloadable_library_is_never_silent(mode, monkeypatch, capsys):
    """A multi-rank engine whose controller library cannot be built: ``on``
    raises, ``auto`` falls back to Python coordination with a warning that
    carries the build error."""
    import types

    from horovod_tpu_torch.ops import eager as E
    from horovod_tpu_torch.utils.env import EngineConfig

    def broken():
        raise native.NativeBuildError("g++: not found")

    monkeypatch.setattr(native, "load_library", broken)
    fake = types.SimpleNamespace(
        size=2, rank=0,
        _warn_python_coordination=E.EagerEngine._warn_python_coordination)
    cfg = EngineConfig(native_controller=mode)
    if mode == "on":
        with pytest.raises(RuntimeError, match="g\\+\\+: not found"):
            E.EagerEngine._maybe_native_controller(fake, cfg)
        return
    assert E.EagerEngine._maybe_native_controller(fake, cfg) is None
    err = capsys.readouterr().err
    assert "Python coordination" in err and "g++: not found" in err
