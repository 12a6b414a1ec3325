"""The port's stateful compressors against the JAX package's, 2 ranks.

``ErrorFeedback`` around top-k, int8 and int4, and ``PowerSGDCompressor``,
each for three steps of ``reduce`` on a small gradient tree: the JAX
package under ``shard_map`` on two CPU devices, the port on a 2-process
gloo world, on the same per-rank gradients from seeded numpy.  Each step
of the port starts from the JAX state that step started from, carried
over by ``compression_state_from_jax`` (so PowerSGD's Q, drawn by
``jax.random``, is the port's too).  Step by step rather than chained:
XLA's CPU code fuses the dequantize-and-sum into multiply-adds and torch
does not, so the residuals differ in the last bit, and a chain of steps
turns that, where a value lies within an ulp of a rounding boundary, into
a neighbouring int8/int4 code.  Mirrors ``tests/test_powersgd_ef.py`` and
``tests/test_int4.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from horovod_tpu_torch.models.convert import compression_state_from_jax
from horovod_tpu_torch.ops.compression import (Compression, Int4Compressor,
                                               Int8Compressor, TopKCompressor)
from horovod_tpu_torch.ops.powersgd import (ErrorFeedback, PowerSGDCompressor,
                                            _matrix_shape, _orthonormalize,
                                            _PowerSGDLeafState,
                                            as_stateful_compressor,
                                            is_stateful_compressor,
                                            state_from_plain, state_to_plain)
from torch_gloo_world import jax_spmd, start_world

WORLD, STEPS = 2, 3
# Sorted keys: the JAX tree's leaf order is the port's list order.  "b"
# is a 1-D leaf (PowerSGD keeps it dense), "c" a conv-shaped one.
SHAPES = {"a": (48, 40), "b": (300,), "c": (3, 3, 16, 24)}
KEYS = sorted(SHAPES)
# f32 on both sides; matrix products and dot products sum in another
# order than XLA's.
TOL = 1e-5


def _compressors(lib):
    """name → (port compressor, JAX compressor)."""
    if lib == "port":
        return {"ef_topk": ErrorFeedback(TopKCompressor(ratio=0.05)),
                "ef_int8": ErrorFeedback(Int8Compressor),
                "ef_int4": ErrorFeedback(Int4Compressor),
                "powersgd": PowerSGDCompressor(rank=3,
                                               min_compress_size=1000)}
    import horovod_tpu as hvd
    from horovod_tpu.ops import compression as J

    return {"ef_topk": hvd.ErrorFeedback(J.TopKCompressor(ratio=0.05)),
            "ef_int8": hvd.ErrorFeedback(J.Int8Compressor),
            "ef_int4": hvd.ErrorFeedback(J.Int4Compressor),
            "powersgd": hvd.PowerSGDCompressor(rank=3,
                                               min_compress_size=1000)}


NAMES = list(_compressors("port"))


def _grads(rank, step):
    rng = np.random.RandomState(1000 * step + rank)
    return {k: (rng.randn(*s) * (1 + step)).astype(np.float32)
            for k, s in SHAPES.items()}


def _row(state, rank):
    return [_PowerSGDLeafState(s.q[rank], s.residual[rank])
            if isinstance(s, _PowerSGDLeafState) else s[rank] for s in state]


def _worker(rank, world, inputs):
    """``inputs[name][t]``: the state step t starts from, every rank's."""
    out = {}
    for name, comp in _compressors("port").items():
        steps = []
        for t in range(STEPS):
            g = [torch.from_numpy(_grads(rank, t)[k]) for k in KEYS]
            reduced, state = comp.reduce(g, _row(inputs[name][t], rank),
                                         average=True)
            steps.append(([x.numpy() for x in reduced],
                          [tuple(s.numpy() for s in st)
                           if isinstance(st, _PowerSGDLeafState)
                           else st.numpy() for st in state]))
        out[name] = steps
    return out


def _jax_runs():
    """Initial state of each compressor (numpy); per step, the reduced tree
    and the state, each with a leading rank axis; and the port's inputs,
    the state each step starts from (every rank's, as the port's)."""
    import jax
    import jax.numpy as jnp

    init, runs, inputs = {}, {}, {}
    for name, comp in _compressors("jax").items():
        template = {k: jnp.zeros(s, jnp.float32) for k, s in SHAPES.items()}
        state = comp.init(template)
        init[name] = jax.tree.map(np.asarray, state)
        stacked = jax.tree.map(lambda x: jnp.stack([x] * WORLD), state)
        steps, inputs[name] = [], []
        for t in range(STEPS):
            inputs[name].append(compression_state_from_jax(
                jax.tree.map(np.asarray, stacked), device="cpu"))
            g = {k: jnp.asarray(np.stack([_grads(r, t)[k]
                                          for r in range(WORLD)]))
                 for k in KEYS}
            reduced, stacked = jax_spmd(
                lambda g, s: comp.reduce(g, s, average=True), WORLD, g,
                stacked)
            steps.append((reduced, stacked))
        runs[name] = steps
    return init, runs, inputs


@pytest.fixture(scope="module")
def sides():
    import jax

    init, runs, inputs = _jax_runs()
    ranks = start_world(_worker, WORLD, inputs)()
    return init, runs, ranks, jax


@pytest.mark.parametrize("name", NAMES)
def test_reduced_gradients_match_jax(sides, name):
    _, runs, ranks, _ = sides
    for t in range(STEPS):
        jred = runs[name][t][0]
        for r, seen in enumerate(ranks):
            for i, k in enumerate(KEYS):
                np.testing.assert_allclose(
                    seen[name][t][0][i], jred[k][r], rtol=TOL, atol=TOL,
                    err_msg=f"{name} step {t} leaf {k} rank {r}")


@pytest.mark.parametrize("name", NAMES)
def test_new_state_matches_jax(sides, name):
    """Residuals (and PowerSGD's Q) after each step, rank by rank."""
    _, runs, ranks, jax = sides
    for t in range(STEPS):
        jstate = runs[name][t][1]
        for r, seen in enumerate(ranks):
            want = compression_state_from_jax(
                jax.tree.map(lambda x: x[r], jstate), device="cpu")
            for got, w in zip(seen[name][t][1], want, strict=True):
                if isinstance(w, _PowerSGDLeafState):
                    for a, b in zip(got, w):
                        np.testing.assert_allclose(a, b.numpy(), rtol=TOL,
                                                   atol=TOL)
                else:
                    np.testing.assert_allclose(got, w.numpy(), rtol=TOL,
                                               atol=TOL)


def test_powersgd_state_carries_over_with_dense_sentinel(sides):
    init = sides[0]["powersgd"]
    state = compression_state_from_jax(init, device="cpu")
    assert [type(s).__name__ for s in state] == [
        "_PowerSGDLeafState", "Tensor", "_PowerSGDLeafState"]
    assert state[1].shape == (0,)
    assert state[0].q.shape == (40, 3) and state[0].residual.shape == (48, 40)
    # The port's own init: the JAX state's shapes and sentinel, Q seeded.
    own = PowerSGDCompressor(rank=3, min_compress_size=1000).init(
        [torch.zeros(SHAPES[k]) for k in KEYS])

    def shapes(st):
        return [tuple(tuple(t.shape) for t in s)
                if isinstance(s, _PowerSGDLeafState) else tuple(s.shape)
                for s in st]

    assert shapes(own) == shapes(state) == [((40, 3), (48, 40)), (0,),
                                            ((24, 3), (144, 24))]
    again = PowerSGDCompressor(rank=3, min_compress_size=1000).init(
        [torch.zeros(SHAPES[k]) for k in KEYS])
    assert torch.equal(own[0].q, again[0].q)
    plain = state_to_plain(own)
    assert isinstance(plain[0], dict) and set(plain[0]) == {"q", "residual"}
    back = state_from_plain(plain)
    assert torch.equal(back[2].q, own[2].q)


@pytest.mark.parametrize("shape", [(7,), (4096, 1), (3, 3, 64, 128),
                                   (512, 512), (1, 1, 1), (6, 10, 15)])
def test_matrix_shape_matches_jax(shape):
    from horovod_tpu.ops.powersgd import _matrix_shape as jms

    assert _matrix_shape(shape) == jms(shape)


@pytest.mark.parametrize("case", ["full", "rank_deficient", "zero_column"])
def test_orthonormalize_matches_jax(case):
    import jax.numpy as jnp

    from horovod_tpu.ops.powersgd import _orthonormalize as jortho

    rng = np.random.RandomState(3)
    p = rng.randn(50, 4).astype(np.float32)
    if case == "rank_deficient":
        p[:, 2] = 2.0 * p[:, 0] - p[:, 1]
    if case == "zero_column":
        p[:, 1] = 0.0
    got = _orthonormalize(torch.from_numpy(p)).numpy()
    want = np.asarray(jortho(jnp.asarray(p)))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    live = np.linalg.norm(got, axis=0) > 0.5
    assert live.sum() == (4 if case == "full" else 3)
    np.testing.assert_allclose(got[:, live].T @ got[:, live],
                               np.eye(int(live.sum())), atol=1e-5)


def test_error_feedback_rejects_dense_compressors():
    for dense in (Compression.fp16, Compression.bf16, Compression.none):
        with pytest.raises(TypeError):
            ErrorFeedback(dense)
    assert is_stateful_compressor(ErrorFeedback(TopKCompressor(ratio=0.1)))
    assert is_stateful_compressor(PowerSGDCompressor)
    assert not is_stateful_compressor(Compression.bf16)
    assert not is_stateful_compressor(Compression.int8)
    assert isinstance(as_stateful_compressor(PowerSGDCompressor),
                      PowerSGDCompressor)


@pytest.mark.parametrize("inner", [Int8Compressor, Int4Compressor,
                                   TopKCompressor(k=3)])
def test_transmitted_plus_residual_is_corrected(inner):
    """The residual is this rank's own compression error: transmitted +
    residual = corrected, and int8/int4 transmit their wire's roundtrip."""
    ef = ErrorFeedback(inner)
    rng = np.random.RandomState(5)
    c = torch.from_numpy(rng.randn(2000).astype(np.float32))
    sent = ef.transmitted(c)
    if isinstance(ef.inner, TopKCompressor):
        assert int((sent != 0).sum()) == 3
        top = torch.topk(c.abs(), 3).indices
        assert torch.equal(sent[top], c[top])
    else:
        assert torch.equal(sent, type(ef.inner).roundtrip(c))
    torch.testing.assert_close(sent + (c - sent), c, rtol=0, atol=0)


@pytest.mark.parametrize("inner", [Int8Compressor, Int4Compressor])
def test_error_feedback_forces_one_shot(world_of_one, monkeypatch, inner):
    """``ErrorFeedback`` asks its quantized compressor for the one-shot
    dataflow (the residual models the first quantization only); the
    ``one_shot()`` variant pins it for callers that pass a compressor."""
    asked = []
    real = inner.quantized_allreduce

    def spy(tensor, **kw):
        asked.append(kw.get("two_shot"))
        return real(tensor, **kw)

    monkeypatch.setattr(inner, "quantized_allreduce", spy)
    g = torch.from_numpy(np.random.RandomState(3).randn(2000)
                         .astype(np.float32))
    ef = ErrorFeedback(inner)
    reduced, _ = ef.reduce([g], ef.init([g]))
    assert asked == [False]
    assert torch.equal(reduced[0], inner.roundtrip(g))
    assert inner.one_shot().TWO_SHOT_MIN_WORLD > 1 << 40
    assert inner.one_shot() is inner.one_shot()
    assert issubclass(inner.one_shot(), inner)


@pytest.fixture
def world_of_one(monkeypatch):
    from horovod_tpu_torch import basics

    for var in ("HOROVOD_TPU_PROCESS_ID", "HOROVOD_TPU_NUM_PROCESSES",
                "HOROVOD_TPU_COORDINATOR", "RANK", "WORLD_SIZE",
                "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    basics.init("cpu")
    yield
    basics.shutdown()


@pytest.mark.parametrize("comp", ["powersgd", "ef_int8"])
def test_state_moves_only_on_the_kth_pass(world_of_one, comp):
    """Under ``backward_passes_per_step=2`` the first ``step()`` only
    accumulates: the compressor's state moves on the second, once
    (``tests/test_powersgd_ef.py::test_stateful_compressor_with_grad_accumulation``)."""
    from horovod_tpu_torch.optim.distributed_optimizer import \
        DistributedOptimizer

    w = torch.nn.Parameter(torch.from_numpy(
        np.random.RandomState(0).randn(64, 80).astype(np.float32)))
    opt = DistributedOptimizer(torch.optim.SGD([w], lr=0.1),
                               compression=_compressors("port")[comp],
                               backward_passes_per_step=2)

    def snapshot():
        return [t.clone() for t in state_to_plain(opt.comp_state)[0].values()
                ] if comp == "powersgd" else [opt.comp_state[0].clone()]

    start = snapshot()
    (w ** 3).sum().backward()
    opt.step()
    assert all(torch.equal(a, b) for a, b in zip(snapshot(), start))
    (w ** 3).sum().backward()
    opt.step()
    moved = snapshot()
    assert any(not torch.equal(a, b) for a, b in zip(moved, start))
    opt.zero_grad()
