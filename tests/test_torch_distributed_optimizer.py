"""The port's data-parallel step against the JAX package's, 2 ranks.

JAX side, in this process: ``make_train_step(loss_fn, DistributedOptimizer(
optax.chain(clip_by_global_norm(1.0), adamw(...))), mesh=Mesh(2 devices))``
over a rank-major batch.  Port side: two gloo processes under
``torch.multiprocessing.spawn``, each taking its rows of the same batch,
from the same weights (``params_from_jax``), through
``DistributedOptimizer(torch.optim.AdamW(...))`` and ``make_train_step``
with clipping at 1.0.  ``llama_tiny`` in float32, three steps; then
``backward_passes_per_step=2`` against JAX's ``MultiSteps`` path; then the
compressed and alternative reductions: int8, ``ErrorFeedback(TopK)``,
``PowerSGDCompressor`` (its Q carried from JAX's ``init`` by
``compression_state_from_jax``), ``is_sparse`` at ratios 0.01 and 1.0 (the
latter equal to the dense step, as ``tests/test_optimizer.py:70`` holds)
and ``op=Adasum``.  The workers import only torch and the port.  The example twin that drives the
same path is tested in tests/test_torch_llama_finetune_example.py.
"""

from __future__ import annotations

import os
import pickle
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from horovod_tpu_torch import basics
from horovod_tpu_torch.models import llama as tl
from horovod_tpu_torch.models.convert import (compression_state_from_jax,
                                              params_from_jax)
from horovod_tpu_torch.optim.distributed_optimizer import (
    DistributedOptimizer, broadcast_parameters, make_train_step, tree_leaves)

WORLD, B, L, LR = 2, 2, 16, 1e-3
# name → (passes per step, steps, the reduction's options by name)
RUNS = {"plain": (1, 3, None), "accumulate2": (2, 4, None),
        "int8": (1, 3, "int8"), "ef_topk": (1, 3, "ef_topk"),
        "powersgd": (1, 3, "powersgd"), "sparse0.01": (1, 3, "sparse0.01"),
        "sparse1.0": (1, 3, "sparse1.0"), "adasum": (1, 3, "adasum")}
# f32 on both sides.  Per-step losses: the same forward, another summation
# order.  Parameters: AdamW scales each element's update to about lr
# whatever its gradient's size, so an element whose gradient is near zero
# turns summation-order noise into an update difference of up to 2·lr per
# update.  So each leaf's update (final − initial) is held relative to
# JAX's, and every element to that 2·lr-per-update bound.  torch's
# clip_grad_norm_ adds 1e-6 to the norm; optax does not.
LOSS_RTOL = 1e-5
UPDATE_RTOL = 5e-3
LAUNCH_VARS = ("HOROVOD_TPU_PROCESS_ID", "HOROVOD_TPU_NUM_PROCESSES",
               "HOROVOD_TPU_COORDINATOR", "RANK", "WORLD_SIZE",
               "MASTER_ADDR", "MASTER_PORT")


def _batches(steps, vocab=256, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (WORLD * B, L + 1)).astype(np.int32)
            for _ in range(steps)]


def _adamw(params):
    return torch.optim.AdamW(tree_leaves(params), lr=LR, betas=(0.9, 0.95),
                             weight_decay=0.1, eps=1e-8)


def _options(name, lib):
    """DistributedOptimizer keywords of a run, for the port or for JAX."""
    if name is None:
        return {}
    if lib == "port":
        from horovod_tpu_torch.ops import collective_ops as C
        from horovod_tpu_torch.ops import compression as comp
        from horovod_tpu_torch.ops import powersgd as ps
    else:
        from horovod_tpu.ops import collective_ops as C
        from horovod_tpu.ops import compression as comp
        from horovod_tpu.ops import powersgd as ps
    return {"int8": lambda: dict(compression=comp.Compression.int8),
            "ef_topk": lambda: dict(compression=ps.ErrorFeedback(
                comp.TopKCompressor(ratio=0.01))),
            "powersgd": lambda: dict(compression=ps.PowerSGDCompressor(
                rank=4)),
            "sparse0.01": lambda: dict(is_sparse=True, sparse_ratio=0.01),
            "sparse1.0": lambda: dict(is_sparse=True, sparse_ratio=1.0),
            "adasum": lambda: dict(op=C.Adasum)}[name]()


def _worker(rank: int, port: int, tree_path: str, out_dir: str) -> None:
    os.environ.update(
        HOROVOD_TPU_PROCESS_ID=str(rank), HOROVOD_TPU_NUM_PROCESSES=str(WORLD),
        HOROVOD_TPU_COORDINATOR=f"127.0.0.1:{port}")
    basics.init("cpu")
    with open(tree_path, "rb") as f:
        np_tree, powersgd_state = pickle.load(f)
    cfg = tl.llama_tiny(dtype=torch.float32)
    out = {}
    for name, (k, steps, how) in RUNS.items():
        params = params_from_jax(np_tree, device="cpu")
        if rank == 1:       # a wrong start that the broadcast must repair
            for t in tree_leaves(params):
                t.data.add_(1.0)
        broadcast_parameters(params, root_rank=0)
        for t in tree_leaves(params):
            t.requires_grad_()
        opt = DistributedOptimizer(_adamw(params), backward_passes_per_step=k,
                                   **_options(how, "port"))
        if how == "powersgd":       # JAX's Q, carried over
            opt.comp_state = list(powersgd_state)
        step = make_train_step(tl.make_loss_fn(cfg), opt, max_grad_norm=1.0)
        losses = []
        for tok in _batches(steps):
            mine = torch.as_tensor(tok[rank * B:(rank + 1) * B])
            losses.append(float(step(params, (mine[:, :-1], mine[:, 1:])).loss))
        out[name] = (losses, [t.detach().numpy().copy()
                              for t in tree_leaves(params)])
    basics.shutdown()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _jax_runs(cfg, params0):
    """Per run, the JAX losses and final leaves (jax.tree.leaves order)."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh

    import horovod_tpu as hvd
    from horovod_tpu.models import llama as jl

    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("hvd",))
    result = {}
    for name, (k, steps, how) in RUNS.items():
        tx = hvd.DistributedOptimizer(
            optax.chain(optax.clip_by_global_norm(1.0),
                        optax.adamw(LR, b1=0.9, b2=0.95, weight_decay=0.1)),
            backward_passes_per_step=k, **_options(how, "jax"))
        opt_state = tx.init(params0)
        step = hvd.make_train_step(jl.make_loss_fn(cfg), tx, mesh=mesh,
                                   donate=False)
        params, losses = params0, []
        for tok in _batches(steps):
            out = step(params, opt_state,
                       (jnp.asarray(tok[:, :-1]), jnp.asarray(tok[:, 1:])))
            params, opt_state = out.params, out.opt_state
            losses.append(float(out.loss))
        result[name] = (losses, [np.asarray(x)
                                 for x in jax.tree_util.tree_leaves(params)])
    return result


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """(initial leaves, JAX runs, port runs per rank).  The two port ranks
    train while this process runs the JAX side."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import llama as jl

    cfg = jl.llama_tiny(dtype=jnp.float32)
    params0 = jl.init_params(cfg, jax.random.PRNGKey(7))
    np_tree = jax.tree_util.tree_map(np.asarray, params0)
    # The compressor state JAX's DistributedOptimizer.init makes (its Q from
    # jax.random), as the port's.
    powersgd_state = compression_state_from_jax(
        jax.tree_util.tree_map(np.asarray, _options("powersgd", "jax")[
            "compression"].init(params0)), device="cpu")
    out = tmp_path_factory.mktemp("dopt")
    tree_path = out / "params.pkl"
    with open(tree_path, "wb") as f:
        pickle.dump((np_tree, powersgd_state), f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.start_processes(_worker, args=(port, str(tree_path), str(out)),
                             nprocs=WORLD, join=False, start_method="spawn")
    jax_runs = _jax_runs(cfg, params0)
    while not ctx.join():
        pass
    ranks = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return jax.tree_util.tree_leaves(np_tree), jax_runs, ranks


@pytest.mark.parametrize("run", list(RUNS))
def test_losses_match_make_train_step(sides, run):
    _, jax_runs, ranks = sides
    for seen in ranks:
        np.testing.assert_allclose(seen[run][0], jax_runs[run][0],
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("run", list(RUNS))
def test_final_params_match_make_train_step(sides, run):
    """Each leaf's update (final − initial) against JAX's, relative, and no
    element further off than AdamW's step bound allows."""
    p0, jax_runs, ranks = sides
    want = jax_runs[run][1]
    k, steps, _ = RUNS[run]
    bound = 2 * LR * (steps // k)
    for seen in ranks:
        got = seen[run][1]
        assert len(got) == len(want) == len(p0)
        for a, w, init in zip(got, want, p0):
            upd_t, upd_j = a - init, w - init
            rel = np.linalg.norm(upd_t - upd_j) / np.linalg.norm(upd_j)
            assert rel <= UPDATE_RTOL, (run, a.shape, rel)
            assert np.abs(a - w).max() <= bound


def test_sparse_ratio_one_equals_dense(sides):
    """Top-k of every entry is the dense allreduce, bit for bit."""
    ranks = sides[2]
    for seen in ranks:
        assert seen["sparse1.0"][0] == seen["plain"][0]
        for a, b in zip(seen["sparse1.0"][1], seen["plain"][1]):
            np.testing.assert_array_equal(a, b)


def test_ranks_stay_identical(sides):
    ranks = sides[2]
    for run in RUNS:
        for a, b in zip(ranks[0][run][1], ranks[1][run][1]):
            np.testing.assert_array_equal(a, b)


def test_accumulation_leaves_params_until_the_kth_pass(sides):
    """With k=2 the first step only accumulates: its loss equals the plain
    run's first loss on both sides."""
    _, jax_runs, ranks = sides
    np.testing.assert_allclose(jax_runs["accumulate2"][0][0],
                               jax_runs["plain"][0][0], rtol=LOSS_RTOL)
    assert ranks[0]["accumulate2"][0][0] == ranks[0]["plain"][0][0]


def test_local_makes_no_collective_call(monkeypatch):
    """``local=True``: synchronize() and step() never reach the wire."""
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    calls = []
    real = dist.all_reduce

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(dist, "all_reduce", counting)
    basics.init("cpu")
    try:
        w = torch.ones(3, requires_grad=True)
        for local, want in ((True, 0), (False, 1)):
            calls.clear()
            opt = DistributedOptimizer(torch.optim.SGD([w], lr=0.1),
                                       local=local)
            (w * 2).sum().backward()
            opt.step()
            opt.zero_grad()
            assert len(calls) == want, (local, calls)
    finally:
        basics.shutdown()


def test_later_slice_options_raise():
    """The options earlier slices refused (``is_sparse``, stateful
    compressors, Adasum) now construct; the combinations the JAX package
    rejects raise its ``ValueError``, as does
    ``backward_passes_per_step=0``."""
    from horovod_tpu_torch.ops.collective_ops import Adasum, Max, ProcessSet
    from horovod_tpu_torch.ops.compression import TopKCompressor
    from horovod_tpu_torch.ops.powersgd import (ErrorFeedback,
                                                PowerSGDCompressor)

    w = torch.zeros(64, 64, requires_grad=True)
    opt = torch.optim.SGD([w], lr=0.1)
    assert DistributedOptimizer(opt, is_sparse=True).is_sparse
    assert DistributedOptimizer(opt, op=Adasum).op is Adasum
    stateful = DistributedOptimizer(opt, compression=PowerSGDCompressor)
    assert stateful.stateful and len(stateful.comp_state) == 1
    ef = ErrorFeedback(TopKCompressor(ratio=0.1))
    assert DistributedOptimizer(opt, compression=ef).comp_state[0].shape == (
        64, 64)
    # local=True skips the stateful machinery, even where it would clash.
    local = DistributedOptimizer(opt, compression=ef, local=True,
                                 is_sparse=True)
    assert not local.stateful and local.comp_state is None
    for kw, match in (
            (dict(compression=ef, is_sparse=True), "is_sparse"),
            (dict(compression=ef, process_set=ProcessSet([0])),
             "process_set"),
            (dict(compression=PowerSGDCompressor(), op=Max), "Sum/Average"),
            (dict(compression=PowerSGDCompressor(), op=Adasum),
             "Sum/Average"),
            (dict(is_sparse=True, process_set=ProcessSet([0])), "top-k"),
            (dict(backward_passes_per_step=0), "backward_passes_per_step")):
        with pytest.raises(ValueError, match=match):
            DistributedOptimizer(opt, **kw)
    with pytest.raises(ValueError, match="unknown reduce op"):
        DistributedOptimizer(opt, op=object())
