"""The port's MoE layer (router, forward, expert parallelism) and pipeline
against the JAX package's, expert parallelism and the pipeline on gloo
worlds of 2 and 4 (the JAX side under ``shard_map``).

Mirrors ``tests/test_moe_pipeline.py`` with its tolerances (MoE 1e-4,
pipeline 1e-5): the router's dispatch and capacity, the single-expert MLP,
expert parallelism's outputs and per-rank gradients, the pipeline's
outputs, loss and per-stage gradients with and without remat, the z-loss
and the jitter (whose numbers are the port's own: tested by their
properties); and the ``pipeline_mlp`` example twin on four stages, as
``tests/test_examples.py`` runs the reference's.  The MoE weights come
from the JAX ``init_params`` through ``moe_params_from_jax``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from horovod_tpu_torch.models import moe as tm
from horovod_tpu_torch.models.convert import moe_params_from_jax
from horovod_tpu_torch.parallel import _collectives as coll
from horovod_tpu_torch.parallel import pipeline as tp
from torch_gloo_world import jax_spmd, start_world

WORLDS = (2, 4)
MOE_ATOL = 1e-4                    # test_moe_pipeline.py
PIPE_ATOL, PIPE_RTOL = 1e-5, 1e-5  # test_moe_pipeline.py
REMAT_ATOL = 1e-6
M, MB, DIM = 4, 2, 8               # microbatches, their size, the width


def _tcfg(**kw):
    base = dict(dim=16, ffn_dim=32, n_experts=4, top_k=2,
                capacity_factor=8.0, dtype=torch.float32)
    base.update(kw)
    return tm.MoEConfig(**base)


def _jcfg(**kw):
    import jax.numpy as jnp

    from horovod_tpu.models import moe as jm

    base = dict(dim=16, ffn_dim=32, n_experts=4, top_k=2,
                capacity_factor=8.0, dtype=jnp.float32)
    base.update(kw)
    return jm.MoEConfig(**base)


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _stages(s, seed):
    rng = np.random.RandomState(seed)
    return [{"w": (rng.randn(DIM, DIM) / np.sqrt(DIM)).astype(np.float32),
             "b": np.zeros(DIM, np.float32)} for _ in range(s)]


def _stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _mse(y, t):
    return ((y - t) ** 2).mean()


def _ep_local(params, rank, world):
    e_loc = params["w_in"].shape[0] // world
    return {"router": params["router"],
            "w_in": params["w_in"][rank * e_loc:(rank + 1) * e_loc],
            "w_out": params["w_out"][rank * e_loc:(rank + 1) * e_loc]}


def _worker(rank, world, moe_params, stages):
    torch.set_num_threads(1)
    seen = {}
    n_tok = 32 // world
    loc_cfg = _tcfg(n_experts=8 // world, capacity_factor=16.0)
    full = moe_params_from_jax(moe_params, device="cpu")
    local = {k: v.clone().requires_grad_()
             for k, v in _ep_local(full, rank, world).items()}
    x = torch.from_numpy(_x((32, 16), 1)[rank * n_tok:(rank + 1) * n_tok])
    x.requires_grad_()
    y, aux = tm.expert_parallel_mlp(local, x, loc_cfg)
    (coll.pmean((y ** 2).mean()) + aux).backward()
    seen["ep"] = (y.detach().numpy(), float(aux),
                  {k: v.grad.numpy() for k, v in local.items()},
                  x.grad.numpy())
    jit = dataclasses.replace(loc_cfg, router_jitter=0.5)
    same_x = torch.from_numpy(_x((n_tok, 16), 7))       # on every rank
    with torch.no_grad():
        seen["ep_jitter"] = [tm.expert_parallel_mlp(
            local, same_x, jit, noise_key=key)[0].numpy()
            for key in (None, 5)]

    mine = {k: torch.from_numpy(v).requires_grad_()
            for k, v in stages[rank].items()}
    xs = torch.from_numpy(_x((M, MB, DIM), 3))
    tgt = torch.from_numpy(_x((M, MB, DIM), 4))
    seen["pipe_fwd"] = tp.pipeline_forward(_stage_fn, mine, xs).detach().numpy()
    for remat in (False, True):
        loss = tp.pipeline_loss_fn(_stage_fn, _mse, remat=remat)(mine,
                                                                 (xs, tgt))
        loss.backward()
        seen[f"pipe_remat_{remat}"] = (float(loss),
                                       {k: v.grad.numpy().copy()
                                        for k, v in mine.items()})
        for v in mine.values():
            v.grad = None
    if world == 4:
        from horovod_tpu_torch.examples import pipeline_mlp

        seen["example"] = pipeline_mlp.main(
            ["--microbatches", "4", "--steps", "12", "--device", "cpu"])
    return seen


def _jax_side(world, moe_params, stages):
    """Every JAX counterpart of ``_worker``'s values, one ``shard_map``
    program a world."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from horovod_tpu.models import moe as jm
    from horovod_tpu.parallel import pipeline as jp

    n_tok = 32 // world
    e_loc = 8 // world
    loc_cfg = _jcfg(n_experts=e_loc, capacity_factor=16.0)
    params = {k: jnp.asarray(v) for k, v in moe_params.items()}
    rep = lambda a: jnp.stack([jnp.asarray(a)] * world)
    inputs = {
        "moe": {"router": rep(params["router"]),
                "w_in": params["w_in"].reshape(
                    (world, e_loc) + params["w_in"].shape[1:]),
                "w_out": params["w_out"].reshape(
                    (world, e_loc) + params["w_out"].shape[1:])},
        "tokens": jnp.asarray(_x((32, 16), 1).reshape(world, n_tok, 16)),
        "stages": jax.tree.map(lambda a: jnp.asarray(a)[:, None],
                               jp.stack_stage_params(stages)),
        "x": rep(_x((M, MB, DIM), 3)), "tgt": rep(_x((M, MB, DIM), 4))}

    def stage_fn(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    def body(a):
        def ep_loss(p, x):
            y, aux = jm.expert_parallel_mlp(p, x, loc_cfg, axis_name="hvd")
            return lax.pmean(jnp.mean(y ** 2), "hvd") + aux
        y, aux = jm.expert_parallel_mlp(a["moe"], a["tokens"], loc_cfg,
                                        axis_name="hvd")
        out = {"ep": (y, aux, *jax.grad(ep_loss, argnums=(0, 1))(
            a["moe"], a["tokens"]))}
        ys = jp.pipeline_forward(stage_fn,
                                 jax.tree.map(lambda v: v[0], a["stages"]),
                                 a["x"], axis_name="hvd")
        out["pipe_fwd"] = lax.psum(ys, "hvd")
        for remat in (False, True):
            ploss = jp.pipeline_loss_fn(
                stage_fn, lambda y, t: jnp.mean((y - t) ** 2),
                axis_name="hvd", remat=remat)
            out[f"pipe_remat_{remat}"] = jax.value_and_grad(ploss)(
                a["stages"], (a["x"], a["tgt"]))
        return out

    return jax_spmd(body, world, inputs)


@pytest.fixture(scope="module")
def worlds():
    import jax

    from horovod_tpu.models import moe as jm

    moe_params = jax.tree.map(np.asarray, jax.jit(
        jm.init_params, static_argnums=0)(
        _jcfg(n_experts=8, capacity_factor=16.0), jax.random.key(0)))
    stages = {n: _stages(n, n) for n in WORLDS}
    joins = {n: start_world(_worker, n, moe_params, stages[n])
             for n in WORLDS}
    jx = {n: _jax_side(n, moe_params, stages[n]) for n in WORLDS}
    return {n: (joins[n](timeout=300), jx[n]) for n in WORLDS}


def _close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=rtol)


# -- the router and the single-process layer ---------------------------------


@pytest.mark.parametrize("case", ["topk2", "no_drop", "overflow"])
def test_route_matches_jax(case):
    """Dispatch and combine equal JAX's, each token in at most top_k
    slots, each slot held once; gates sum to one when nothing drops; an
    overflowing expert keeps only its capacity."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import moe as jm

    kw = {"topk2": {}, "no_drop": {"capacity_factor": 16.0},
          "overflow": {"capacity_factor": 0.25, "top_k": 1}}[case]
    t = 16 if case != "topk2" else 32
    logits = _x((t, 4), 11)
    if case == "overflow":
        logits = np.zeros((t, 4), np.float32)
        logits[:, 0] = 10.0
    got = tm.route(_tcfg(**kw), torch.from_numpy(logits))
    want = jax.jit(jm.route, static_argnums=0)(_jcfg(**kw),
                                                jnp.asarray(logits))
    # The slots are exact; the gates' softmax rounds in another order.
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _close(got[1].numpy(), np.asarray(want[1]), 1e-6)
    _close(float(got[2]), float(want[2]), 1e-6, 1e-6)
    dispatch, combine, _ = got
    assert float(dispatch.sum(dim=(1, 2)).max()) <= kw.get("top_k", 2)
    assert float(dispatch.sum(dim=0).max()) <= 1.0
    if case == "no_drop":
        _close(combine.sum(dim=(1, 2)).numpy(), np.ones(t), 0, 1e-5)
    if case == "overflow":
        assert float(dispatch.sum()) == tm._capacity(t, _tcfg(**kw))


def test_forward_matches_jax_and_single_expert_is_the_mlp():
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import moe as jm

    for n_exp, top_k in ((8, 2), (1, 1)):
        jcfg = _jcfg(n_experts=n_exp, top_k=top_k)
        jparams = jax.jit(jm.init_params, static_argnums=0)(
            jcfg, jax.random.key(0))
        x = _x((32, 16), 2)
        y_j, aux_j = jax.jit(jm.forward, static_argnums=2)(
            jparams, jnp.asarray(x), jcfg)
        params = moe_params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
        y, aux = tm.forward(params, torch.from_numpy(x),
                            _tcfg(n_experts=n_exp, top_k=top_k))
        _close(y.numpy(), np.asarray(y_j), MOE_ATOL)
        _close(float(aux), float(aux_j), 1e-6, 1e-5)
        if n_exp == 1:
            ref = torch.nn.functional.silu(
                torch.from_numpy(x) @ params["w_in"][0]) @ params["w_out"][0]
            _close(y.numpy(), ref.numpy(), 1e-5)


def test_moe_z_loss_and_jitter():
    """The z-loss raises aux by mean(log²Σe^logit), outputs unchanged;
    jitter moves the routing only with a noise key, reproducibly."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import moe as jm

    cfg0 = tm.MoEConfig(dim=16, ffn_dim=32, n_experts=4,
                        dtype=torch.float32)
    cfgz = dataclasses.replace(cfg0, z_loss_weight=1e-3)
    params = tm.init_params(cfg0, 0, device="cpu")
    x = torch.from_numpy(_x((32, 16), 1))
    y0, aux0 = tm.forward(params, x, cfg0)
    yz, auxz = tm.forward(params, x, cfgz)
    np.testing.assert_array_equal(y0.numpy(), yz.numpy())
    z = torch.logsumexp(tm.router_logits(params, x, cfg0), dim=-1)
    _close(float(auxz - aux0), 1e-3 * float((z ** 2).mean()), 0, 1e-5)
    jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    jcfgz = jm.MoEConfig(dim=16, ffn_dim=32, n_experts=4, dtype=jnp.float32,
                         z_loss_weight=1e-3)
    _close(float(auxz), float(jax.jit(jm.forward, static_argnums=2)(
        jparams, jnp.asarray(x.numpy()), jcfgz)[1]), 0, 1e-5)
    cfgj = dataclasses.replace(cfg0, router_jitter=0.8)
    ya, _ = tm.forward(params, x, cfgj)
    yb, _ = tm.forward(params, x, cfgj)
    np.testing.assert_array_equal(ya.numpy(), yb.numpy())
    np.testing.assert_array_equal(ya.numpy(), y0.numpy())
    yn, _ = tm.forward(params, x, cfgj, noise_key=2)
    assert np.abs(yn.numpy() - ya.numpy()).max() > 0
    np.testing.assert_array_equal(
        yn.numpy(), tm.forward(params, x, cfgj,
                               noise_key=torch.Generator().manual_seed(2))[0]
        .numpy())


# -- expert parallelism -------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_expert_parallel_matches_jax(worlds, world):
    """Each rank's tokens through the two all-to-alls, and aux (pmean)."""
    ranks, jx = worlds[world]
    y_j, aux_j, _, _ = jx["ep"]
    for r, seen in enumerate(ranks):
        y, aux, _, _ = seen["ep"]
        _close(y, y_j[r], MOE_ATOL)
        _close(aux, aux_j[r], 1e-6, 1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_expert_parallel_gradients_match_jax(worlds, world):
    """Per-rank gradients of pmean(mean(y²)) + aux through the
    all-to-alls' and the pmean's transposes, nonzero for every leaf."""
    ranks, jx = worlds[world]
    _, _, gp_j, gx_j = jx["ep"]
    for r, seen in enumerate(ranks):
        _, _, gp, gx = seen["ep"]
        for k in ("router", "w_in", "w_out"):
            _close(gp[k], gp_j[k][r], MOE_ATOL)
            assert np.abs(gp[k]).sum() > 0 and np.isfinite(gp[k]).all()
        _close(gx, gx_j[r], MOE_ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_expert_parallel_jitter_is_decorrelated_across_ranks(worlds, world):
    """The same tokens on every rank route alike without jitter; with one
    seed, each rank draws its own (the reference folds the rank into its
    key), so their outputs part."""
    ranks, _ = worlds[world]
    plain = [seen["ep_jitter"][0] for seen in ranks]
    noisy = [seen["ep_jitter"][1] for seen in ranks]
    for a, b in zip(plain[1:], noisy[1:]):
        np.testing.assert_array_equal(a, plain[0])
        assert np.abs(b - noisy[0]).max() > 0


# -- the pipeline -------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_pipeline_matches_jax(worlds, world):
    """Outputs on the last stage (zeros elsewhere) equal JAX's psum'd."""
    ranks, jx = worlds[world]
    for r, seen in enumerate(ranks):
        if r == world - 1:
            _close(seen["pipe_fwd"], jx["pipe_fwd"][r], PIPE_ATOL)
        else:
            assert not seen["pipe_fwd"].any()


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("world", WORLDS)
def test_pipeline_loss_and_gradients_match_jax(worlds, world, remat):
    """The replicated loss and each stage's gradients (single-sourced from
    the last stage through the hops' backward)."""
    ranks, jx = worlds[world]
    loss_j, grads_j = jx[f"pipe_remat_{remat}"]
    for r, seen in enumerate(ranks):
        loss, grads = seen[f"pipe_remat_{remat}"]
        _close(loss, loss_j[r], 0, PIPE_RTOL)
        for k in ("w", "b"):
            _close(grads[k], grads_j[k][r][0], PIPE_ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_pipeline_remat_gradients_unchanged(worlds, world):
    ranks, _ = worlds[world]
    for seen in ranks:
        (l0, g0), (l1, g1) = seen["pipe_remat_False"], seen["pipe_remat_True"]
        _close(l0, l1, 0, REMAT_ATOL)
        for k in ("w", "b"):
            _close(g0[k], g1[k], REMAT_ATOL)


def test_pipeline_mlp_example_twin(worlds):
    """``examples/pipeline_mlp.py``'s twin on four stages, four
    microbatches, twelve steps: the loss falls (the example raises
    otherwise) on every stage alike."""
    ranks, _ = worlds[4]
    losses = [seen["example"] for seen in ranks]
    assert len(losses[0]) == 12 and losses[0][-1] < losses[0][0]
    for other in losses[1:]:
        assert other == losses[0]
