"""The port's ZeRO and FSDP steps against the JAX package's on gloo worlds
of 2 and 4 (the JAX side on a mesh of as many CPU devices).

Mirrors ``tests/test_optimizer.py`` (ZeRO with Adam, optimizer state of
``[ceil(P/n)]`` a rank for 13 parameters, the global-norm clip) and
``tests/test_fsdp.py`` (the partition specs, shards staying 1/n, parity
with training, one step function for two models), with their tolerances;
plus ZeRO over leaves of two dtypes (``ravel_pytree``'s promotion) and the
FSDP clip.  Each rank's state is held against its slice of the JAX
state; one spawned world per size for the file.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from horovod_tpu_torch.optim import fsdp as tf
from horovod_tpu_torch.optim.distributed_optimizer import tree_leaves
from horovod_tpu_torch.optim.zero import make_zero_train_step
from torch_gloo_world import start_world

WORLDS = (2, 4)
ZERO_ATOL = 1e-6          # test_optimizer.py: ZeRO against replicated
LOSS_RTOL = 1e-6
FSDP_RTOL, FSDP_ATOL = 1e-4, 1e-5     # test_fsdp.py: parameters
FSDP_LOSS_RTOL, FSDP_LOSS_ATOL = 1e-5, 1e-6
STEPS = 3
FSDP_STEPS = 10


def _zero_params(case):
    if case == "adam":
        return {"w": np.arange(10.0, dtype=np.float32) / 10,
                "b": np.ones(3, np.float32)}
    if case == "clip":
        return {"w": np.arange(10.0, dtype=np.float32),
                "b": np.full(3, 5.0, np.float32)}
    return {"w": np.arange(10.0, dtype=np.float32) / 10,      # "mixed"
            "b": np.ones(3, np.float32)}                      # b is bf16


def _zero_batch(case, rank):
    value = 2.0 if case == "clip" else float(rank + 1)
    return np.full((2, 1), value, np.float32)


def _fsdp_params(scale=1, seed=0):
    rng = np.random.RandomState(seed)
    return {"w1": rng.randn(16, 64 * scale).astype(np.float32),
            "w2": rng.randn(64 * scale, 8).astype(np.float32),
            "b": rng.randn(8).astype(np.float32)}


def _fsdp_data(world, rows, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(world * rows, 16).astype(np.float32),
            rng.randn(world * rows, 8).astype(np.float32))


class _OptaxAdam(torch.optim.Optimizer):
    """``optax.adam``'s arithmetic as a torch optimizer: its bias
    corrections are f32 (``1 - 0.999`` is 1.3e-5 off in f32), where
    ``torch.optim.Adam`` takes them in double, which moves an update by
    ~6e-6 of itself.  The ZeRO and FSDP parities use it so that they hold
    the sharding machinery, not the two libraries' Adam, to the reference
    tests' tolerances."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            lr, b1, b2, eps = (group[k] for k in ("lr", "b1", "b2", "eps"))
            for p in group["params"]:
                st = self.state[p]
                if not st:
                    st.update(count=0, exp_avg=torch.zeros_like(p),
                              exp_avg_sq=torch.zeros_like(p))
                st["count"] += 1
                g = p.grad
                st["exp_avg"] = (1 - b1) * g + b1 * st["exp_avg"]
                st["exp_avg_sq"] = (1 - b2) * g * g + b2 * st["exp_avg_sq"]
                count = torch.tensor(st["count"], dtype=torch.int32)
                bc1 = 1 - torch.tensor(b1, dtype=p.dtype) ** count
                bc2 = 1 - torch.tensor(b2, dtype=p.dtype) ** count
                update = (st["exp_avg"] / bc1) / (
                    torch.sqrt(st["exp_avg_sq"] / bc2) + eps)
                p.add_(-lr * update)


def _quad_loss(params, batch):
    scale = batch.mean()
    return scale * ((params["w"].float() ** 2).sum()
                    + (params["b"].float() ** 2).sum())


def _mlp_loss(params, batch):
    x, y = batch
    h = torch.tanh(x @ params["w1"])
    return ((h @ params["w2"] + params["b"] - y) ** 2).mean()


def _zero_worker(rank, world):
    out = {}
    for case in ("adam", "clip", "mixed"):
        params = {k: torch.from_numpy(v.copy())
                  for k, v in _zero_params(case).items()}
        if case == "mixed":
            params["b"] = params["b"].to(torch.bfloat16)
        make = ((lambda ps: torch.optim.SGD(ps, lr=0.1)) if case == "clip"
                else (lambda ps: _OptaxAdam(ps, lr=0.1)))
        step, init = make_zero_train_step(
            _quad_loss, make, clip_global_norm=1.0 if case == "clip" else None)
        state = init(params)
        losses = []
        for _ in range(STEPS):
            res = step(params, state, torch.from_numpy(
                _zero_batch(case, rank)))
            losses.append(float(res.loss))
        opt = state.optimizer.state[state.shard]
        out[case] = {
            "params": {k: v.detach().float().numpy() for k, v in params.items()},
            "losses": losses,
            "views": all(t.data_ptr() >= state.flat.data_ptr()
                         for t in tree_leaves(params) if t.dtype == torch.float32),
            "moments": None if case == "clip" else (
                opt["exp_avg"].numpy(), opt["exp_avg_sq"].numpy())}
    return out


def _fsdp_worker(rank, world):
    out = {}
    base = {k: torch.from_numpy(v) for k, v in _fsdp_params().items()}
    specs = tf.fsdp_partition_specs(base, min_shard_elems=64)
    odd = tf.fsdp_partition_specs({"w": torch.zeros(10, 6)},
                                  min_shard_elems=64)
    indivisible = tf.fsdp_partition_specs({"w": torch.zeros(9, 13)},
                                          min_shard_elems=1)
    out["specs"] = (specs, odd["w"], indivisible["w"],
                    tf.fsdp_partition_specs(base))
    for clip in (None, 1.0):
        params = tf.shard_params(base, tf.fsdp_partition_specs(base))
        step, init = tf.make_fsdp_train_step(
            _mlp_loss, lambda ps: _OptaxAdam(ps, lr=1e-2),
            clip_global_norm=clip)
        opt = init(params)
        x, y = _fsdp_data(world, 4, 2)
        mine = (torch.from_numpy(x[rank * 4:(rank + 1) * 4]),
                torch.from_numpy(y[rank * 4:(rank + 1) * 4]))
        losses = [float(step(params, opt, mine).loss)
                  for _ in range(FSDP_STEPS)]
        out[("train", clip)] = {
            "losses": losses,
            "shards": {k: v.detach().numpy() for k, v in params.items()},
            "dims": {k: v.fsdp_dim for k, v in params.items()},
            "state_shapes": {k: tuple(opt.state[v]["exp_avg"].shape)
                             for k, v in params.items()}}
    step, init = tf.make_fsdp_train_step(
        _mlp_loss, lambda ps: torch.optim.Adam(ps, lr=1e-2))
    rekey = []
    for scale in (1, 2):
        full = {k: torch.from_numpy(v)
                for k, v in _fsdp_params(scale, seed=3).items()}
        params = tf.shard_params(full, tf.fsdp_partition_specs(full))
        x, y = _fsdp_data(world, 2, 10 + scale)
        mine = (torch.from_numpy(x[rank * 2:(rank + 1) * 2]),
                torch.from_numpy(y[rank * 2:(rank + 1) * 2]))
        res = step(params, init(params), mine)
        rekey.append((float(res.loss), tuple(params["w1"].shape)))
    out["rekey"] = rekey
    w = tf.shard_params({"w": torch.zeros(64, 32)},
                        tf.fsdp_partition_specs({"w": torch.zeros(64, 32)}))
    out["fraction"] = w["w"].numel()
    return out


def _worker(rank, world):
    torch.set_num_threads(1)
    return {"zero": _zero_worker(rank, world),
            "fsdp": _fsdp_worker(rank, world)}


def _dim(spec):
    """A JAX PartitionSpec as the port's spec: the sharded dim or None."""
    return next((i for i, a in enumerate(spec) if a is not None), None)


def _jax_side(world):
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh

    from horovod_tpu.optim import fsdp as jf
    from horovod_tpu.optim.zero import make_zero_train_step as jzero

    mesh = Mesh(np.asarray(jax.devices()[:world]), ("hvd",))
    out = {"zero": {}, "fsdp": {}}

    def quad(params, batch):
        scale = jnp.mean(batch)
        return scale * (jnp.sum(params["w"].astype(jnp.float32) ** 2)
                        + jnp.sum(params["b"].astype(jnp.float32) ** 2))

    for case in ("adam", "clip", "mixed"):
        params = {k: jnp.asarray(v) for k, v in _zero_params(case).items()}
        if case == "mixed":
            params["b"] = params["b"].astype(jnp.bfloat16)
        tx = optax.sgd(0.1) if case == "clip" else optax.adam(0.1)
        step, init = jzero(quad, tx, mesh=mesh, donate=False,
                           clip_global_norm=1.0 if case == "clip" else None)
        state = init(params)
        batch = jnp.asarray(np.concatenate([_zero_batch(case, r)
                                            for r in range(world)]))
        losses = []
        for _ in range(STEPS):
            res = step(params, state, batch)
            params, state = res.params, res.opt_state
            losses.append(float(res.loss))
        leaves = jax.tree.leaves(state)
        out["zero"][case] = {
            "params": {k: np.asarray(v, np.float32) for k, v in params.items()},
            "losses": losses,
            "moments": None if case == "clip" else (
                np.asarray(leaves[1]), np.asarray(leaves[2]))}

    def mlp(params, batch):
        x, y = batch
        h = jnp.tanh(x @ params["w1"])
        return jnp.mean((h @ params["w2"] + params["b"] - y) ** 2)

    base = {k: jnp.asarray(v) for k, v in _fsdp_params().items()}
    out["fsdp"]["specs"] = (
        jax.tree.map(_dim, jf.fsdp_partition_specs(base, mesh=mesh,
                                                   min_shard_elems=64),
                     is_leaf=lambda s: isinstance(s, tuple)),
        _dim(jf.fsdp_partition_specs({"w": jnp.zeros((10, 6))}, mesh=mesh,
                                     min_shard_elems=64)["w"]),
        _dim(jf.fsdp_partition_specs({"w": jnp.zeros((9, 13))}, mesh=mesh,
                                     min_shard_elems=1)["w"]),
        jax.tree.map(_dim, jf.fsdp_partition_specs(base, mesh=mesh),
                     is_leaf=lambda s: isinstance(s, tuple)))
    for clip in (None, 1.0):
        adam = optax.adam(1e-2)
        tx = adam if clip is None else optax.chain(
            optax.clip_by_global_norm(clip), adam)
        step, init = jf.make_fsdp_train_step(mlp, tx, mesh=mesh,
                                             donate=False)
        params = jf.shard_params(base, jf.fsdp_partition_specs(
            base, mesh=mesh), mesh=mesh)
        state = init(params)
        data = tuple(jnp.asarray(a) for a in _fsdp_data(world, 4, 2))
        losses = []
        for _ in range(FSDP_STEPS):
            res = step(params, state, data)
            params, state = res.params, res.opt_state
            losses.append(float(res.loss))
        out["fsdp"][("train", clip)] = {
            "losses": losses,
            "params": {k: np.asarray(v) for k, v in params.items()}}
    step, init = jf.make_fsdp_train_step(mlp, optax.adam(1e-2), mesh=mesh,
                                         donate=False)
    rekey = []
    for scale in (1, 2):
        full = {k: jnp.asarray(v)
                for k, v in _fsdp_params(scale, seed=3).items()}
        params = jf.shard_params(full, jf.fsdp_partition_specs(
            full, mesh=mesh), mesh=mesh)
        data = tuple(jnp.asarray(a) for a in _fsdp_data(world, 2, 10 + scale))
        rekey.append(float(step(params, init(params), data).loss))
    out["fsdp"]["rekey"] = rekey
    return out


@pytest.fixture(scope="module")
def worlds():
    joins = {n: start_world(_worker, n) for n in WORLDS}
    jx = {n: _jax_side(n) for n in WORLDS}
    return {n: (joins[n](timeout=300), jx[n]) for n in WORLDS}


@pytest.mark.parametrize("case", ["adam", "clip", "mixed"])
@pytest.mark.parametrize("world", WORLDS)
def test_zero_step_matches_jax(worlds, world, case):
    """Adam on 13 elements (padded to n·ceil(13/n)), the clip (SGD, the
    norm from the shards), and a bf16 leaf beside f32 ones."""
    ranks, jx = worlds[world]
    want = jx["zero"][case]
    per = -(-13 // world)
    for r, seen in enumerate(ranks):
        got = seen["zero"][case]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=LOSS_RTOL)
        for k in ("w", "b"):
            np.testing.assert_allclose(got["params"][k], want["params"][k],
                                       atol=ZERO_ATOL, err_msg=k)
        assert got["views"]
        if got["moments"] is not None:
            for mine, theirs in zip(got["moments"], want["moments"]):
                assert mine.shape == (per,)
                np.testing.assert_allclose(
                    mine, theirs[r * per:(r + 1) * per], atol=ZERO_ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_fsdp_partition_specs_match_jax(worlds, world):
    ranks, jx = worlds[world]
    for seen in ranks:
        assert seen["fsdp"]["specs"] == jx["fsdp"]["specs"]
    specs = ranks[0]["fsdp"]["specs"][0]
    assert specs == {"w1": 1, "w2": 0, "b": None}


@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("world", WORLDS)
def test_fsdp_matches_jax_training(worlds, world, clip):
    """Ten Adam steps: losses, and the shards gathered back, against the
    JAX FSDP step; the shards and Adam's moments stay 1/n."""
    ranks, jx = worlds[world]
    want = jx["fsdp"][("train", clip)]
    for seen in ranks:
        got = seen["fsdp"][("train", clip)]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=FSDP_LOSS_RTOL, atol=FSDP_LOSS_ATOL)
    for k, full in want["params"].items():
        d = ranks[0]["fsdp"][("train", clip)]["dims"][k]
        shards = [seen["fsdp"][("train", clip)]["shards"][k]
                  for seen in ranks]
        gathered = shards[0] if d is None else np.concatenate(shards, axis=d)
        np.testing.assert_allclose(gathered, full, rtol=FSDP_RTOL,
                                   atol=FSDP_ATOL, err_msg=k)
        for seen in ranks:
            got = seen["fsdp"][("train", clip)]
            assert got["state_shapes"][k] == got["shards"][k].shape
            if d is not None:
                assert got["shards"][k].size * world == full.size


@pytest.mark.parametrize("world", WORLDS)
def test_fsdp_step_rekeys_on_new_model_shapes(worlds, world):
    ranks, jx = worlds[world]
    for seen in ranks:
        for (loss, shape), want, scale in zip(seen["fsdp"]["rekey"],
                                              jx["fsdp"]["rekey"], (1, 2)):
            assert np.isfinite(loss)
            np.testing.assert_allclose(loss, want, rtol=FSDP_LOSS_RTOL)
            assert shape == (16, 64 * scale // world)


@pytest.mark.parametrize("world", WORLDS)
def test_fsdp_memory_shards_are_actual_fractions(worlds, world):
    ranks, _ = worlds[world]
    for seen in ranks:
        assert seen["fsdp"]["fraction"] == 64 * 32 // world


def test_zero_refuses_params_it_did_not_lay_out():
    import horovod_tpu_torch.basics as basics

    basics.init("cpu")
    try:
        step, init = make_zero_train_step(
            _quad_loss, lambda ps: torch.optim.SGD(ps, lr=0.1))
        state = init({"w": torch.ones(4), "b": torch.ones(3)})
        with pytest.raises(ValueError, match="init_opt_state"):
            step({"w": torch.ones(4), "b": torch.ones(3)}, state,
                 torch.ones(2, 1))
        with pytest.raises(ValueError, match="no spec"):
            tf.make_fsdp_train_step(_quad_loss, None)[0](
                {"w": torch.ones(4)}, None, torch.ones(1))
    finally:
        basics.shutdown()
