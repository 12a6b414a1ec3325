"""The port's ViT against the JAX package's, on the CPU.

Two sizes: the tiny ViT of ``tests/test_models.py`` (patch 4, dim 32, depth
2, 2 heads: head dim 16, 16 patches) and a head-dim-64 variant (dim 128,
2 heads, 49 patches), the head width at which the flash kernels run for
every published ViT.  Same weights on both sides (flax variables filled
from seeded numpy, carried over by ``vision_state_dict_from_flax``), same
inputs.  ``attn_impl="flash"`` runs the JAX package's Pallas kernels in
interpret mode and the port's plain versions (the CPU path of
``flash_attention``); ``"dense"`` the einsum path on both sides.

Tolerances, f32: logits to 1e-4 · max |logit| and each parameter's
gradient to 1e-4 · its max (the same products summed in another order;
logits measured below 4e-7).  bf16 (dense): 2e-2 · max |logit|, between two
and three bf16 units in the last place of the largest logit, because the
two libraries round the products' partial sums at different points
(measured 9e-3, about one unit).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu.models import vit as jvit
from horovod_tpu_torch import basics
from horovod_tpu_torch.models import vit
from horovod_tpu_torch.models.convert import vision_state_dict_from_flax
from horovod_tpu_torch.optim.distributed_optimizer import (
    DistributedOptimizer, make_train_step)
from torch_flax_weights import close, flax_variables

RTOL = 1e-4
BF16_RTOL = 2e-2
# (model kwargs, image side)
CONFIGS = {
    "d16": (dict(patch=4, dim=32, depth=2, n_heads=2, num_classes=10), 16),
    "d64": (dict(patch=4, dim=128, depth=2, n_heads=2, num_classes=10), 28),
}
LAUNCH_VARS = ("HOROVOD_TPU_PROCESS_ID", "HOROVOD_TPU_NUM_PROCESSES",
               "HOROVOD_TPU_COORDINATOR", "RANK", "WORLD_SIZE",
               "MASTER_ADDR", "MASTER_PORT")


def _close(got, want, rtol=RTOL, err_msg=""):
    close(got, want, rtol, err_msg)


def _setup(config, impl, dtype=torch.float32, seed=0):
    """(JAX model, port model, flax variables, images, labels)."""
    kw, side = CONFIGS[config]
    rng = np.random.RandomState(seed)
    x = rng.randn(4, side, side, 3).astype(np.float32)
    y = rng.randint(0, kw["num_classes"], 4)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jm = jvit.ViT(**kw, dtype=jdtype, attn_impl=impl)
    variables = flax_variables(jm, x, seed)
    tm = vit.ViT(**kw, dtype=dtype, attn_impl=impl, image_size=side,
                 device="cpu")
    tm.load_state_dict(vision_state_dict_from_flax(variables))
    return jm, tm, variables, x, y


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_vit_logits_match_jax(config, impl):
    jm, tm, v, x, _ = _setup(config, impl)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        v, jnp.asarray(x))
    got = tm(torch.from_numpy(x), train=False)
    assert got.shape == (4, 10) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_vit_gradients_match_jax(config, impl):
    """Cross-entropy gradients of every parameter: JAX's flash backward is
    the Pallas dQ and dK/dV kernels in interpret mode, the port's the plain
    backward the CPU path of ``flash_attention`` runs."""
    jm, tm, v, x, y = _setup(config, impl, seed=1)

    def jloss(params):
        logits = jm.apply({"params": params}, jnp.asarray(x), train=True)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()

    jl, g = jax.jit(jax.value_and_grad(jloss))(v["params"])
    tl = F.cross_entropy(tm(torch.from_numpy(x)), torch.from_numpy(y))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=RTOL)
    want = vision_state_dict_from_flax(
        {"params": jax.tree_util.tree_map(np.asarray, g)})
    mine = dict(tm.named_parameters())
    assert set(want) == set(mine)
    for key, value in want.items():
        _close(mine[key].grad, value.numpy(), err_msg=key)


def test_vit_flash_equals_dense_in_the_port():
    """The same weights through both attention paths of the port."""
    _, dense, v, x, _ = _setup("d64", "dense", seed=2)
    flash = vit.ViT(**CONFIGS["d64"][0], attn_impl="flash", image_size=28,
                    device="cpu")
    flash.load_state_dict(dense.state_dict())
    xt = torch.from_numpy(x)
    want = dense(xt, train=False)
    _close(flash(xt, train=False), want.detach().numpy())


def test_vit_bf16_dense_keeps_flax_rounding_points():
    """bf16 compute, f32 parameters: scores in bf16, softmax in f32,
    probabilities cast back; logits in bf16 on both sides."""
    jm, tm, v, x, _ = _setup("d64", "dense", dtype=torch.bfloat16, seed=3)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        v, jnp.asarray(x))
    got = tm(torch.from_numpy(x), train=False)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    _close(got, np.asarray(want, np.float32), rtol=BF16_RTOL)


def test_vit_unknown_attn_impl_raises():
    """A typo'd impl must not silently run dense (``vit.py:44-50``)."""
    with pytest.raises(ValueError, match="unknown attn_impl"):
        vit.ViT(patch=4, dim=32, depth=1, n_heads=2, num_classes=10,
                attn_impl="Flash", image_size=16, device="cpu")


@pytest.fixture
def world_of_one(monkeypatch):
    for name in LAUNCH_VARS:
        monkeypatch.delenv(name, raising=False)
    basics.init("cpu")
    yield
    basics.shutdown()


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_vit_trains_through_the_distributed_step(world_of_one, impl):
    """The tiny ViT's loss falls in 5 steps of ``DistributedOptimizer(Adam(
    1e-2))`` through ``make_train_step`` (``tests/test_models.py:499-548``)."""
    kw, side = CONFIGS["d16"]
    model = vit.ViT(**kw, attn_impl=impl, image_size=side, device="cpu",
                    seed=2)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(8, side, side, 3).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, 8))
    opt = DistributedOptimizer(torch.optim.Adam(model.parameters(), lr=1e-2))

    def loss_fn(model, batch):
        bx, by = batch
        return F.cross_entropy(model(bx, train=True), by)

    step = make_train_step(loss_fn, opt)
    losses = [float(step(model, (x, y)).loss) for _ in range(5)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
