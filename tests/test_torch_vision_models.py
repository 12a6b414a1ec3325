"""The port's vision models against the JAX package's, on the CPU.

Same weights on both sides: the flax variables of the JAX model, carried
over by ``vision_state_dict_from_flax``; same inputs, from seeded numpy.
Small sizes (ResNet with one block a stage at width 8, VGG-16 with a narrow
classifier at 32 × 32); Inception-V3 and the parameter counts are in
tests/test_torch_vision_counts.py.

Tolerance, f32 on both sides: max |Δlogit| ≤ 1e-4 · max |logit| (the same
products summed in another order; measured below 1e-5).  Running
statistics are held to the same bound relative to each tensor's largest
value.  One SGD step's update Δw is held to 5e-4 · max |Δw| per tensor:
train-mode BN's gradient cancels, and in float64 each side's f32 gradient
is off by up to 2e-4 of the tensor's largest (the port's 4e-5 to 7e-5, the
JAX package's 1.5e-4 to 2e-4, measured on the seeds below).
"""

from __future__ import annotations

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu.models import mnist as jmnist
from horovod_tpu.models import resnet as jresnet
from horovod_tpu.models import vgg as jvgg
from horovod_tpu_torch.models import layers, mnist, resnet, vgg
from horovod_tpu_torch.models.convert import vision_state_dict_from_flax
from torch_flax_weights import close, japply, load_pair

RTOL = 1e-4
STEP_RTOL = 5e-4


def _close(got, want, rtol=RTOL):
    close(got, want, rtol)


@pytest.mark.parametrize("name", ["MnistConvNet", "MnistMLP"])
def test_mnist_models_match_jax(name):
    x = np.random.RandomState(1).rand(4, 28, 28, 1).astype(np.float32)
    jm, tm = getattr(jmnist, name)(), getattr(mnist, name)(device="cpu")
    v = load_pair(jm, tm, x)
    got = tm(torch.from_numpy(x), train=False)
    assert got.shape == (4, 10) and got.dtype == torch.float32
    _close(got, japply(jm, v, x))


def _tiny_resnets():
    kw = dict(stage_sizes=(1, 1, 1, 1), width=8, num_classes=10)
    return jresnet.ResNet(**kw), resnet.ResNet(**kw, device="cpu")


def test_resnet_eval_and_train_outputs_and_running_stats_match_jax():
    """Eval logits from the running statistics; train-mode logits from the
    batch statistics; then the running statistics each updates (flax's
    momentum 0.9 on the old value and the biased batch variance)."""
    x = np.random.RandomState(2).randn(4, 32, 32, 3).astype(np.float32)
    jm, tm = _tiny_resnets()
    v = load_pair(jm, tm, x)
    _close(tm(torch.from_numpy(x), train=False),
           japply(jm, v, x))
    want, mutated = japply(jm, v, x, train=True)
    _close(tm(torch.from_numpy(x), train=True), want)
    stats = vision_state_dict_from_flax(
        {"batch_stats": jax.tree_util.tree_map(np.asarray,
                                               mutated["batch_stats"])})
    mine = tm.state_dict()
    assert len(stats) == 2 * 17     # mean and var of every BN
    for key, value in stats.items():
        _close(mine[key], value.numpy())


def test_resnet_one_sgd_step_matches_optax():
    """One step of cross-entropy through train-mode BN, SGD(0.1, momentum
    0.9) on both sides: the loss and every parameter's update."""
    rng = np.random.RandomState(3)
    x = rng.randn(4, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, 4)
    jm, tm = _tiny_resnets()
    v = load_pair(jm, tm, x)

    def jloss(params):
        logits, _ = jm.apply({"params": params,
                              "batch_stats": v["batch_stats"]},
                             jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()

    tx = optax.sgd(0.1, momentum=0.9)
    jl, g = jax.jit(jax.value_and_grad(jloss))(v["params"])
    updates, _ = tx.update(g, tx.init(v["params"]), v["params"])

    before = {k: p.detach().clone() for k, p in tm.named_parameters()}
    opt = torch.optim.SGD(tm.parameters(), lr=0.1, momentum=0.9)
    tl = F.cross_entropy(tm(torch.from_numpy(x), train=True),
                         torch.from_numpy(y))
    tl.backward()
    opt.step()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=RTOL)
    want = vision_state_dict_from_flax(
        {"params": jax.tree_util.tree_map(np.asarray, updates)})
    mine = dict(tm.named_parameters())
    assert set(want) == set(mine)
    for key, value in want.items():
        _close(mine[key] - before[key], value.numpy(), rtol=STEP_RTOL)


@pytest.mark.parametrize("side", [8, 7])
def test_stride2_same_conv_pads_like_flax(side):
    """A stride-2 3×3 SAME conv: on an even side flax pads (0, 1), which
    torch's symmetric padding=1 would not reproduce; on an odd side (1, 1)."""
    assert layers.same_pads(side, 3, 2) == ((0, 1) if side % 2 == 0
                                            else (1, 1))
    rng = np.random.RandomState(side)
    x = rng.randn(2, side, side, 5).astype(np.float32)
    jconv = fnn.Conv(6, (3, 3), strides=(2, 2))
    v = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tconv = layers.Conv(5, 6, (3, 3), (2, 2))
    tconv.load_state_dict(vision_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, v)))
    got = tconv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, jconv.apply(v, jnp.asarray(x)))
    symmetric = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                         tconv.weight, tconv.bias, 2, 1).permute(0, 2, 3, 1)
    if side % 2 == 0:
        assert not np.allclose(symmetric.detach().numpy(),
                               np.asarray(jconv.apply(v, jnp.asarray(x))),
                               atol=1e-3)


def test_batchnorm_momentum_and_biased_running_variance():
    """flax's BatchNorm(momentum=0.9): running = 0.9·old + 0.1·batch, with
    the biased batch variance; torch's own BatchNorm2d(momentum=0.1) folds
    the unbiased one, which the port corrects."""
    rng = np.random.RandomState(4)
    x = rng.randn(3, 4, 4, 6).astype(np.float32)
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                        epsilon=1e-5)
    v = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want_y, mutated = jbn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    bn = layers.BatchNorm(6, momentum=0.9, epsilon=1e-5)
    got_y = bn(torch.from_numpy(x).permute(0, 3, 1, 2), train=True)
    _close(got_y.permute(0, 2, 3, 1), want_y)
    biased = x.reshape(-1, 6).var(0)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 + 0.1 * biased,
                               rtol=1e-6)
    np.testing.assert_allclose(
        bn.running_var.numpy(),
        np.asarray(mutated["batch_stats"]["var"]), rtol=1e-6)
    np.testing.assert_allclose(
        bn.running_mean.numpy(),
        np.asarray(mutated["batch_stats"]["mean"]), rtol=1e-5, atol=1e-7)
    torch_bn = torch.nn.BatchNorm2d(6, momentum=0.1)
    torch_bn(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert not np.allclose(torch_bn.running_var.numpy(),
                           bn.running_var.numpy(), rtol=1e-4)


def test_batchnorm_bf16_takes_its_statistics_in_f32():
    """flax's BatchNorm(dtype=bf16) on a bf16 input computes the batch
    statistics in f32 (the input promoted) and rounds only the output: the
    running statistics match flax's to f32 accuracy, the output to one bf16
    unit."""
    rng = np.random.RandomState(9)
    x = (3.0 + rng.randn(4, 5, 5, 8)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                        epsilon=1e-5, dtype=jnp.bfloat16)
    v = jbn.init(jax.random.PRNGKey(0), xb)
    want_y, mutated = jbn.apply(v, xb, mutable=["batch_stats"])
    bn = layers.BatchNorm(8, momentum=0.9, epsilon=1e-5, dtype=torch.bfloat16)
    xt = torch.from_numpy(np.asarray(xb, np.float32)).bfloat16()
    got_y = bn(xt.permute(0, 3, 1, 2), train=True).permute(0, 2, 3, 1)
    assert want_y.dtype == jnp.bfloat16 and got_y.dtype == torch.bfloat16
    _close(got_y, np.asarray(want_y, np.float32), rtol=2 ** -7)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(mutated["batch_stats"][key]),
                                   rtol=1e-5)


def test_vgg16_eval_matches_jax():
    x = np.random.RandomState(5).randn(2, 32, 32, 3).astype(np.float32)
    jm = jvgg.VGG16(num_classes=10, classifier_width=64)
    tm = vgg.VGG16(num_classes=10, classifier_width=64, image_size=32,
                   device="cpu")
    v = load_pair(jm, tm, x)
    _close(tm(torch.from_numpy(x), train=False),
           japply(jm, v, x))


def test_vgg16_dropout_draws_from_its_own_generator():
    """Train mode drops half the classifier units from the module's
    generator: the same seed gives the same logits, the global RNG is not
    touched."""
    x = torch.from_numpy(
        np.random.RandomState(6).randn(2, 32, 32, 3).astype(np.float32))
    kw = dict(num_classes=10, classifier_width=64, image_size=32,
              device="cpu", dropout_seed=3)
    a, b = vgg.VGG16(**kw), vgg.VGG16(**kw)
    state = torch.get_rng_state()
    out_a, out_b = a(x, train=True), b(x, train=True)
    assert torch.equal(torch.get_rng_state(), state)
    assert torch.equal(out_a, out_b)
    assert not torch.allclose(out_a, a(x, train=False))


def test_models_default_to_the_card():
    """No device argument means CUDA: without a card the models raise."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mnist.MnistMLP()
