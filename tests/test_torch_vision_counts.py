"""The port's Inception-V3 against the JAX package's, and the parameter
counts of the port's full-size vision models, on the CPU.

Same weights on both sides (flax variables filled from seeded numpy,
carried over by ``vision_state_dict_from_flax``), same inputs.
Inception-V3 at its smallest legal side, 75.  Tolerance, f32 on both
sides: max |Δlogit| ≤ 1e-4 · max |logit| (the same products summed in
another order).
"""

from __future__ import annotations

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import inception as jinception
from horovod_tpu.models import resnet as jresnet
from horovod_tpu.models import vgg as jvgg
from horovod_tpu.models import vit as jvit
from horovod_tpu_torch.models import inception, mnist, resnet, vgg, vit
from torch_flax_weights import close, japply, load_pair

RTOL = 1e-4


def _close(got, want, rtol=RTOL):
    close(got, want, rtol)


def test_inception_v3_eval_matches_jax_at_its_smallest_side():
    x = np.random.RandomState(7).randn(1, 75, 75, 3).astype(np.float32)
    jm = jinception.InceptionV3(num_classes=10)
    tm = inception.InceptionV3(num_classes=10, device="cpu")
    v = load_pair(jm, tm, x)
    _close(tm(torch.from_numpy(x), train=False),
           japply(jm, v, x))


def test_inception_avg_pool_counts_padding_like_flax():
    """flax's avg_pool with SAME padding divides by the full window (the
    padded zeros count), as ``count_include_pad=True`` does."""
    x = np.random.RandomState(8).randn(1, 5, 5, 2).astype(np.float32)
    want = fnn.avg_pool(jnp.asarray(x), (3, 3), strides=(1, 1),
                        padding="SAME")
    got = inception._pool_avg(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got.permute(0, 2, 3, 1), want, rtol=1e-6)


def _n_params(model) -> int:
    return sum(p.numel() for p in model.parameters())


def _jcount(model, side) -> int:
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0),
                           jnp.ones((1, side, side, 3)), train=False))
    return sum(int(np.prod(s.shape))
               for s in jax.tree_util.tree_leaves(shapes["params"]))


# name -> (port model, JAX model, image side, (low, high) of the count)
COUNTS = {
    "resnet50": (lambda: resnet.ResNet50(device="cpu"),
                 lambda: jresnet.ResNet50(), 64, (24e6, 27e6)),
    "inception_v3": (lambda: inception.InceptionV3(device="cpu"),
                     lambda: jinception.InceptionV3(), 299, (22e6, 25e6)),
    "vgg16_c100_32": (lambda: vgg.VGG16(num_classes=100, image_size=32,
                                        device="cpu"),
                      lambda: jvgg.VGG16(num_classes=100), 32, (33e6, 35e6)),
    "vit_b16": (lambda: vit.ViT_B16(device="cpu"),
                lambda: jvit.ViT_B16(), 224, (84e6, 89e6)),
}


@pytest.mark.parametrize("name", list(COUNTS))
def test_param_counts_mirror_the_jax_models(name):
    """``tests/test_models.py``'s counts (:29, :49, :71, :486): ResNet-50
    ~25.5 M, Inception-V3 ~23.8 M (no aux head), VGG-16 with 100 classes
    at 32 × 32 ~34.0 M, ViT-B/16 ~86 M; each equal to the JAX model's own count
    (the port's BN scale and bias are parameters, its running statistics
    buffers, as flax keeps them in ``batch_stats``)."""
    port, jax_model, side, (low, high) = COUNTS[name]
    n = _n_params(port())
    assert low < n < high and n == _jcount(jax_model(), side)


def test_output_shapes_and_aux_head():
    """Logits are f32 of [B, classes] in eval and train mode; Inception's
    aux head adds a second output in train mode only (at 299, the smallest
    side whose 17 × 17 grid survives the aux head's 5 × 5 VALID conv)."""
    x = torch.ones((2, 28, 28, 1))
    for model in (mnist.MnistConvNet(device="cpu"),
                  mnist.MnistMLP(device="cpu")):
        out = model(x, train=False)
        assert out.shape == (2, 10) and out.dtype == torch.float32
    aux = inception.InceptionV3(num_classes=10, aux_logits=True,
                                device="cpu")
    logits, aux_logits = aux(torch.ones((2, 299, 299, 3)), train=True)
    assert logits.shape == (2, 10) and aux_logits.shape == (2, 10)
    assert aux(torch.ones((1, 75, 75, 3)), train=False).shape == (1, 10)
