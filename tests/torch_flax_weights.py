"""Shared by the port's vision parity tests: one set of flax variables for a
JAX model and its port twin, and the relative comparison they use."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from horovod_tpu_torch.models.convert import vision_state_dict_from_flax


def close(got, want, rtol, err_msg=""):
    """max |got − want| ≤ rtol · max |want|, shapes equal."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, err_msg
    np.testing.assert_allclose(got, want, rtol=0, err_msg=err_msg,
                               atol=rtol * float(np.abs(want).max()))


def flax_variables(jmodel, x, seed):
    """Flax variables of ``jmodel``'s shapes (``init`` traced, never run:
    eager or compiled, flax's initialisers take tens of seconds on the CPU
    for the deeper models), filled from seeded numpy so every weight is
    exercised: kernels at LeCun scale, scales near one (nonzero last-BN
    scales), nontrivial biases, embeddings and running statistics,
    positive variances."""
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    rng = np.random.RandomState(seed)

    def make(path, s):
        name, a = path[-1].key, rng.randn(*s.shape).astype(np.float32)
        if name == "kernel":
            return a / np.sqrt(np.prod(s.shape[:-1]))
        if name == "var":
            return np.abs(0.1 * a) + 0.5
        if name == "scale":
            return 1.0 + 0.1 * a
        return 0.1 * a

    return jax.tree_util.tree_map_with_path(make, shapes)


def load_pair(jmodel, tmodel, x, seed=0):
    """The same variables for both models; returns them for the JAX side."""
    variables = flax_variables(jmodel, x, seed)
    tmodel.load_state_dict(vision_state_dict_from_flax(variables))
    return variables


def japply(jmodel, variables, x, train=False):
    """``jmodel.apply`` compiled (one XLA program instead of op-by-op
    dispatch); in train mode also the updated ``batch_stats``."""
    if train:
        fn = jax.jit(lambda v, x: jmodel.apply(v, x, train=True,
                                               mutable=["batch_stats"]))
    else:
        fn = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))
    return fn(variables, jnp.asarray(x))
