"""Port parity: the Llama training core against the JAX reference.

Both sides run ``llama_tiny`` in float32 from the same weights (the JAX
``init_params`` pytree through ``params_from_jax``) on the same seeded numpy
batch: ``loss_fn`` for every attention engine, the gradient of every leaf
against ``jax.grad`` (the JAX flash backward is the Pallas pair in
interpret mode), remat on and off, each named remat policy, and the fused
loss.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import llama as jl
from horovod_tpu_torch.models import llama as tl
from horovod_tpu_torch.models.convert import params_from_jax

# f32 loss of a 2-layer tiny model: the same math, products summed in
# another order (~1e-7 relative per op).
LOSS_RTOL = 1e-5
# f32 gradients through two layers and the loss: relative to each leaf's
# largest |grad|.
GRAD_RTOL = 1e-4
IMPLS = ["dense", "blockwise", "flash"]
B, L = 2, 16

_jloss = jax.jit(jl.loss_fn, static_argnums=(2,))
_jgrad = jax.jit(jax.grad(jl.loss_fn), static_argnums=(2,))


def _cfgs(**kw):
    return (jl.llama_tiny(dtype=jnp.float32, **kw),
            tl.llama_tiny(dtype=torch.float32, **kw))


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs()
    jp = jl.init_params(jcfg, jax.random.PRNGKey(21))
    return jp, jax.tree_util.tree_map(np.asarray, jp)


def _batch(seed=0, vocab=256):
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, vocab, (B, L + 1)).astype(np.int32)
    return tok[:, :-1], tok[:, 1:]


def _trainable(np_tree):
    params = params_from_jax(np_tree, device="cpu")

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        else:
            t.requires_grad_()

    walk(params)
    return params


def _torch_loss_and_grads(np_tree, batch, cfg):
    params = _trainable(np_tree)
    loss = tl.loss_fn(params, tuple(torch.as_tensor(b) for b in batch), cfg)
    loss.backward()
    return float(loss.detach()), params


def _leaves(jtree, ttree):
    """(path, jax leaf, torch grad) for every parameter."""
    for path, leaf in jax.tree_util.tree_leaves_with_path(jtree):
        t = ttree
        for key in path:
            t = t[key.key]
        yield jax.tree_util.keystr(path), np.asarray(leaf), t.grad


def _assert_grads_close(jgrads, tparams, rtol=GRAD_RTOL):
    for name, want, got in _leaves(jgrads, tparams):
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(got.numpy(), want, atol=rtol * scale,
                                   err_msg=name)


@pytest.mark.parametrize("impl", IMPLS)
def test_loss_fn_matches_jax(weights, impl):
    jp, np_tree = weights
    jcfg, tcfg = _cfgs(attn_impl=impl)
    batch = _batch(seed=1)
    want = float(_jloss(jp, tuple(jnp.asarray(b) for b in batch), jcfg))
    got, _ = _torch_loss_and_grads(np_tree, batch, tcfg)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_grads_of_every_leaf_match_jax_grad(weights, impl):
    jp, np_tree = weights
    jcfg, tcfg = _cfgs(attn_impl=impl)
    batch = _batch(seed=2)
    jg = _jgrad(jp, tuple(jnp.asarray(b) for b in batch), jcfg)
    _, tparams = _torch_loss_and_grads(np_tree, batch, tcfg)
    _assert_grads_close(jg, tparams)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_remat_on_and_off_give_equal_grads(weights, impl):
    """Checkpointing each layer changes what is stored, not the math: the
    recompute runs the same ops on the same inputs (exact on the CPU)."""
    _, np_tree = weights
    _, off = _cfgs(attn_impl=impl)
    on = dataclasses.replace(off, remat=True)
    batch = _batch(seed=3)
    l_off, g_off = _torch_loss_and_grads(np_tree, batch, off)
    l_on, g_on = _torch_loss_and_grads(np_tree, batch, on)
    assert l_on == l_off
    for a, b in zip(_flat(g_on), _flat(g_off)):
        np.testing.assert_array_equal(a.grad.numpy(), b.grad.numpy())


def _flat(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    return [tree]


@pytest.mark.parametrize("policy", ["dots_saveable",
                                    "dots_with_no_batch_dims_saveable",
                                    "everything_saveable",
                                    "nothing_saveable"])
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_each_remat_policy_matches_full_remat(weights, policy, impl):
    """A policy changes which activations are kept, never the gradients."""
    _, np_tree = weights
    _, base = _cfgs(attn_impl=impl)
    full = dataclasses.replace(base, remat=True)
    named = dataclasses.replace(full, remat_policy=policy)
    batch = _batch(seed=4)
    l_full, g_full = _torch_loss_and_grads(np_tree, batch, full)
    l_named, g_named = _torch_loss_and_grads(np_tree, batch, named)
    np.testing.assert_allclose(l_named, l_full, rtol=1e-6)
    for a, b in zip(_flat(g_named), _flat(g_full)):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=1e-5,
                                   atol=1e-7)


def _backward_op_counts(np_tree, cfg):
    """How often each aten op runs during the backward (the recompute
    included)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n[func] = self.n.get(func, 0) + 1
            return func(*args, **(kwargs or {}))

    params = _trainable(np_tree)
    batch = tuple(torch.as_tensor(b) for b in _batch(seed=6))
    loss = tl.loss_fn(params, batch, cfg)
    with Count() as mode:
        loss.backward()
    return mode.n


def test_remat_policies_keep_what_they_name(weights):
    """The backward's recompute reruns what a policy does not keep: the
    weight products (``mm``) unless a dots policy keeps them, attention's
    head-batched products (``bmm``) unless dots_saveable or everything
    does, and the softmax's ``exp`` unless everything is kept."""
    _, np_tree = weights
    _, base = _cfgs(attn_impl="blockwise", remat=True)
    aten = torch.ops.aten
    counts = {p: _backward_op_counts(np_tree, dataclasses.replace(
        base, remat_policy=p)) for p in (None,) + tl._REMAT_POLICIES}

    def n(policy, op):
        return counts[policy].get(op, 0)

    mm, bmm, exp = aten.mm.default, aten.bmm.default, aten.exp.default
    assert n(None, mm) == n("nothing_saveable", mm)
    assert (n("nothing_saveable", mm) > n("dots_with_no_batch_dims_saveable",
                                          mm)
            == n("dots_saveable", mm) == n("everything_saveable", mm))
    assert (n("dots_with_no_batch_dims_saveable", bmm)
            == n("nothing_saveable", bmm) > n("dots_saveable", bmm)
            == n("everything_saveable", bmm))
    assert n("dots_saveable", exp) > n("everything_saveable", exp) == 0


def test_remat_policy_errors_match_jax(weights):
    """A bad name and a policy without remat raise as in the reference."""
    jp, np_tree = weights
    batch = _batch()
    tparams = params_from_jax(np_tree, device="cpu")
    tbatch = tuple(torch.as_tensor(b) for b in batch)
    jbatch = tuple(jnp.asarray(b) for b in batch)
    bad = dict(remat=True, remat_policy="save_only_these_names")
    orphan = dict(remat=False, remat_policy="dots_saveable")
    for kw, match in ((bad, "unknown remat_policy"), (orphan, "remat=False")):
        jcfg, tcfg = _cfgs(**kw)
        with pytest.raises(ValueError, match=match):
            jl.loss_fn(jp, jbatch, jcfg)
        with pytest.raises(ValueError, match=match):
            tl.loss_fn(tparams, tbatch, tcfg)


def test_remat_default_follows_the_reference():
    assert tl.llama3_8b().remat is jl.llama3_8b().remat is True
    assert tl.llama_tiny().remat is jl.llama_tiny().remat is False
    assert tl._REMAT_POLICIES == jl._REMAT_POLICIES


@pytest.mark.parametrize("chunk", [64, 100])   # 100: a ragged last chunk
def test_fused_loss_matches_plain_and_jax(weights, chunk):
    jp, np_tree = weights
    jcfg, tcfg = _cfgs(fused_loss_chunk=chunk)
    _, plain = _cfgs()
    batch = _batch(seed=5)
    jbatch = tuple(jnp.asarray(b) for b in batch)
    want = float(_jloss(jp, jbatch, jcfg))
    got, g_fused = _torch_loss_and_grads(np_tree, batch, tcfg)
    got_plain, _ = _torch_loss_and_grads(np_tree, batch, plain)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got, got_plain, rtol=2e-5)
    _assert_grads_close(_jgrad(jp, jbatch, jcfg), g_fused)


def test_fused_loss_rejects_chunk_zero(weights):
    _, np_tree = weights
    _, tcfg = _cfgs(fused_loss_chunk=0)
    with pytest.raises(ValueError, match="positive"):
        _torch_loss_and_grads(np_tree, _batch(), tcfg)
