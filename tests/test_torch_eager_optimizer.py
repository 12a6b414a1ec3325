"""The hook-driven optimizers on a 2-rank gloo world, negotiated by the
native controller.

* ``torch_frontend.DistributedOptimizer`` (post-accumulate-grad hooks,
  async allreduces through the eager engine) against the port's
  synchronous ``DistributedOptimizer`` from the same weights: reduced
  gradients and updated parameters bit for bit (f32, Sum and Average, no
  compression; the reduction is elementwise across ranks, so buckets do
  not matter), with ``backward_passes_per_step=2`` too.
* The same pair through ``make_train_step``, with ``max_grad_norm`` (the
  clip must see the reduced gradients) and with
  ``backward_passes_per_step=2`` (the first call only accumulates): the
  losses and parameters bit for bit.
* ``synchronize()``, another backward, then ``step()``: the second
  backward's gradients are reduced too, so the ranks stay replicated.
* The reference's ``test_force_allreduce``: a two-headed net, each rank
  using its own head; the head a rank did not use is reduced from zeros
  at ``synchronize`` (bit for bit against (g₀ + g₁)/2).
* ``EagerDistributedOptimizer`` with ``ErrorFeedback`` (top-k and int8)
  and with Adasum, against the synchronous optimizer's same reductions,
  over two steps (residuals carried): bit for bit.
* ``EagerDistributedOptimizer`` against the JAX package's on rank-major
  inputs with the same weights (SGD, f32): within 1e-6 relative (two ranks'
  sums round alike in any order; the backward's own f32 order differs).
* The two example twins, two steps each on the same world.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_gloo_world import free_port, start_world

WORLD = 2
DIMS = (6, 8, 3)
LR = 0.1
JAX_RTOL = 1e-6


def _weights(seed=0):
    rng = np.random.RandomState(seed)
    return {"w1": rng.randn(DIMS[0], DIMS[1]).astype(np.float32) * 0.5,
            "b1": rng.randn(DIMS[1]).astype(np.float32) * 0.1,
            "w2": rng.randn(DIMS[1], DIMS[2]).astype(np.float32) * 0.5,
            "b2": rng.randn(DIMS[2]).astype(np.float32) * 0.1}


def _batch(rank, step, n=5):
    rng = np.random.RandomState(1000 + 10 * rank + step)
    return (rng.randn(n, DIMS[0]).astype(np.float32),
            rng.randn(n, DIMS[2]).astype(np.float32))


class Mlp(torch.nn.Module):
    """Parameters named as the JAX twin's dict (sorted: b1, b2, w1, w2)."""

    def __init__(self, w):
        super().__init__()
        for k, v in sorted(w.items()):
            setattr(self, k, torch.nn.Parameter(torch.from_numpy(v.copy())))

    def forward(self, x):
        return torch.tanh(x @ self.w1 + self.b1) @ self.w2 + self.b2


def _loss(model, batch):
    x, y = batch
    return ((model(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).mean()


class TwoHeads(torch.nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(3)
        self.trunk = torch.nn.Parameter(torch.randn(6, 4, generator=g))
        self.head = torch.nn.ParameterList(
            [torch.nn.Parameter(torch.randn(4, 2, generator=g))
             for _ in range(2)])

    def forward(self, x, which):
        return torch.tanh(x @ self.trunk) @ self.head[which]


def _params(model):
    return {n: p.detach().clone().numpy() for n, p in model.named_parameters()}


def _grads(model):
    return {n: p.grad.clone().numpy() for n, p in model.named_parameters()
            if p.grad is not None}


def _train(rank, make_opt, steps, passes=1, sgd_momentum=0.0):
    """``steps`` steps of ``passes`` backward passes from the same weights;
    the reduced gradients of the last step and the final parameters.  The
    synchronous wrapper counts passes in ``step()``, so it is called after
    each; the hook-driven one counts them in its hooks."""
    from horovod_tpu_torch.optim.distributed_optimizer import \
        DistributedOptimizer as Sync

    model = Mlp(_weights())
    opt = make_opt(model, torch.optim.SGD(model.parameters(), lr=LR,
                                          momentum=sgd_momentum))
    grads = None
    for s in range(steps):
        opt.zero_grad()
        for k in range(passes):
            _loss(model, _batch(rank, passes * s + k)).backward()
            if isinstance(opt, Sync) and k < passes - 1:
                opt.step()
        opt.synchronize()
        grads = _grads(model)
        opt.step()
    if hasattr(opt, "remove_hooks"):
        opt.remove_hooks()
    return grads, _params(model)


def _train_step(rank, make_opt, calls, **kw):
    """``calls`` calls of ``make_train_step`` (its keywords ``kw``) from the
    same weights, a new batch each: the averaged losses and the final
    parameters."""
    from horovod_tpu_torch.optim.distributed_optimizer import make_train_step

    model = Mlp(_weights())
    opt = make_opt(model, torch.optim.SGD(model.parameters(), lr=LR,
                                          momentum=0.9))
    step = make_train_step(_loss, opt, **kw)
    losses = [float(step(model, _batch(rank, s)).loss) for s in range(calls)]
    if hasattr(opt, "remove_hooks"):
        opt.remove_hooks()
    return {"loss": np.array(losses)}, _params(model)


def _worker(rank, world):
    from horovod_tpu_torch import torch_frontend as F
    from horovod_tpu_torch.examples import pytorch_mnist
    from horovod_tpu_torch.examples import pytorch_synthetic_benchmark as psb
    from horovod_tpu_torch.ops import collective_ops as C
    from horovod_tpu_torch.ops.compression import Compression, TopKCompressor
    from horovod_tpu_torch.ops.powersgd import ErrorFeedback
    from horovod_tpu_torch.optim.distributed_optimizer import \
        DistributedOptimizer as Sync
    from horovod_tpu_torch.optim.eager_optimizer import \
        EagerDistributedOptimizer as Eager

    seen = {}
    for op in ("Sum", "Average"):
        o = getattr(C, op)
        seen[("sync", op)] = _train(rank, lambda m, b: Sync(b, op=o), 2,
                                    sgd_momentum=0.9)
        seen[("hook", op)] = _train(
            rank, lambda m, b: F.DistributedOptimizer(
                b, m.named_parameters(), op=o), 2, sgd_momentum=0.9)
    seen[("sync", "bpps")] = _train(
        rank, lambda m, b: Sync(b, backward_passes_per_step=2), 2, passes=2)
    seen[("hook", "bpps")] = _train(
        rank, lambda m, b: F.DistributedOptimizer(
            b, m.named_parameters(), backward_passes_per_step=2), 2,
        passes=2)
    for name, k, kw in (("step_clip", 1, dict(max_grad_norm=0.05)),
                        ("step_bpps", 2, {})):
        seen[("sync", name)] = _train_step(
            rank, lambda m, b: Sync(b, backward_passes_per_step=k), 4, **kw)
        seen[("hook", name)] = _train_step(
            rank, lambda m, b: F.DistributedOptimizer(
                b, m.named_parameters(), backward_passes_per_step=k), 4,
            **kw)
    for name, comp in (("ef_topk", lambda: ErrorFeedback(
            TopKCompressor(ratio=0.25))),
            ("ef_int8", lambda: ErrorFeedback(Compression.int8))):
        seen[("sync", name)] = _train(
            rank, lambda m, b: Sync(b, compression=comp()), 2)
        seen[("hook", name)] = _train(
            rank, lambda m, b: Eager(b, m.named_parameters(),
                                     compression=comp()), 2)
    seen[("sync", "adasum")] = _train(rank, lambda m, b: Sync(b, op=C.Adasum),
                                      2)
    seen[("hook", "adasum")] = _train(
        rank, lambda m, b: Eager(b, m.named_parameters(), op=C.Adasum), 2)

    # The reference's test_force_allreduce: rank r uses head r only.
    net = TwoHeads()
    local = TwoHeads()
    opt = F.DistributedOptimizer(torch.optim.SGD(net.parameters(), lr=LR),
                                 net.named_parameters())
    x = torch.from_numpy(_batch(rank, 7)[0])
    net(x, rank).sum().backward()
    local(x, rank).sum().backward()
    seen["force_local"] = {n: (p.grad.numpy().copy() if p.grad is not None
                               else np.zeros(p.shape, np.float32))
                           for n, p in local.named_parameters()}
    opt.synchronize()
    seen["force_reduced"] = _grads(net)
    opt.step()
    opt.remove_hooks()

    # synchronize(), then another backward before step(): that backward's
    # gradients are reduced as well.
    model = Mlp(_weights())
    eopt = Eager(torch.optim.SGD(model.parameters(), lr=LR),
                 model.named_parameters())
    _loss(model, _batch(rank, 0)).backward()
    eopt.synchronize()
    _loss(model, _batch(rank, 1)).backward()
    eopt.step()
    eopt.remove_hooks()
    seen["resync_params"] = _params(model)

    # EagerDistributedOptimizer.backward, the JAX twin's step (SGD).
    model = Mlp(_weights())
    eopt = Eager(torch.optim.SGD(model.parameters(), lr=LR),
                 model.named_parameters())
    losses = []
    for s in range(2):
        eopt.zero_grad()
        eopt.backward(_loss, model, _batch(rank, s))
        eopt.step()
        losses.append(float(eopt.last_loss()))
    seen["eager_params"] = _params(model)
    seen["eager_losses"] = losses

    seen["mnist"] = pytorch_mnist.main(
        ["--epochs", "1", "--samples", str(2 * 32 * world),
         "--device", "cpu"])
    seen["synthetic"] = psb.main(
        ["--model", "mlp", "--num-iters", "1", "--num-batches-per-iter", "1",
         "--batch-size", "4", "--image-size", "32", "--device", "cpu"])
    from horovod_tpu_torch.ops import eager as E
    seen["stats"] = E.engine_stats()
    return seen


def _jax_side():
    import jax.numpy as jnp
    import optax

    import horovod_tpu as hvd
    from horovod_tpu.optim.eager_optimizer import EagerDistributedOptimizer

    def loss_fn(p, batch):
        x, y = batch
        pred = jnp.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
        return jnp.mean((pred - y) ** 2)

    params = {k: jnp.asarray(v) for k, v in _weights().items()}
    opt = EagerDistributedOptimizer(optax.sgd(LR))
    state = opt.init(params)
    for s in range(2):
        b = [_batch(r, s) for r in range(WORLD)]
        batch = (jnp.concatenate([x for x, _ in b]),
                 jnp.concatenate([y for _, y in b]))
        opt.backward(loss_fn, params, batch)
        params, state = opt.step(params, state)
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def world():
    import jax

    import horovod_tpu as hvd

    env = {"HVD_TORCH_NATIVE_CONTROLLER": "on",
           "HVD_TORCH_CONTROLLER_TRANSPORT": f"tcp:127.0.0.1:{free_port()}"}
    join = start_world(_worker, WORLD, env=env)
    hvd.shutdown()
    hvd.init(devices=jax.devices()[:WORLD])
    try:
        jx = _jax_side()
    finally:
        hvd.shutdown()
        hvd.init()
    return join(timeout=120), jx


def _bit_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("case", ["Sum", "Average", "bpps", "ef_topk",
                                  "ef_int8", "adasum", "step_clip",
                                  "step_bpps"])
def test_hook_route_equals_sync_route_bit_for_bit(world, case):
    ranks, _ = world
    for seen in ranks:
        g_sync, p_sync = seen[("sync", case)]
        g_hook, p_hook = seen[("hook", case)]
        _bit_equal(g_hook, g_sync)
        _bit_equal(p_hook, p_sync)
    # Replicated: every rank reduced to the same gradients.
    _bit_equal(ranks[0][("hook", case)][0], ranks[1][("hook", case)][0])


def test_backward_after_synchronize_is_reduced_too(world):
    ranks, _ = world
    _bit_equal(ranks[0]["resync_params"], ranks[1]["resync_params"])
    start = _weights()
    assert any(not np.array_equal(ranks[0]["resync_params"][k], start[k])
               for k in start)


def test_force_allreduce_reduces_the_unused_head(world):
    ranks, _ = world
    want = {n: (ranks[0]["force_local"][n] + ranks[1]["force_local"][n]) / 2
            for n in ranks[0]["force_local"]}
    for seen in ranks:
        _bit_equal(seen["force_reduced"], want)
    # Each head got exactly one rank's gradient, halved.
    np.testing.assert_array_equal(
        want["head.1"], ranks[1]["force_local"]["head.1"] / 2)


def test_eager_optimizer_matches_jax(world):
    ranks, jx = world
    for seen in ranks:
        got = seen["eager_params"]
        for k, want in jx.items():
            np.testing.assert_allclose(got[k], want, rtol=JAX_RTOL,
                                       atol=JAX_RTOL * np.abs(want).max())
        assert all(np.isfinite(seen["eager_losses"]))
    _bit_equal(ranks[0]["eager_params"], ranks[1]["eager_params"])
    assert ranks[0]["eager_losses"] == ranks[1]["eager_losses"]


def test_example_twins_run_two_steps(world):
    ranks, _ = world
    assert ranks[0]["mnist"] == ranks[1]["mnist"]
    assert np.isfinite(ranks[0]["mnist"])
    for seen in ranks:
        assert len(seen["synthetic"]) == 1 and seen["synthetic"][0] > 0
        assert seen["stats"]["errors"] == 0
        assert seen["stats"]["tensors_fused"] > 0
