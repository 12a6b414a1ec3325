"""The port's input pipeline, callbacks and ``fit`` against the JAX package's.

* ``shard_indices``, ``ShardedLoader`` and the synthetic datasets: equal to
  the JAX package's exactly.  The JAX loader yields the rank-major global
  batch of an 8-rank world; the port's yields one rank's rows, so each
  rank r (``basics.rank``/``size`` stood in for) must yield rows
  ``[r·b, (r+1)·b)`` of it.
* The callbacks and schedules, mirroring ``tests/test_callbacks_checkpoint.py``
  on the port's ``(params, optimizer)`` state.
* Two gloo processes under ``torch.multiprocessing.spawn`` train
  ``MnistMLP`` through ``fit`` (broadcast and metric-average callbacks,
  ``ShardedLoader``, ``DistributedOptimizer(SGD(momentum=0.9))``) from the
  JAX model's weights, rank 1 starting from wrong ones that the broadcast
  repairs; in this process the JAX package's ``make_train_step`` on a
  2-device mesh takes the same rank-major batches.  The workers also
  check ``broadcast_optimizer_state``, ``make_eval_step`` and
  ``MetricAverageCallback`` across the two ranks.  They import only torch
  and the port.

Tolerances, f32 on both sides: per-epoch losses to rtol 1e-5 and each
parameter's update to 1e-4 of its largest (the same products summed in
another order over 32 steps).
"""

from __future__ import annotations

import os
import pickle
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
import torch.nn.functional as F

from horovod_tpu_torch import basics, callbacks, data, training
from horovod_tpu_torch.models.mnist import MnistMLP
from horovod_tpu_torch.models.convert import vision_state_dict_from_flax
from horovod_tpu_torch.optim.distributed_optimizer import (
    DistributedOptimizer, broadcast_optimizer_state)

WORLD, N, B, EPOCHS, LR, SEED = 2, 256, 16, 2, 0.05, 3
LOSS_RTOL = 1e-5
UPDATE_RTOL = 1e-4
LAUNCH_VARS = ("HOROVOD_TPU_PROCESS_ID", "HOROVOD_TPU_NUM_PROCESSES",
               "HOROVOD_TPU_COORDINATOR", "RANK", "WORLD_SIZE",
               "MASTER_ADDR", "MASTER_PORT")


@pytest.mark.parametrize("n,size,kw", [
    (64, 8, dict(shuffle=False)),
    (10, 4, dict(shuffle=False)),
    (10, 4, dict(shuffle=False, drop_last=True)),
    (3, 8, dict(shuffle=False)),
    (64, 8, dict(seed=1, epoch=0)),
    (64, 8, dict(seed=1, epoch=1)),
    (1000, 3, dict(seed=5, epoch=2)),
    (1000, 3, dict(seed=5, epoch=2, drop_last=True)),
])
def test_shard_indices_equal_jax(n, size, kw):
    from horovod_tpu.data import shard_indices as jshard

    for r in range(size):
        np.testing.assert_array_equal(data.shard_indices(n, r, size, **kw),
                                      jshard(n, r, size, **kw))


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("device_put", [False, True])
def test_sharded_loader_yields_this_ranks_rows_of_jax_batch(
        monkeypatch, prefetch, device_put):
    """Rank r's batch s is rows [r·b, (r+1)·b) of the JAX loader's batch s,
    over two epochs (reshuffled by ``set_epoch``), numpy with
    ``device_put=False`` and CPU tensors with ``device="cpu"``."""
    import horovod_tpu as hvd
    from horovod_tpu.data import ShardedLoader as JLoader

    size, b = hvd.size(), 3
    tree = {"x": np.arange(100 * 2, dtype=np.float32).reshape(100, 2),
            "y": np.arange(100, dtype=np.int64)}
    jl = JLoader(tree, b, seed=7, prefetch=0, device_put=False)
    monkeypatch.setattr(basics, "size", lambda: size)
    for r in range(size):
        monkeypatch.setattr(basics, "rank", lambda r=r: r)
        tl = data.ShardedLoader(tree, b, seed=7, prefetch=prefetch,
                                device_put=device_put, device="cpu")
        assert len(tl) == len(jl) == 100 // size // b
        for epoch in range(2):
            jl.set_epoch(epoch)
            tl.set_epoch(epoch)
            got = list(tl)
            assert len(got) == len(jl)
            for mine, whole in zip(got, jl):
                for key in ("x", "y"):
                    assert isinstance(mine[key], torch.Tensor) == device_put
                    np.testing.assert_array_equal(
                        np.asarray(mine[key]),
                        whole[key][r * b:(r + 1) * b])


def test_sharded_loader_rejects_bad_trees():
    with pytest.raises(ValueError, match="share"):
        data.ShardedLoader((np.zeros(4), np.zeros(5)), 1, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        data.ShardedLoader((), 1, device="cpu")
    with pytest.raises(ValueError, match="prefetch"):
        data.ShardedLoader((np.zeros(4),), 1, prefetch=-1, device="cpu")


def test_sharded_loader_abandoned_iterator_stops_its_producer(monkeypatch):
    """Breaking mid-epoch stops the prefetch thread (no thread left)."""
    import threading

    monkeypatch.setattr(basics, "size", lambda: 1)
    monkeypatch.setattr(basics, "rank", lambda: 0)
    loader = data.ShardedLoader((np.arange(64),), 1, prefetch=1,
                                device="cpu")
    it = iter(loader)
    next(it)
    it.close()
    for t in threading.enumerate():
        if t.name == "horovod_tpu_torch-prefetch":
            t.join(timeout=5)
            assert not t.is_alive()


@pytest.mark.parametrize("fn,kw", [
    ("synthetic_mnist", dict(n=300, seed=0)),
    ("synthetic_mnist", dict(n=64, seed=9)),
    ("synthetic_imagenet", dict(n=4, image_size=32, num_classes=100, seed=1)),
])
def test_synthetic_data_is_bit_equal(fn, kw):
    from horovod_tpu import data as jdata

    for mine, want in zip(getattr(data, fn)(**kw), getattr(jdata, fn)(**kw)):
        assert mine.dtype == want.dtype and mine.shape == want.shape
        assert mine.tobytes() == want.tobytes()


def test_prefetch_to_device_yields_every_item_in_order():
    items = [(np.full((2,), i, np.float32), torch.full((3,), i))
             for i in range(5)]
    out = list(data.prefetch_to_device(iter(items), size=2, device="cpu"))
    assert len(out) == 5
    for i, (a, b) in enumerate(out):
        assert isinstance(a, torch.Tensor) and a.tolist() == [i, i]
        assert b.tolist() == [i] * 3
    with pytest.raises(ValueError, match="size"):
        data.prefetch_to_device(iter(items), size=0, device="cpu")


# Callbacks: the schedules and LR callbacks of test_callbacks_checkpoint.py.


def test_warmup_schedule_ramp():
    sched = callbacks.warmup_schedule(0.1, size=8, warmup_epochs=5,
                                      steps_per_epoch=10)
    np.testing.assert_allclose(sched(0), 0.1, rtol=1e-6)
    np.testing.assert_allclose(sched(25), 0.1 * (1 + 0.5 * 7), rtol=1e-6)
    np.testing.assert_allclose(sched(50), 0.8, rtol=1e-6)
    np.testing.assert_allclose(sched(500), 0.8, rtol=1e-6)


def test_multiplier_schedule_staircase_window():
    sched = callbacks.multiplier_schedule(
        0.1, lambda e: 0.5 ** e, start_epoch=1, end_epoch=3,
        steps_per_epoch=10, staircase=True)
    assert [round(sched(s), 9) for s in (5, 10, 25, 30)] == [
        0.1, 0.05, 0.025, 0.1]


def test_schedules_equal_jax():
    """Both schedules drive ``LambdaLR`` to the JAX package's values."""
    import horovod_tpu as hvd

    kw = dict(steps_per_epoch=7)
    pairs = [
        (callbacks.warmup_schedule(0.1, size=4, warmup_epochs=3, **kw),
         hvd.warmup_schedule(0.1, size=4, warmup_epochs=3, **kw)),
        (callbacks.multiplier_schedule(0.2, lambda e: 0.9 ** e,
                                       start_epoch=1, end_epoch=4, **kw),
         hvd.multiplier_schedule(0.2, lambda e: 0.9 ** e, start_epoch=1,
                                 end_epoch=4, **kw)),
    ]
    for mine, want in pairs:
        p = torch.nn.Parameter(torch.zeros(1))
        opt = torch.optim.SGD([p], lr=1.0)
        sched = torch.optim.lr_scheduler.LambdaLR(opt, mine)
        for step in range(40):
            np.testing.assert_allclose(opt.param_groups[0]["lr"],
                                       float(want(step)), rtol=1e-6)
            opt.step()
            sched.step()


def _sgd_state(lr=0.4):
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9)
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    return model, opt


def test_lr_schedule_momentum_correction_scales_sgd_buffers():
    """The LR steps from 0.4 to 0.04: the callback sets every group's LR and
    multiplies each momentum buffer by 0.1 (``_keras/callbacks.py:126-138``)."""
    model, opt = _sgd_state()
    before = [opt.state[p]["momentum_buffer"].clone()
              for p in model.parameters()]
    cb = callbacks.LearningRateScheduleCallback(
        0.4, lambda e: 0.1 if e >= 1 else 1.0)
    state = cb.on_epoch_begin(0, (model, opt))
    assert opt.param_groups[0]["lr"] == pytest.approx(0.4)
    state = cb.on_epoch_begin(1, state)
    assert opt.param_groups[0]["lr"] == pytest.approx(0.04)
    for p, old in zip(model.parameters(), before):
        torch.testing.assert_close(opt.state[p]["momentum_buffer"], old * 0.1)


def test_lr_schedule_callback_with_custom_hooks():
    events = []
    cb = callbacks.LearningRateScheduleCallback(
        0.4, lambda e: 0.1 if e >= 1 else 1.0,
        set_lr=lambda s, lr: (events.append(("lr", lr)), s)[1],
        scale_momentum=lambda s, f: (events.append(("mom", round(f, 6))),
                                     s)[1])
    s = cb.on_epoch_begin(1, cb.on_epoch_begin(0, {}))
    assert s == {}
    np.testing.assert_allclose([v for k, v in events if k == "lr"],
                               [0.4, 0.04], rtol=1e-6)
    assert ("mom", 0.1) in events


def test_warmup_callback_sets_the_optimizer_lr():
    model, opt = _sgd_state(lr=0.1)
    warm = callbacks.LearningRateWarmupCallback(0.1, warmup_epochs=4, size=8)
    warm.on_epoch_begin(2, (model, opt))
    np.testing.assert_allclose(opt.param_groups[0]["lr"],
                               0.1 * (1 + 0.5 * 7), rtol=1e-6)
    warm.on_epoch_begin(9, (model, opt))       # past the ramp: untouched
    np.testing.assert_allclose(opt.param_groups[0]["lr"],
                               0.1 * (1 + 0.5 * 7), rtol=1e-6)


def test_stacked_windowed_callbacks_no_clobber():
    sets = []

    def mk(tag):
        return lambda s, lr: (sets.append((tag, lr)), s)[1]

    warm = callbacks.LearningRateWarmupCallback(0.1, warmup_epochs=5, size=8,
                                                set_lr=mk("warm"))
    sched = callbacks.LearningRateScheduleCallback(
        0.8, 0.1, start_epoch=30, end_epoch=60, set_lr=mk("sched"))
    state = {}
    for epoch in [0, 3, 10, 35]:
        state = sched.on_epoch_begin(epoch, warm.on_epoch_begin(epoch, state))
    assert [t for t, _ in sets] == ["warm", "warm", "sched"]
    np.testing.assert_allclose(sets[2][1], 0.08, rtol=1e-6)


def test_default_hooks_need_fits_state():
    cb = callbacks.LearningRateWarmupCallback(0.1, size=2)
    with pytest.raises(TypeError, match="optimizer"):
        cb.on_epoch_begin(0, {"w": torch.ones(1)})


def test_model_checkpoint_callback_waits_for_checkpoint_port():
    """The callback of the port of ``checkpoint.py``: the JAX package's
    keywords and their check (its runs are in test_torch_checkpoint.py)."""
    cb = callbacks.ModelCheckpointCallback("/nonexistent", every_epochs=3,
                                           async_save=True)
    assert (cb.path, cb.every_epochs, cb.async_save) == ("/nonexistent", 3,
                                                         True)
    with pytest.raises(ValueError, match="every_epochs"):
        callbacks.ModelCheckpointCallback("/nonexistent", every_epochs=0)


@pytest.fixture
def world_of_one(monkeypatch):
    for name in LAUNCH_VARS:
        monkeypatch.delenv(name, raising=False)
    basics.init("cpu")
    yield
    basics.shutdown()


def test_broadcast_optimizer_state_numpy_leaves(world_of_one):
    """numpy leaves round-trip by value, scalars keep their types
    (``test_callbacks_checkpoint.py::test_broadcast_optimizer_state_numpy_leaves``)."""
    state = {"v": np.asarray([1.5, 2.5], np.float32),
             "steps": np.asarray([2, 3], np.int64),
             "count": np.int64(7), "lr": 0.1, "t": torch.arange(3.0)}
    out = broadcast_optimizer_state(state)
    assert isinstance(out["v"], np.ndarray) and out["v"].dtype == np.float32
    np.testing.assert_allclose(out["v"], [1.5, 2.5])
    assert out["steps"].tolist() == [2, 3]
    assert int(out["count"]) == 7 and out["lr"] == 0.1
    assert torch.equal(out["t"], torch.arange(3.0))


def test_broadcast_optimizer_state_loads_a_torch_optimizer(world_of_one):
    """An optimizer (or its ``DistributedOptimizer``) gets the root's
    ``state_dict`` loaded back in place, ``step`` included."""
    p = torch.nn.Parameter(torch.ones(4))
    opt = DistributedOptimizer(torch.optim.Adam([p], lr=0.1))
    p.sum().backward()
    opt.step()
    want = {k: v.clone() for k, v in opt.optimizer.state[p].items()}
    assert broadcast_optimizer_state(opt) is opt
    for k, v in want.items():
        torch.testing.assert_close(opt.optimizer.state[p][k], v)


def test_make_eval_step_and_average_metrics_in_a_world_of_one(world_of_one):
    step = training.make_eval_step(
        lambda params, batch: {"acc": batch.mean(), "twice": 2 * batch.mean()})
    out = step({}, torch.full((2, 3), 3.0))
    assert out == {"acc": pytest.approx(3.0), "twice": pytest.approx(6.0)}
    got = callbacks.MetricAverageCallback().on_epoch_end(
        0, None, {"loss": torch.tensor(0.25), "global_step": 5, "tag": "x"})
    assert got == {"loss": pytest.approx(0.25), "global_step": 5, "tag": "x"}


def _mlp_loss(model, batch):
    x, y = batch
    return F.cross_entropy(model(x), y)


def test_fit_initial_epoch_and_eval_metrics(world_of_one):
    """Only epochs [initial_epoch, epochs) run, and epoch-indexed callbacks
    see the true epoch; eval metrics land in the history as ``val_*``."""
    seen = []

    class EpochSpy(callbacks.Callback):
        def on_epoch_begin(self, epoch, state):
            seen.append(epoch)
            return state

    images, labels = data.synthetic_mnist(128)
    model = MnistMLP(hidden=32, device="cpu")
    opt = DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.05,
                                               momentum=0.9))

    def accuracy(model, batch):
        x, y = batch
        return {"accuracy": (model(x).argmax(-1) == y).float().mean()}

    _, _, history = training.fit(
        model, opt, _mlp_loss,
        data.ShardedLoader((images, labels), 16, device="cpu"),
        epochs=5, initial_epoch=3, callbacks=[EpochSpy()],
        eval_loader=data.ShardedLoader((images, labels), 32, shuffle=False,
                                       device="cpu"),
        eval_metric_fn=accuracy, verbose=False)
    assert seen == [3, 4] and len(history) == 2
    assert set(history[0]) == {"loss", "val_accuracy"}
    assert 0.0 <= history[1]["val_accuracy"] <= 1.0


def _worker(rank: int, port: int, tree_path: str, out_dir: str) -> None:
    os.environ.update(
        HOROVOD_TPU_PROCESS_ID=str(rank), HOROVOD_TPU_NUM_PROCESSES=str(WORLD),
        HOROVOD_TPU_COORDINATOR=f"127.0.0.1:{port}")
    basics.init("cpu")
    with open(tree_path, "rb") as f:
        variables = pickle.load(f)
    out = {}

    model = MnistMLP(device="cpu")
    model.load_state_dict(vision_state_dict_from_flax(variables))
    if rank == 1:           # a wrong start that the broadcast must repair
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    opt = DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=LR,
                                               momentum=0.9))
    images, labels = data.synthetic_mnist(N, seed=SEED)
    loader = data.ShardedLoader((images, labels), B, seed=SEED, device="cpu")
    _, _, history = training.fit(
        model, opt, _mlp_loss, loader, epochs=EPOCHS,
        callbacks=[callbacks.BroadcastGlobalVariablesCallback(0),
                   callbacks.MetricAverageCallback()], verbose=False)
    out["history"] = history
    out["params"] = {k: v.detach().numpy().copy()
                     for k, v in model.state_dict().items()}

    # The root's Adam state (step included) reaches a rank with none.
    p = torch.nn.Parameter(torch.arange(4.0))
    adam = torch.optim.Adam([p], lr=0.1)
    if rank == 0:
        (p * p).sum().backward()
        adam.step()
    broadcast_optimizer_state(adam, root_rank=0)
    out["adam"] = {k: v.clone() for k, v in adam.state[p].items()}

    step = training.make_eval_step(
        lambda params, batch: {"acc": batch.float().mean()})
    out["eval"] = step({}, torch.full((2,), float(rank)))
    out["averaged"] = callbacks.MetricAverageCallback().on_epoch_end(
        0, None, {"loss": torch.tensor(float(rank)), "global_step": 5})
    basics.shutdown()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _jax_run(variables):
    """Per-epoch mean losses and final parameters of JAX ``make_train_step``
    on a 2-device mesh over the rank-major batches the port's ranks take."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh

    import horovod_tpu as hvd
    from horovod_tpu.models.mnist import MnistMLP as JMnistMLP

    model = JMnistMLP()

    def loss_fn(params, batch):
        x, y = batch
        logits = model.apply({"params": params}, x)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()

    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("hvd",))
    tx = hvd.DistributedOptimizer(optax.sgd(LR, momentum=0.9))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    opt_state = tx.init(params)
    step = hvd.make_train_step(loss_fn, tx, mesh=mesh, donate=False)
    images, labels = data.synthetic_mnist(N, seed=SEED)
    per_rank = N // WORLD // B
    losses = []
    for epoch in range(EPOCHS):
        shards = [data.shard_indices(N, r, WORLD, seed=SEED, epoch=epoch,
                                     drop_last=True) for r in range(WORLD)]
        epoch_losses = []
        for s in range(per_rank):
            idx = np.concatenate([sh[s * B:(s + 1) * B] for sh in shards])
            out = step(params, opt_state,
                       (jnp.asarray(images[idx]), jnp.asarray(labels[idx])))
            params, opt_state = out.params, out.opt_state
            epoch_losses.append(float(out.loss))
        losses.append(float(np.mean(epoch_losses)))
    return losses, jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """(initial variables, JAX run, port results per rank).  The two port
    ranks train while this process runs the JAX side."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models.mnist import MnistMLP as JMnistMLP

    variables = jax.tree_util.tree_map(np.asarray, JMnistMLP().init(
        jax.random.PRNGKey(42), jnp.zeros((1, 28, 28, 1))))
    out = tmp_path_factory.mktemp("fit")
    tree_path = out / "variables.pkl"
    with open(tree_path, "wb") as f:
        pickle.dump(variables, f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.start_processes(_worker, args=(port, str(tree_path), str(out)),
                             nprocs=WORLD, join=False, start_method="spawn")
    jax_run = _jax_run(variables)
    while not ctx.join():
        pass
    ranks = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return variables, jax_run, ranks


def test_two_rank_fit_losses_match_jax_make_train_step(sides):
    _, (losses, _), ranks = sides
    for seen in ranks:
        assert [set(h) for h in seen["history"]] == [{"loss"}] * EPOCHS
        np.testing.assert_allclose([h["loss"] for h in seen["history"]],
                                   losses, rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]


def test_two_rank_fit_params_match_jax_and_each_other(sides):
    """Each parameter's update (final − initial) against JAX's; both ranks
    hold the same parameters (rank 1 started wrong)."""
    variables, (_, final), ranks = sides
    start = vision_state_dict_from_flax(variables)
    want = vision_state_dict_from_flax({"params": final})
    for key, w in want.items():
        delta = (w - start[key]).numpy()
        for seen in ranks:
            np.testing.assert_allclose(
                seen["params"][key] - start[key].numpy(), delta, rtol=0,
                atol=UPDATE_RTOL * float(np.abs(delta).max()), err_msg=key)
        np.testing.assert_array_equal(ranks[0]["params"][key],
                                      ranks[1]["params"][key])


def test_two_rank_broadcast_optimizer_state(sides):
    _, _, ranks = sides
    root, other = ranks[0]["adam"], ranks[1]["adam"]
    assert set(root) == set(other) == {"step", "exp_avg", "exp_avg_sq"}
    assert float(other["step"]) == 1.0
    for k in root:
        torch.testing.assert_close(other[k], root[k])


def test_two_rank_eval_step_and_metric_average(sides):
    _, _, ranks = sides
    for seen in ranks:
        assert seen["eval"] == {"acc": pytest.approx(0.5)}
        assert seen["averaged"] == {"loss": pytest.approx(0.5),
                                    "global_step": pytest.approx(5.0)}
