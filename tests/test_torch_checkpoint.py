"""The port's checkpoints: ``save_checkpoint`` (sync and async),
``list_checkpoints``, ``latest_checkpoint``, ``restore_checkpoint``,
``load_model``, ``ModelCheckpointCallback`` and the MNIST twin's
``--ckpt-dir``.  Mirrors ``tests/test_callbacks_checkpoint.py:111-166``;
a 2-process gloo world holds the root-only read, the agreed listing, a
failed read raising on every rank and a compressor's state riding
``broadcast_optimizer_state``.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu_torch import basics, callbacks, checkpoint
from horovod_tpu_torch.data import ShardedLoader, synthetic_mnist
from horovod_tpu_torch.examples import mnist
from horovod_tpu_torch.models.mnist import MnistMLP
from horovod_tpu_torch.ops.powersgd import PowerSGDCompressor
from horovod_tpu_torch.optim.distributed_optimizer import (
    DistributedOptimizer, broadcast_optimizer_state)
from horovod_tpu_torch.training import fit
from torch_gloo_world import start_world

LAUNCH_VARS = ("HOROVOD_TPU_PROCESS_ID", "HOROVOD_TPU_NUM_PROCESSES",
               "HOROVOD_TPU_COORDINATOR", "RANK", "WORLD_SIZE",
               "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture
def world_of_one(monkeypatch):
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    basics.init("cpu")
    yield
    basics.shutdown()


def _state():
    return {"params": {"w": torch.arange(6.0).reshape(2, 3),
                       "b": torch.tensor([1, 2], dtype=torch.int32)},
            "step": 3, "name": "run", "betas": (0.9, 0.95)}


def _assert_state_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], dict):
            _assert_state_equal(got[k], want[k])
        elif isinstance(want[k], torch.Tensor):
            assert got[k].dtype == want[k].dtype
            assert torch.equal(got[k].cpu(), want[k])
        else:
            assert got[k] == want[k]


def test_checkpoint_roundtrip(world_of_one, tmp_path):
    base = str(tmp_path / "ckpt")
    p1 = checkpoint.save_checkpoint(base, _state(), step=1)
    p2 = checkpoint.save_checkpoint(base, _state(), step=12)
    assert p1.endswith("step_1") and p2.endswith("step_12")
    assert checkpoint.latest_checkpoint(base).endswith("step_12")
    _assert_state_equal(checkpoint.restore_checkpoint(p2), _state())


def test_async_checkpoint_roundtrip(world_of_one, tmp_path):
    """async_save returns once the state is on the host; a later change to
    the tensors does not reach the file; wait_for_checkpoints flushes."""
    state = _state()
    target = checkpoint.save_checkpoint(str(tmp_path / "ck"), state, step=1,
                                        async_save=True)
    state["params"]["w"].add_(100.0)
    checkpoint.wait_for_checkpoints()
    found = checkpoint.latest_checkpoint(str(tmp_path / "ck"))
    assert found == target and found.endswith("step_1")
    _assert_state_equal(checkpoint.restore_checkpoint(found), _state())


def test_list_checkpoints_newest_first(world_of_one, tmp_path):
    base = tmp_path / "many"
    for s in (3, 12, 1):
        checkpoint.save_checkpoint(str(base), {"s": s}, step=s)
    (base / "step_x").write_text("not a checkpoint")
    (base / "notes").write_text("")
    names = [os.path.basename(p)
             for p in checkpoint.list_checkpoints(str(base))]
    assert names == ["step_12", "step_3", "step_1"]
    assert checkpoint.list_checkpoints(str(tmp_path / "none")) == []
    assert checkpoint.latest_checkpoint(str(tmp_path / "none")) is None


def _mlp_and_sgd(seed, compression=None):
    model = MnistMLP(device="cpu", seed=seed)
    sgd = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    if compression is None:
        return model, sgd
    return model, DistributedOptimizer(sgd, compression=compression)


def _one_step(model, opt):
    x = torch.from_numpy(np.random.RandomState(0).rand(8, 28, 28, 1)
                         .astype(np.float32))
    y = torch.arange(8) % 10
    F.cross_entropy(model(x), y).backward()
    opt.step()
    opt.zero_grad()


def test_load_model_rewraps_optimizer(world_of_one, tmp_path):
    """``load_model`` returns a ``DistributedOptimizer`` around the given
    optimizer, holding the saved state (reference keras/__init__.py:
    115-148)."""
    model, sgd = _mlp_and_sgd(1)
    _one_step(model, DistributedOptimizer(sgd))
    path = checkpoint.save_checkpoint(str(tmp_path / "m"),
                                      {"model": model, "opt": sgd}, step=0)
    model2, sgd2 = _mlp_and_sgd(2)
    state, dopt = checkpoint.load_model(
        path, sgd2, template={"model": model2, "opt": sgd2})
    assert isinstance(dopt, DistributedOptimizer) and dopt.optimizer is sgd2
    assert state["model"] is model2 and state["opt"] is dopt
    for a, b in zip(model.parameters(), model2.parameters()):
        assert torch.equal(a, b)
    buf = [s["momentum_buffer"] for s in sgd.state.values()]
    buf2 = [s["momentum_buffer"] for s in sgd2.state.values()]
    assert all(torch.equal(a, b) for a, b in zip(buf, buf2))
    restored, plain = checkpoint.load_model(path, torch.optim.SGD(
        model2.parameters(), lr=0.1))
    assert isinstance(plain, DistributedOptimizer)
    assert set(restored) == {"model", "opt"}


def test_powersgd_state_rides_the_checkpoint(world_of_one, tmp_path):
    """A stateful compressor's state (PowerSGD's Q and residuals) is saved
    with the optimizer and restored bit for bit into a template."""
    comp = PowerSGDCompressor(rank=2, min_compress_size=64)
    model, dopt = _mlp_and_sgd(1, comp)
    for _ in range(2):
        _one_step(model, dopt)
    assert "compression" in dopt.state_dict()
    path = checkpoint.save_checkpoint(str(tmp_path / "p"), (model, dopt),
                                      step=2)
    model2, dopt2 = _mlp_and_sgd(3, PowerSGDCompressor(rank=2,
                                                       min_compress_size=64))
    out = checkpoint.restore_checkpoint(path, (model2, dopt2))
    assert out[0] is model2 and out[1] is dopt2
    for s, t in zip(dopt.comp_state, dopt2.comp_state, strict=True):
        for a, b in zip(*(x if isinstance(x, tuple) else (x,)
                          for x in (s, t))):
            assert torch.equal(a, b)
    assert sum(isinstance(s, tuple) for s in dopt2.comp_state) >= 1
    sd = DistributedOptimizer(torch.optim.SGD(model2.parameters(), lr=0.1)
                              ).state_dict()
    assert "compression" not in sd     # the format is unchanged otherwise


@pytest.mark.parametrize("saved_stateful", [True, False])
def test_compression_state_mismatch_raises(world_of_one, saved_stateful):
    """A saved compressor state must meet a stateful wrapper and only one:
    a PowerSGD state into a plain wrapper (or one with ``local=True``)
    would be dropped, a plain state into a PowerSGD wrapper would keep the
    fresh factors, so both raise ``ValueError``."""
    comp = PowerSGDCompressor(rank=2, min_compress_size=64)
    model, sgd = _mlp_and_sgd(1)
    kw = {"compression": comp} if saved_stateful else {}
    saved = DistributedOptimizer(sgd, **kw)
    _one_step(model, saved)
    sd = saved.state_dict()
    assert ("compression" in sd) is saved_stateful
    targets = ([DistributedOptimizer(_mlp_and_sgd(2)[1]),
                DistributedOptimizer(_mlp_and_sgd(2)[1], compression=comp,
                                     local=True)]
               if saved_stateful else
               [DistributedOptimizer(_mlp_and_sgd(2)[1], compression=comp)])
    for target in targets:
        with pytest.raises(ValueError, match="stateful"):
            target.load_state_dict(sd)


def test_model_checkpoint_callback(world_of_one, tmp_path):
    """Inside ``fit``: ``step_<epoch>`` appears every ``every_epochs`` and
    the latest restores to the trained weights."""
    with pytest.raises(ValueError, match="every_epochs"):
        callbacks.ModelCheckpointCallback(str(tmp_path), every_epochs=0)
    model, sgd = _mlp_and_sgd(0)
    opt = DistributedOptimizer(sgd)
    images, labels = synthetic_mnist(64)
    loader = ShardedLoader((images, labels), 16, seed=1, device="cpu")

    def loss_fn(m, batch):
        return F.cross_entropy(m(batch[0]), batch[1])

    base = tmp_path / "cb"
    cb = callbacks.ModelCheckpointCallback(str(base), every_epochs=2,
                                           async_save=True)
    fit(model, opt, loss_fn, loader, epochs=4, callbacks=[cb], verbose=False)
    checkpoint.wait_for_checkpoints()
    assert sorted(os.listdir(base)) == ["step_1", "step_3"]
    model2, sgd2 = _mlp_and_sgd(9)
    checkpoint.restore_checkpoint(checkpoint.latest_checkpoint(str(base)),
                                  (model2, DistributedOptimizer(sgd2)))
    for a, b in zip(model.parameters(), model2.parameters()):
        assert torch.equal(a, b)


def test_mnist_twin_ckpt_dir(monkeypatch, tmp_path):
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    losses = mnist.main(["--smoke", "--device", "cpu", "--ckpt-dir",
                         str(tmp_path)])
    assert len(losses) == 2
    assert sorted(os.listdir(tmp_path)) == ["step_0", "step_1"]
    saved = torch.load(tmp_path / "step_1", weights_only=True)
    assert set(saved) == {"params", "opt"}
    assert {"state", "param_groups"} <= set(saved["opt"])


def _restore_worker(rank, world, base):
    seen = {}
    state = {"w": torch.full((3,), 7.0), "step": 5}
    seen["saved"] = checkpoint.save_checkpoint(base, state, step=4)
    checkpoint.save_checkpoint(base, state, step=9)
    seen["listed"] = checkpoint.list_checkpoints(base)
    latest = checkpoint.latest_checkpoint(base)
    template = {"w": torch.full((3,), float(-rank)), "step": -1}
    seen["restored"] = checkpoint.restore_checkpoint(latest, template)
    seen["no_template"] = checkpoint.restore_checkpoint(latest)
    bad = os.path.join(base, "step_77")
    if rank == 0:
        with open(bad, "wb") as f:
            f.write(b"torn")
    seen["errors"] = []
    for path, tmpl in ((bad, template), (os.path.join(base, "gone"), None)):
        try:
            checkpoint.restore_checkpoint(path, tmpl)
        except RuntimeError as e:
            seen["errors"].append(str(e))
    # A stateful compressor's state rides broadcast_optimizer_state.
    model, dopt = _mlp_and_sgd(rank, PowerSGDCompressor(
        rank=2, min_compress_size=64, seed=rank))
    _one_step(model, dopt)
    broadcast_optimizer_state(dopt, root_rank=0)
    seen["comp_state"] = [tuple(t.clone() for t in s) if isinstance(s, tuple)
                          else s.clone() for s in dopt.comp_state]
    seen["alive"] = float(torch.ones(1).sum())
    return seen


def test_two_ranks_root_reads_and_failures_agree(tmp_path):
    """Rank 0 alone writes; every rank lists the root's view; a template
    restore gives every rank the root's values; a torn file (read by the
    root alone) and a missing one (read by every rank) raise the same
    RuntimeError on both ranks, and the world goes on."""
    ranks = start_world(_restore_worker, 2, str(tmp_path / "ck"))()
    assert ranks[0]["saved"].endswith("step_4") and ranks[1]["saved"] is None
    for seen in ranks:
        assert [os.path.basename(p) for p in seen["listed"]] == [
            "step_9", "step_4"]
        assert torch.equal(seen["restored"]["w"], torch.full((3,), 7.0))
        assert seen["restored"]["step"] == 5
        assert torch.equal(seen["no_template"]["w"], torch.full((3,), 7.0))
        assert len(seen["errors"]) == 2
        assert "rank 0" in seen["errors"][0]
        assert "rank 0" in seen["errors"][1] and "rank 1" in seen["errors"][1]
    assert ranks[0]["errors"] == ranks[1]["errors"]
    for a, b in zip(ranks[0]["comp_state"], ranks[1]["comp_state"],
                    strict=True):
        for x, y in zip(*((t,) if isinstance(t, torch.Tensor) else t
                          for t in (a, b))):
            assert torch.equal(x, y)
