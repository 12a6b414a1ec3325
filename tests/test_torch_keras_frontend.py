"""Port parity: the Keras 3 frontend on the torch backend
(``horovod_tpu_torch.keras``, ``keras.callbacks``, ``keras_elastic``).

Mirrors tests/test_keras_frontend.py and the two-rank Keras test
(tests/test_multiprocess.py ``test_keras_frontend_two_ranks``).  Keras
fixes its backend at its first import, and this process imports it on the
JAX backend for the JAX frontend, so the port's Keras code runs only in a
gloo world of two spawned processes started with ``KERAS_BACKEND=torch``
(``tests/torch_keras_worker.py``), which runs every case and returns its
results.  The JAX package's single-controller regime
(``keras.distribution.DataParallel``) has no port; its cases become the
multi-process ones: ``apply`` averages the ranks' gradients, the value
ops reduce over two ranks.

The oracle: the same Dense model from the same numpy weights on the same
seeded data, fit for 3 steps with the broadcast, metric-average and
warm-up callbacks, by the JAX frontend's single-controller fit over 2 CPU
devices (in this process, the JAX world cut to those 2) and by the port's
two ranks, each on its half of every batch: weights within 1e-5 (f32),
the per-epoch losses within 1e-5, the LR schedules equal.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

os.environ.setdefault("KERAS_BACKEND", "jax")

import jax  # noqa: E402
import keras  # noqa: E402

import horovod_tpu as jhvd  # noqa: E402
import horovod_tpu.keras as jhvdk  # noqa: E402
import torch_keras_worker as worker  # noqa: E402
from torch_gloo_world import start_world  # noqa: E402

ATOL = 1e-5


def _jax_oracle() -> dict:
    """The JAX frontend's single-controller fit over 2 devices."""
    o = worker.ORACLE
    x, y = worker.data(n=o["n"], seed=7)
    jhvd.shutdown()
    jhvd.init(devices=jax.devices()[:2])
    keras.distribution.set_distribution(
        keras.distribution.DataParallel(devices=jax.devices()[:2]))
    try:
        keras.utils.set_random_seed(0)
        model = keras.Sequential([keras.Input((6,)),
                                  keras.layers.Dense(8, activation="relu"),
                                  keras.layers.Dense(2)])
        model.set_weights(worker.init_weights())
        model.compile(optimizer=jhvdk.DistributedOptimizer(
            keras.optimizers.SGD(learning_rate=o["lr"],
                                 momentum=o["momentum"])), loss="mse")
        hist = model.fit(
            x, y, batch_size=o["n"], epochs=o["epochs"], shuffle=False,
            verbose=0, callbacks=[
                jhvdk.callbacks.BroadcastGlobalVariablesCallback(0),
                jhvdk.callbacks.MetricAverageCallback(),
                jhvdk.callbacks.LearningRateWarmupCallback(
                    warmup_epochs=o["warmup_epochs"], steps_per_epoch=1)])
        return {"weights": [np.asarray(w) for w in model.get_weights()],
                "loss": hist.history["loss"], "lr": hist.history["lr"]}
    finally:
        keras.distribution.set_distribution(None)
        jhvd.shutdown()
        jhvd.init()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    assert keras.backend.backend() == "jax", keras.backend.backend()
    join = start_world(worker.keras_world, 2,
                       str(tmp_path_factory.mktemp("keras")),
                       env={"KERAS_BACKEND": "torch"})
    jx = _jax_oracle()
    return join(timeout=240), jx


def _case(world, name, rank=0):
    res = world[0][rank][name]
    assert "error" not in res, res.get("error")
    return res


def test_world_runs_keras_on_the_torch_backend(world):
    """Keras on the torch backend on the ranks' device, with JAX and the
    JAX package refused (and not imported) in those processes."""
    for r in world[0]:
        assert r["backend"] == "torch" and r["device"] == "cpu"
        assert r["jax_free"]


def test_distributed_optimizer_wraps_and_fits(world):
    for rank in (0, 1):
        out = _case(world, "wraps_and_fits", rank)
        assert out["name"] == "DistributedSGD" and out["is_sgd"]
        assert out["losses"][-1] < out["losses"][0], out["losses"]
        assert "already" in out["rewrap"]
        assert out["on_device"] == "cpu"


def test_apply_averages_the_ranks_gradients(world):
    """The port's counterpart of the single-controller pass-through: rank
    r hands ``apply`` gradients of 2·(r + 1); both ranks step by their
    mean, 3, at lr 1."""
    for rank in (0, 1):
        assert max(_case(world, "apply_averages_gradients",
                         rank)["deltas"]) <= 1e-6


def test_distributed_optimizer_preserves_built_state(world):
    out = _case(world, "preserves_built_state")
    assert out["it"] == 4 and out["wrapped_it"] == 4
    assert out["built"] and out["equal"]


def test_two_rank_fit_matches_the_jax_frontend(world):
    """The oracle: weights after 3 steps within 1e-5 of the JAX
    single-controller fit's, equal on both ranks; losses averaged by the
    metric callback; the warm-up LR schedule equal."""
    results, jx = world
    for rank in (0, 1):
        out = _case(world, "two_rank_fit_with_callbacks", rank)
        for got, want in zip(out["weights"], jx["weights"]):
            np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
        np.testing.assert_allclose(out["loss"], jx["loss"], rtol=0,
                                   atol=ATOL)
        assert out["lr"] == jx["lr"], (out["lr"], jx["lr"])
    w0 = results[0]["two_rank_fit_with_callbacks"]["weights"]
    w1 = results[1]["two_rank_fit_with_callbacks"]["weights"]
    assert all(np.array_equal(a, b) for a, b in zip(w0, w1))


def test_warmup_callback_ramps_lr_to_initial(world):
    out = _case(world, "warmup_ramps_lr")
    lrs, base_lr = out["lrs"], 0.08
    assert len(lrs) == 3
    assert lrs[0] < lrs[1] <= base_lr + 1e-9, lrs
    assert lrs[1] == pytest.approx(base_lr, rel=1e-5), lrs
    assert lrs[2] == pytest.approx(base_lr, rel=1e-5), lrs
    assert out["size"] == 2 and lrs[0] > base_lr / out["size"]
    assert out["final"] == pytest.approx(base_lr, rel=1e-5)


def test_schedule_callback_staircase_and_momentum_buffers(world):
    out = _case(world, "schedule_staircase_and_momentum")
    assert out["n_bufs"] > 0 and out["nonzero"]
    assert out["lr1"] == pytest.approx(0.05, rel=1e-6)
    assert out["halved"] and out["still"]
    assert out["logged_lr"] == pytest.approx(0.05, rel=1e-6)


def test_schedule_callback_rejects_lr_schedule_object(world):
    assert "schedule" in _case(world, "schedule_rejects_schedule_object")[
        "error_text"]


def test_load_model_rewraps_optimizer(world):
    out = _case(world, "load_model_rewraps")
    assert out["mixin"] and out["is_sgd"] and out["again_mixin"]
    assert out["lr"] == pytest.approx(0.07, rel=1e-6)
    assert out["it"][0] == out["it"][1]
    assert out["weights_equal"]
    assert np.isfinite(out["resumed_loss"])


def test_load_model_preserves_average_and_name(world):
    out = _case(world, "load_model_keeps_average_and_name")
    assert out["average"] is False and out["prefix"] == "sumopt"


def test_value_level_ops_over_two_ranks(world):
    """The port's counterpart of the single-controller identity: average
    and sum over two ranks, rank 0's value, a ragged allgather."""
    want_gather = np.concatenate([
        np.arange(3, dtype=np.float32).reshape(1, 3),
        np.arange(6, dtype=np.float32).reshape(2, 3)])
    for rank in (0, 1):
        out = _case(world, "value_level_ops", rank)
        assert out["allreduce"] == 4.0
        assert np.array_equal(out["allreduce_sum"],
                              np.full((2, 2), 3, np.float32))
        assert out["broadcast"] == 2.25
        assert np.array_equal(out["allgather"], want_gather)


def test_ops_raise_before_init(world):
    out = _case(world, "ops_raise_before_init")
    assert out["raised"] == ["NotInitializedError"] * 2
    assert out["size_after"] == 2


def test_broadcast_global_variables_requires_model_when_multiprocess(world):
    w = [_case(world, "broadcast_global_variables", r) for r in (0, 1)]
    assert all("pass the model" in o["no_model"] for o in w)
    assert all(np.array_equal(a, b)
               for a, b in zip(w[0]["weights"], w[1]["weights"]))


def test_warmup_verbose_fires_for_fractional_epochs(world):
    assert _case(world, "warmup_verbose_fractional")["printed"]
    assert not _case(world, "warmup_verbose_fractional", 1)["printed"]


def test_keras_state_memory_round_trip(world):
    out = _case(world, "state_memory_round_trip")
    assert out["epoch"] == 3 and out["weights"] and out["slots"]
    assert "unknown state field" in out["undeclared"]


def test_keras_state_durable_restore_and_torn_file(world):
    out = _case(world, "state_durable_restore_and_torn_file")
    assert out["warned"]
    assert out["epoch"] == 1 and out["commit_step"] == 1 and out["weights"]
    other = _case(world, "state_durable_restore_and_torn_file", 1)
    assert other["epoch"] == 1 and other["weights"]   # fanned out


def test_keras_state_intact_but_corrupt_hard_fails(world):
    for rank in (0, 1):
        text = _case(world, "state_intact_but_corrupt_hard_fails",
                     rank)["error_text"]
        assert text and "restore failed" in text


def test_keras_state_restores_slots_into_unbuilt_optimizer(world):
    out = _case(world, "state_restores_slots_into_unbuilt_optimizer")
    assert out["unbuilt_before"] and out["built"] and out["nonzero"]
    assert out["epoch"] == 5 and out["slots"] and out["weights"]


def test_keras_state_rejects_restore_before_compile(world):
    text = _case(world, "state_rejects_restore_before_compile")["error_text"]
    assert text and "compile" in text


def test_keras_state_deferred_build_model(world):
    out = _case(world, "state_deferred_build_model")
    assert out["unbuilt"] and out["opt_unbuilt_after_restore"]
    assert out["error_text"] and "unbuilt" in out["error_text"]


def test_keras_state_model_none_rejects_payload_commit(world):
    text = _case(world, "state_model_none_rejects_payload_commit")[
        "error_text"]
    assert text and "no model" in text.replace("\n", " ")


def test_keras_frontend_refuses_other_backends(world):
    text = _case(world, "torch_backend_only")["error_text"]
    assert text and "torch backend" in text and "KERAS_BACKEND=torch" in text


def test_keras_mnist_advanced_example_on_two_ranks(world):
    """The example twin (``keras_mnist_advanced --smoke --device cpu``) on
    the world of two: two epochs through all four callbacks (the warm-up's
    message on rank 0, the LR at lr · size after it), the loss falling, the model
    saved by rank 0."""
    out = _case(world, "mnist_example_twin")
    lines = [ln for ln in out["stdout"].splitlines()
             if ln.startswith("epoch ")]
    assert len(lines) == 2, out["stdout"]
    losses = [float(ln.split()[3]) for ln in lines]
    assert losses[1] < losses[0], lines
    assert "finished gradual learning rate warmup" in out["stdout"]
    # the one-epoch warm-up ends at epoch 0's last batch: lr · size after
    assert out["lr"] == pytest.approx([0.02, 0.02], rel=1e-5)
    assert out["saved"]
    other = _case(world, "mnist_example_twin", 1)
    assert other["stdout"] == "" and other["lr"] == out["lr"]


def test_keras_elastic_example_resumes_past_the_end(world):
    """The elastic example twin on the world of two: two epochs committed
    (``step_1.npz``, ``step_2.npz``), the loss printed by rank 0; a second
    run on the same commits restores epoch 2 and trains nothing."""
    out = _case(world, "elastic_example_twin")
    first, second = out["runs"]
    assert [ln.split(":")[0] for ln in first["stdout"].splitlines()] == [
        "epoch 0", "epoch 1"]
    assert np.isfinite(first["last"])
    assert second["stdout"] == "" and second["last"] is None
    assert out["commits"] == ["step_1.npz", "step_2.npz"]
    other = _case(world, "elastic_example_twin", 1)
    assert other["runs"][1]["last"] is None
