"""The ranks of ``tests/test_torch_keras_frontend.py``'s gloo world.

:func:`keras_world` runs on every rank of a world of two started with
``KERAS_BACKEND=torch`` (``torch_gloo_world.start_world(..., env=...)``)
and drives the port's Keras frontend through every case of
tests/test_keras_frontend.py, each in its own ``try`` so one failure
shows as one failed test.  It returns ``{case: result}``; a case that
raised returns ``{"error": traceback}``.  Keras is imported inside the
function, after the world's environment is set: this module is imported
(to unpickle the function) before it is.  The ranks refuse to import
JAX and the JAX package, as on the card, which has neither.
"""

from __future__ import annotations

import contextlib
import io
import os
import traceback
import warnings

import numpy as np


def init_weights(in_dim=6, hidden=8, out_dim=2, seed=5) -> list:
    """The oracle's initial weights, from numpy: kernel, bias, kernel,
    bias."""
    rng = np.random.RandomState(seed)
    return [(rng.randn(in_dim, hidden) * 0.4).astype(np.float32),
            (rng.randn(hidden) * 0.1).astype(np.float32),
            (rng.randn(hidden, out_dim) * 0.4).astype(np.float32),
            (rng.randn(out_dim) * 0.1).astype(np.float32)]


def data(n=64, in_dim=6, out_dim=2, seed=3):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, in_dim).astype(np.float32),
            rng.randn(n, out_dim).astype(np.float32))


ORACLE = {"n": 16, "half": 8, "epochs": 3, "lr": 0.05, "momentum": 0.9,
          "warmup_epochs": 2}


class _Refuse:
    """A meta-path finder that refuses JAX and the JAX package: the card
    has neither, and keras falls back without them (it imports jax only
    when it finds one)."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "horovod_tpu"):
            raise ImportError(f"{name} is refused in the port's keras ranks")
        return None


def keras_world(rank: int, world: int, tmp: str,
                example_weights: dict | None = None) -> dict:
    import sys

    import torch

    sys.meta_path.insert(0, _Refuse())
    torch.set_num_threads(1)
    import keras

    import horovod_tpu_torch.keras as hvdk
    from horovod_tpu_torch import basics

    tmp = os.path.join(tmp, f"rank{rank}")
    os.makedirs(tmp, exist_ok=True)

    def model_(in_dim=6, out_dim=2, seed=0):
        keras.utils.set_random_seed(seed)
        return keras.Sequential([keras.Input((in_dim,)),
                                 keras.layers.Dense(8, activation="relu"),
                                 keras.layers.Dense(out_dim)])

    def fit_briefly(model):
        x, y = data(n=32)
        model.fit(x, y, batch_size=16, epochs=1, verbose=0)

    def sgd(**kw):
        return keras.optimizers.SGD(**kw)

    cases = {}

    def case(fn):
        cases[fn.__name__] = fn
        return fn

    @case
    def wraps_and_fits():
        model = model_()
        opt = hvdk.DistributedOptimizer(sgd(learning_rate=0.05))
        out = {"name": type(opt).__name__,
               "is_sgd": isinstance(opt, keras.optimizers.SGD)}
        model.compile(optimizer=opt, loss="mse")
        x, y = data()
        out["losses"] = model.fit(x, y, batch_size=16, epochs=3,
                                  verbose=0).history["loss"]
        try:
            hvdk.DistributedOptimizer(opt)
            out["rewrap"] = None
        except ValueError as e:
            out["rewrap"] = str(e)
        out["on_device"] = str(model.trainable_variables[0].value.device)
        return out

    @case
    def apply_averages_gradients():
        model = model_()
        opt = hvdk.DistributedOptimizer(sgd(learning_rate=1.0))
        opt.build(model.trainable_variables)
        before = [v.numpy().copy() for v in model.trainable_variables]
        grads = [torch.full(tuple(v.shape), 2.0 * (rank + 1))
                 for v in model.trainable_variables]
        opt.apply(grads, model.trainable_variables)
        return {"deltas": [float(np.max(np.abs(
            np.asarray(v.numpy()) - b + 3.0)))
            for b, v in zip(before, model.trainable_variables)]}

    @case
    def preserves_built_state():
        model = model_()
        inner = sgd(learning_rate=0.1, momentum=0.9)
        model.compile(optimizer=inner, loss="mse")
        x, y = data()
        model.fit(x, y, batch_size=16, epochs=1, verbose=0)
        wrapped = hvdk.DistributedOptimizer(inner)
        return {"it": int(inner.iterations.numpy()),
                "built": wrapped.built,
                "wrapped_it": int(wrapped.iterations.numpy()),
                "equal": all(np.array_equal(np.asarray(a.numpy()),
                                            np.asarray(b.numpy()))
                             for a, b in zip(inner.variables,
                                             wrapped.variables))}

    @case
    def two_rank_fit_with_callbacks():
        # the oracle: this rank's half of every global batch of 16
        x, y = data(n=ORACLE["n"], seed=7)
        h = ORACLE["half"]
        x, y = x[rank * h:(rank + 1) * h], y[rank * h:(rank + 1) * h]
        model = model_(seed=rank)       # ranks start apart
        if rank == 0:
            model.set_weights(init_weights())
        model.compile(optimizer=hvdk.DistributedOptimizer(
            sgd(learning_rate=ORACLE["lr"], momentum=ORACLE["momentum"])),
            loss="mse")
        hist = model.fit(
            x, y, batch_size=h, epochs=ORACLE["epochs"], shuffle=False,
            verbose=0, callbacks=[
                hvdk.callbacks.BroadcastGlobalVariablesCallback(0),
                hvdk.callbacks.MetricAverageCallback(),
                hvdk.callbacks.LearningRateWarmupCallback(
                    warmup_epochs=ORACLE["warmup_epochs"],
                    steps_per_epoch=1)])
        return {"weights": [np.asarray(w) for w in model.get_weights()],
                "loss": hist.history["loss"], "lr": hist.history["lr"]}

    @case
    def warmup_ramps_lr():
        model = model_()
        base_lr = 0.08
        model.compile(optimizer=hvdk.DistributedOptimizer(
            sgd(learning_rate=base_lr)), loss="mse")
        x, y = data(n=64)
        warmup = hvdk.callbacks.LearningRateWarmupCallback(warmup_epochs=2,
                                                           verbose=0)
        hist = model.fit(x, y, batch_size=16, epochs=3, verbose=0,
                         shuffle=False, callbacks=[warmup])
        return {"lrs": hist.history["lr"], "size": hvdk.size(),
                "final": float(model.optimizer.learning_rate.numpy())}

    @case
    def schedule_staircase_and_momentum():
        model = model_()
        inner = sgd(learning_rate=0.1, momentum=0.9)
        model.compile(optimizer=inner, loss="mse")
        x, y = data()
        model.fit(x, y, batch_size=16, epochs=1, verbose=0)
        cb = hvdk.callbacks.LearningRateScheduleCallback(
            multiplier=0.5, start_epoch=0, staircase=True,
            momentum_correction=True)
        cb.set_model(model)
        cb.on_train_begin()
        bufs = cb._momentum_buffers()
        before = [np.asarray(b.numpy()).copy() for b in bufs]
        cb.on_epoch_begin(0)
        cb.on_train_batch_begin(0)
        lr1 = float(model.optimizer.learning_rate.numpy())
        halved = all(np.allclose(np.asarray(b.numpy()), b0 * 0.5, rtol=1e-6)
                     for b0, b in zip(before, bufs))
        cb.on_epoch_begin(1)
        cb.on_train_batch_begin(0)
        still = all(np.allclose(np.asarray(b.numpy()), b0 * 0.5, rtol=1e-6)
                    for b0, b in zip(before, bufs))
        logs: dict = {}
        cb.on_epoch_end(1, logs)
        return {"n_bufs": len(bufs),
                "nonzero": any(np.abs(b).max() > 0 for b in before),
                "lr1": lr1, "halved": halved, "still": still,
                "logged_lr": logs["lr"]}

    @case
    def schedule_rejects_schedule_object():
        model = model_()
        model.compile(optimizer=sgd(
            learning_rate=keras.optimizers.schedules.ExponentialDecay(
                0.1, 10, 0.9)), loss="mse")
        cb = hvdk.callbacks.LearningRateScheduleCallback(multiplier=0.5)
        cb.set_model(model)
        try:
            cb.on_train_begin()
        except ValueError as e:
            return {"error_text": str(e)}
        return {"error_text": None}

    @case
    def load_model_rewraps():
        model = model_()
        model.compile(optimizer=sgd(learning_rate=0.07, momentum=0.9),
                      loss="mse")
        x, y = data()
        model.fit(x, y, batch_size=16, epochs=1, verbose=0)
        path = os.path.join(tmp, "m.keras")
        model.save(path)
        loaded = hvdk.load_model(path)
        out = {
            "mixin": isinstance(loaded.optimizer,
                                hvdk._DistributedApplyMixin),
            "is_sgd": isinstance(loaded.optimizer, keras.optimizers.SGD),
            "lr": float(loaded.optimizer.learning_rate.numpy()),
            "it": (int(loaded.optimizer.iterations.numpy()),
                   int(model.optimizer.iterations.numpy())),
            "weights_equal": all(
                np.array_equal(np.asarray(a.numpy()), np.asarray(b.numpy()))
                for a, b in zip(model.trainable_variables,
                                loaded.trainable_variables)),
            "resumed_loss": loaded.fit(x, y, batch_size=16, epochs=1,
                                       verbose=0).history["loss"][0]}
        path2 = os.path.join(tmp, "m2.keras")
        loaded.save(path2)
        again = hvdk.load_model(path2)
        out["again_mixin"] = isinstance(again.optimizer,
                                        hvdk._DistributedApplyMixin)
        return out

    @case
    def load_model_keeps_average_and_name():
        model = model_()
        model.compile(optimizer=hvdk.DistributedOptimizer(
            sgd(learning_rate=0.01), name="sumopt", average=False),
            loss="mse")
        x, y = data()
        model.fit(x, y, batch_size=16, epochs=1, verbose=0)
        path = os.path.join(tmp, "s.keras")
        model.save(path)
        loaded = hvdk.load_model(path)
        return {"average": loaded.optimizer._hvd_average,
                "prefix": loaded.optimizer._hvd_prefix}

    @case
    def value_level_ops():
        arr = np.arange(3 * (rank + 1), dtype=np.float32).reshape(-1, 3)
        return {"allreduce": hvdk.allreduce(3.5 + rank),
                "allreduce_sum": hvdk.allreduce(
                    np.full((2, 2), rank + 1, np.float32), average=False),
                "broadcast": hvdk.broadcast(2.25 + rank, root_rank=0),
                "allgather": hvdk.allgather(arr)}

    @case
    def ops_raise_before_init():
        basics.shutdown()
        raised = []
        try:
            for call in (lambda: hvdk.allreduce(1.0),
                         lambda: hvdk.broadcast_variables([], 0)):
                try:
                    call()
                    raised.append(None)
                except basics.NotInitializedError as e:
                    raised.append(type(e).__name__)
        finally:
            basics.init("cpu")
        return {"raised": raised, "size_after": hvdk.size()}

    @case
    def broadcast_global_variables():
        try:
            hvdk.broadcast_global_variables(0)
            no_model = None
        except ValueError as e:
            no_model = str(e)
        model = model_(seed=rank)
        model.compile(optimizer=sgd(), loss="mse")
        hvdk.broadcast_global_variables(0, model=model)
        return {"no_model": no_model,
                "weights": [np.asarray(w) for w in model.get_weights()]}

    @case
    def warmup_verbose_fractional():
        model = model_()
        model.compile(optimizer=sgd(learning_rate=0.1), loss="mse")
        x, y = data(n=32)
        warmup = hvdk.callbacks.LearningRateWarmupCallback(
            warmup_epochs=1.5, steps_per_epoch=2, verbose=1)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            model.fit(x, y, batch_size=16, epochs=2, verbose=0,
                      callbacks=[warmup])
        return {"printed": "finished gradual learning rate warmup"
                in buf.getvalue()}

    def compiled(momentum=0.9, seed=0):
        model = model_(seed=seed)
        model.compile(optimizer=hvdk.DistributedOptimizer(
            sgd(learning_rate=0.1, momentum=momentum)), loss="mse")
        return model

    @case
    def state_memory_round_trip():
        model = compiled()
        fit_briefly(model)
        state = hvdk.elastic.KerasState(model, epoch=3)
        state.commit()
        w0 = [w.copy() for w in model.get_weights()]
        o0 = [np.asarray(v.numpy()).copy()
              for v in model.optimizer.variables]
        fit_briefly(model)
        state.epoch = 7
        state.restore()
        out = {"epoch": state.epoch,
               "weights": all(np.array_equal(a, np.asarray(b))
                              for a, b in zip(w0, model.get_weights())),
               "slots": all(np.array_equal(a, np.asarray(v.numpy()))
                            for a, v in zip(o0, model.optimizer.variables))}
        try:
            state.undeclared = 1
            out["undeclared"] = None
        except AttributeError as e:
            out["undeclared"] = str(e)
        return out

    @case
    def state_durable_restore_and_torn_file():
        d = os.path.join(tmp, "torn")
        model = compiled()
        fit_briefly(model)
        state = hvdk.elastic.KerasState(model, ckpt_dir=d, epoch=1)
        state.commit()
        good = [w.copy() for w in model.get_weights()]
        fit_briefly(model)
        state.epoch = 2
        state.commit()
        if rank == 0:           # rank 0 writes; tear its newest commit
            newest = os.path.join(d, "step_2.npz")
            with open(newest, "rb") as f:
                head = f.read()[:40]
            with open(newest, "wb") as f:
                f.write(head)
        model.set_weights([np.zeros_like(w) for w in good])
        fresh = hvdk.elastic.KerasState(model, ckpt_dir=d, epoch=0)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fresh.restore()
        return {"warned": any("falling back" in str(w.message)
                              for w in caught),
                "epoch": fresh.epoch, "commit_step": fresh.commit_step,
                "weights": all(np.array_equal(a, np.asarray(b))
                               for a, b in zip(good, model.get_weights()))}

    @case
    def state_intact_but_corrupt_hard_fails():
        import zipfile

        d = os.path.join(tmp, "corrupt")
        model = compiled(momentum=0.0)
        fit_briefly(model)
        hvdk.elastic.KerasState(model, ckpt_dir=d, epoch=1).commit()
        if rank == 0:
            with zipfile.ZipFile(os.path.join(d, "step_2.npz"), "w") as z:
                z.writestr("meta.npy", b"not numpy data")
        fresh = hvdk.elastic.KerasState(model, ckpt_dir=d, epoch=0)
        try:
            fresh.restore()
        except RuntimeError as e:
            return {"error_text": str(e)}
        return {"error_text": None}

    @case
    def state_restores_slots_into_unbuilt_optimizer():
        d = os.path.join(tmp, "slots")
        model = compiled()
        fit_briefly(model)
        state = hvdk.elastic.KerasState(model, ckpt_dir=d, epoch=5)
        state.commit()
        slots = [np.asarray(v.numpy()).copy()
                 for v in model.optimizer.variables]
        model2 = compiled(seed=9)
        unbuilt = not model2.optimizer.built
        fresh = hvdk.elastic.KerasState(model2, ckpt_dir=d, epoch=0)
        fresh.restore()
        return {"unbuilt_before": unbuilt, "epoch": fresh.epoch,
                "built": model2.optimizer.built,
                "nonzero": any(np.abs(s).max() > 0 for s in slots),
                "slots": all(np.array_equal(a, np.asarray(v.numpy()))
                             for a, v in zip(slots,
                                             model2.optimizer.variables)),
                "weights": all(np.array_equal(np.asarray(a), np.asarray(b))
                               for a, b in zip(model.get_weights(),
                                               model2.get_weights()))}

    @case
    def state_rejects_restore_before_compile():
        d = os.path.join(tmp, "uncompiled")
        model = compiled()
        fit_briefly(model)
        hvdk.elastic.KerasState(model, ckpt_dir=d, epoch=1).commit()
        bare = model_(seed=4)
        fresh = hvdk.elastic.KerasState(bare, ckpt_dir=d, epoch=0)
        try:
            fresh.restore()
        except RuntimeError as e:
            return {"error_text": str(e)}
        return {"error_text": None}

    @case
    def state_deferred_build_model():
        keras.utils.set_random_seed(0)

        def deferred_():
            m = keras.Sequential([keras.layers.Dense(4),
                                  keras.layers.Dense(2)])
            m.compile(optimizer=hvdk.DistributedOptimizer(
                sgd(learning_rate=0.1, momentum=0.9)), loss="mse")
            return m

        deferred = deferred_()
        out = {"unbuilt": not deferred.built}
        state = hvdk.elastic.KerasState(deferred, epoch=0)
        state.restore()
        out["opt_unbuilt_after_restore"] = not deferred.optimizer.built
        x, y = data()
        deferred.fit(x, y, batch_size=16, epochs=1, verbose=0)
        state.commit()
        keras.utils.set_random_seed(1)
        s2 = hvdk.elastic.KerasState(deferred_(), epoch=0)
        object.__setattr__(s2, "_mem_commit",
                           object.__getattribute__(state, "_mem_commit"))
        try:
            s2.restore()
            out["error_text"] = None
        except ValueError as e:
            out["error_text"] = str(e)
        return out

    @case
    def state_model_none_rejects_payload_commit():
        d = os.path.join(tmp, "nomodel")
        model = compiled(momentum=0.0)
        fit_briefly(model)
        hvdk.elastic.KerasState(model, ckpt_dir=d, epoch=1).commit()
        bare = hvdk.elastic.KerasState(ckpt_dir=d, epoch=0)
        try:
            bare.restore()
        except RuntimeError as e:
            return {"error_text": str(e)}
        return {"error_text": None}

    @case
    def torch_backend_only():
        # the port refuses a keras on another backend: the check, run
        # against a stand-in for keras.backend.backend()
        import horovod_tpu_torch.keras as mod

        real = keras.backend.backend
        keras.backend.backend = lambda: "jax"
        try:
            mod._keras()
            return {"error_text": None}
        except ImportError as e:
            return {"error_text": str(e)}
        finally:
            keras.backend.backend = real

    @case
    def mnist_example_twin():
        # the example's CLI on both ranks: keras_mnist_advanced --smoke
        # --device cpu --save <path>
        from horovod_tpu_torch.examples import keras_mnist_advanced

        path = os.path.join(tmp, "mnist.keras")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = keras_mnist_advanced.main(
                ["--smoke", "--device", "cpu", "--save", path])
        return {"stdout": buf.getvalue(), "lr": out["history"]["lr"],
                "saved": os.path.exists(path)}

    @case
    def elastic_example_twin():
        # keras_elastic --epochs 2 on both ranks, then again on the same
        # commits: the second run resumes past the end and trains nothing
        from horovod_tpu_torch.examples import keras_elastic

        ck = os.path.join(os.path.dirname(tmp), "elastic_ck")
        argv = ["--epochs", "2", "--samples", "256", "--batch-size", "16",
                "--device", "cpu", "--ckpt-dir", ck]
        runs = []
        for _ in range(2):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                last = keras_elastic.main(argv)
            runs.append({"stdout": buf.getvalue(), "last": last})
        return {"runs": runs,
                "commits": sorted(os.listdir(ck)) if rank == 0 else None}

    def quiet(fn, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = fn(argv)
        return out, buf.getvalue()

    weights = example_weights or {}

    @case
    def keras_mnist_twin():
        # the example on both ranks from the JAX script's init, with its
        # 4096 samples: keras_mnist --epochs 2 --device cpu
        from horovod_tpu_torch.examples import keras_mnist

        means = []

        class Steps(keras.callbacks.Callback):
            # keras logs this rank's running mean of its batches' losses
            def on_epoch_begin(self, epoch, logs=None):
                means.append([])

            def on_train_batch_end(self, batch, logs=None):
                means[-1].append(logs["loss"])

        real_fit = keras.Model.fit

        def fit(self, *a, callbacks=(), **k):
            return real_fit(self, *a, callbacks=[*callbacks, Steps()], **k)

        keras.Model.fit = fit
        try:
            out, stdout = quiet(
                lambda argv: keras_mnist.main(argv, weights["keras_mnist"]),
                ["--epochs", "2", "--device", "cpu"])
        finally:
            keras.Model.fit = real_fit
        steps = []
        for m in map(np.asarray, means):
            total = m * np.arange(1, len(m) + 1)
            steps += list(np.diff(total, prepend=0.0))
        return {"stdout": stdout, "loss": out["history"]["loss"],
                "step_losses": steps, "weights": out["weights"]}

    @case
    def keras3_mnist_twin():
        # keras3_mnist --smoke from the JAX script's init
        from horovod_tpu_torch.examples import keras3_mnist

        d = os.path.join(tmp, "keras3")
        out, stdout = quiet(
            lambda argv: keras3_mnist.main(argv, weights["keras3_mnist"]),
            ["--smoke", "--device", "cpu", "--ckpt-dir", d])
        rel = out["reloaded"]
        return {"stdout": stdout, "loss": out["history"]["loss"],
                "accuracy": out["history"]["accuracy"],
                "weights": out["weights"],
                "lr": out["history"]["lr"], "path": out["path"],
                "saved": os.path.exists(os.path.join(d, "model.keras")),
                "reloaded_mixin": (None if rel is None else isinstance(
                    rel.optimizer, hvdk._DistributedApplyMixin))}

    @case
    def keras_imagenet_resnet50_twin():
        # one epoch, then a second run on the same directory that rank 0
        # resumes from checkpoint-1.keras
        from horovod_tpu_torch.examples import keras_imagenet_resnet50 as kr

        ck = os.path.join(os.path.dirname(tmp), "resnet50_ck")
        argv = ["--smoke", "--samples", "8", "--batch-per-chip", "4",
                "--device", "cpu", "--ckpt-dir", ck]
        runs = []
        for epochs in ("1", "2"):
            out, stdout = quiet(kr.main, ["--epochs", epochs, *argv])
            runs.append({"stdout": stdout, "loss": out["history"]["loss"],
                         "lr": out["history"]["lr"],
                         "resumed_from": out["resumed_from"]})
        return {"runs": runs,
                "commits": sorted(os.listdir(ck)) if rank == 0 else None}

    results = {"backend": keras.backend.backend(),
               "device": str(basics.device()),
               "jax_free": not any(m.split(".")[0] in ("jax", "horovod_tpu")
                                   for m in sys.modules)}
    for name, fn in cases.items():
        try:
            results[name] = fn()
        except Exception:  # noqa: BLE001 — one failed case, one failed test
            results[name] = {"error": traceback.format_exc()}
    return results
