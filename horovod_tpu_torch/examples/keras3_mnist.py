"""MNIST through the Keras 3 frontend on the torch backend.

Twin of ``examples/keras3_mnist.py`` (the reference's keras_mnist.py:28-85
on keras >= 3): ``init`` → scale the LR by the world size →
``hvd.DistributedOptimizer(SGD(base_lr · size, momentum=0.9))`` → the
broadcast, metric-average and warm-up callbacks → each rank fits its
shard (every ``size``-th sample) → rank 0 saves ``model.keras`` under
``--ckpt-dir`` and reloads it with ``hvd.load_model``, which re-wraps the
optimizer.  The JAX script's single-controller route
(``keras.distribution.DataParallel``) exists on keras's JAX backend only;
here every world is one process a GPU and the optimizer averages the
gradients.

    KERAS_BACKEND=torch python -m horovod_tpu_torch.examples.keras3_mnist --smoke --device cpu

On the card drop ``--device cpu``; the script sets ``KERAS_BACKEND=torch``
when the variable is unset, before keras is imported.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from horovod_tpu_torch import basics
from horovod_tpu_torch.data import synthetic_mnist


def main(argv=None, weights=None) -> dict:
    """The fit's history and the final weights; on rank 0 the saved path
    and the reloaded model.  ``weights``: the initial kernels and biases,
    in place of keras's seeded draw (the JAX script's, which keras draws
    from its JAX backend's generator, say)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--batch-per-chip", type=int, default=32)
    p.add_argument("--base-lr", type=float, default=0.05)
    p.add_argument("--samples", type=int, default=4096)
    p.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "hvd_tpu_torch_keras3_mnist"))
    p.add_argument("--smoke", action="store_true",
                   help="2 epochs of 256 samples")
    p.add_argument("--device", default=None,
                   help="'cpu' to run on the CPU; default: the GPU")
    args = p.parse_args(argv)
    if args.smoke:
        args.epochs, args.samples = 2, 256

    os.environ.setdefault("KERAS_BACKEND", "torch")
    import horovod_tpu_torch.keras as hvd

    basics.init(args.device)
    keras = hvd._keras()
    r, n = hvd.rank(), hvd.size()
    images, labels = synthetic_mnist(args.samples)
    # Each rank trains on its own shard.
    x = np.asarray(images[r::n], np.float32).reshape(-1, 28 * 28)
    y = np.asarray(labels[r::n], np.int32)

    keras.utils.set_random_seed(42)
    model = keras.Sequential([
        keras.layers.Input((28 * 28,)),
        keras.layers.Dense(128, activation="relu"),
        keras.layers.Dense(10),
    ])
    if weights is not None:
        model.set_weights(weights)
    # Scale the LR by the world size; the warm-up callback ramps up to it.
    opt = hvd.DistributedOptimizer(
        keras.optimizers.SGD(args.base_lr * n, momentum=0.9))
    model.compile(
        optimizer=opt,
        loss=keras.losses.SparseCategoricalCrossentropy(from_logits=True),
        metrics=["accuracy"])
    callbacks = [
        hvd.callbacks.BroadcastGlobalVariablesCallback(0),
        hvd.callbacks.MetricAverageCallback(),
        hvd.callbacks.LearningRateWarmupCallback(
            warmup_epochs=2, verbose=1 if r == 0 else 0),
    ]
    hist = model.fit(x, y, batch_size=args.batch_per_chip,
                     epochs=args.epochs, shuffle=False,
                     verbose=2 if r == 0 else 0, callbacks=callbacks)
    out = {"history": hist.history, "path": None, "reloaded": None,
           "weights": [np.asarray(w) for w in model.get_weights()]}
    if r == 0:
        os.makedirs(args.ckpt_dir, exist_ok=True)
        path = os.path.join(args.ckpt_dir, "model.keras")
        model.save(path)
        print(f"final loss {hist.history['loss'][-1]:.4f}; saved {path}",
              flush=True)
        # The resume path: load_model re-wraps the optimizer with its state.
        reloaded = hvd.load_model(path)
        print("reloaded optimizer:", type(reloaded.optimizer).__name__,
              flush=True)
        out.update(path=path, reloaded=reloaded)
    return out


if __name__ == "__main__":
    main()
