"""MNIST through Keras 3 on the torch backend, with Horovod's full callback
stack: broadcast, metric averaging, LR warm-up and staircase windows.

Twin of ``examples/keras_mnist_advanced.py`` (the reference's
examples/keras_mnist_advanced.py:84-96): ``DistributedOptimizer(SGD(lr ·
size, momentum=0.9))``, the warm-up from ``lr`` to ``lr · size`` over the
first epochs, then ×1 to epoch 5, ×0.1 to epoch 7, ×0.01 after; each rank
fits its shard of ``synthetic_mnist`` (every ``size``-th sample) and
evaluates accuracy on a held-out set, averaged over the ranks.  Rank 0
prints each epoch's averaged loss and accuracy, and with ``--save`` writes
the model (``.keras``, reloadable with ``hvd.load_model``).

    KERAS_BACKEND=torch python -m horovod_tpu_torch.examples.keras_mnist_advanced --smoke --device cpu

On the card drop ``--device cpu`` (one process per GPU; ``torchrun`` or the
JAX package's launcher sets rank and world, else a world of one).  Keras
must be on its torch backend: the script sets ``KERAS_BACKEND=torch`` when
the variable is unset, before keras is imported.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from horovod_tpu_torch import basics
from horovod_tpu_torch.data import synthetic_mnist


def build_model(keras):
    """A small conv net: conv 3×3 ×32, max-pool, dense 64, dense 10."""
    return keras.Sequential([
        keras.Input((28, 28, 1)),
        keras.layers.Conv2D(32, 3, activation="relu"),
        keras.layers.MaxPooling2D(2),
        keras.layers.Flatten(),
        keras.layers.Dense(64, activation="relu"),
        keras.layers.Dense(10),
    ])


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--batch-per-chip", type=int, default=32)
    p.add_argument("--base-lr", type=float, default=0.01)
    p.add_argument("--warmup-epochs", type=float, default=3.0)
    p.add_argument("--samples", type=int, default=4096)
    p.add_argument("--save", default=None, help="write the model here "
                   "(a .keras file) after the last epoch")
    p.add_argument("--smoke", action="store_true",
                   help="2 epochs of 256 samples, warm-up of 1 epoch")
    p.add_argument("--device", default=None,
                   help="'cpu' to run on the CPU; default: the GPU")
    args = p.parse_args(argv)
    if args.smoke:
        args.epochs, args.samples, args.warmup_epochs = 2, 256, 1.0

    os.environ.setdefault("KERAS_BACKEND", "torch")
    import horovod_tpu_torch.keras as hvd

    basics.init(args.device)
    keras = hvd._keras()
    keras.utils.set_random_seed(0)
    r, n = hvd.rank(), hvd.size()
    images, labels = synthetic_mnist(args.samples)
    eval_images, eval_labels = synthetic_mnist(args.samples // 4, seed=9)
    x, y = images[r::n], labels[r::n]
    xe, ye = eval_images[r::n], eval_labels[r::n]

    model = build_model(keras)
    opt = hvd.DistributedOptimizer(keras.optimizers.SGD(
        learning_rate=args.base_lr * n, momentum=0.9))
    model.compile(optimizer=opt, metrics=["accuracy"],
                  loss=keras.losses.SparseCategoricalCrossentropy(
                      from_logits=True))
    callbacks = [
        hvd.callbacks.BroadcastGlobalVariablesCallback(0),
        hvd.callbacks.MetricAverageCallback(),
        # lr / size → lr over the first epochs (reference :91)
        hvd.callbacks.LearningRateWarmupCallback(
            warmup_epochs=args.warmup_epochs, verbose=1),
        # staircase windows after the warm-up (reference :92-95)
        hvd.callbacks.LearningRateScheduleCallback(
            multiplier=1.0, start_epoch=args.warmup_epochs, end_epoch=5),
        hvd.callbacks.LearningRateScheduleCallback(
            multiplier=1e-1, start_epoch=5, end_epoch=7),
        hvd.callbacks.LearningRateScheduleCallback(
            multiplier=1e-2, start_epoch=7),
    ]
    hist = model.fit(x, y, batch_size=args.batch_per_chip,
                     epochs=args.epochs, callbacks=callbacks,
                     validation_data=(xe, ye), verbose=0, shuffle=True)
    history = hist.history
    if r == 0:
        for e in range(args.epochs):
            print(f"epoch {e}: loss {history['loss'][e]:.4f} accuracy "
                  f"{history['val_accuracy'][e]:.4f} lr "
                  f"{history['lr'][e]:.5f}", flush=True)
        if args.save:
            model.save(args.save)
    return {"history": history, "model": model,
            "weights": [np.asarray(w) for w in model.get_weights()]}


if __name__ == "__main__":
    main()
