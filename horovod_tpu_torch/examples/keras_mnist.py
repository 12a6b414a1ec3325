"""MNIST through Keras 3 on the torch backend: the three-line distribution.

Twin of ``examples/keras_mnist.py`` (the reference's keras_mnist.py: wrap
the optimizer, add ``BroadcastGlobalVariablesCallback``, call ``fit``; the
JAX script spells it with the JAX package's ``fit``): the MLP of
``MnistMLP`` (784 → 512 → 512 → 10) as a ``keras.Sequential``,
``hvd.DistributedOptimizer(Adam(base_lr · size))`` with optax's epsilon
(1e-8), the broadcast and metric-average callbacks; each rank fits its
shard of ``synthetic_mnist`` in the JAX script's order, the
``ShardedLoader``'s (seed 0, reshuffled each epoch), handed to keras as a
``PyDataset`` (keras's own shuffle off).  Rank 0 prints the final loss.

    KERAS_BACKEND=torch python -m horovod_tpu_torch.examples.keras_mnist --smoke --device cpu

On the card drop ``--device cpu``.  Keras must be on its torch backend:
the script sets ``KERAS_BACKEND=torch`` when the variable is unset, before
keras is imported.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from horovod_tpu_torch import basics
from horovod_tpu_torch.data import ShardedLoader, synthetic_mnist


def main(argv=None, weights=None) -> dict:
    """The fit's history and the final weights.  ``weights``: the initial
    kernels and biases, in place of keras's seeded draw (the JAX script's
    flax init, whose Dense kernels are keras's ``[in, out]``, say)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--batch-per-chip", type=int, default=32)
    p.add_argument("--base-lr", type=float, default=0.01)
    p.add_argument("--samples", type=int, default=4096)
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
    keras.utils.set_random_seed(0)
    n = hvd.size()
    loader = ShardedLoader(synthetic_mnist(args.samples),
                           args.batch_per_chip, device_put=False)

    class Epochs(keras.utils.PyDataset):
        """This rank's batches in the loader's order for the epoch that
        ``set_epoch`` names (keras calls ``on_epoch_end`` also before the
        first epoch, so the epoch comes from the callback below)."""

        def __init__(self):
            super().__init__()
            self.set_epoch(0)

        def set_epoch(self, epoch):
            loader.set_epoch(epoch)
            self.batches = list(loader)

        def __len__(self):
            return len(self.batches)

        def __getitem__(self, i):
            x, y = self.batches[i]
            return x.reshape(len(x), -1), y

    class SetEpoch(keras.callbacks.Callback):
        def on_epoch_begin(self, epoch, logs=None):
            data.set_epoch(epoch)

    data = Epochs()
    model = keras.Sequential([
        keras.Input((28 * 28,)),
        keras.layers.Dense(512, activation="relu"),
        keras.layers.Dense(512, activation="relu"),
        keras.layers.Dense(10),
    ])
    if weights is not None:
        model.set_weights(weights)
    model.compile(
        optimizer=hvd.DistributedOptimizer(
            keras.optimizers.Adam(args.base_lr * n, epsilon=1e-8)),
        loss=keras.losses.SparseCategoricalCrossentropy(from_logits=True))
    r = hvd.rank()
    hist = model.fit(
        data, epochs=args.epochs, shuffle=False, verbose=2 if r == 0 else 0,
        callbacks=[
            SetEpoch(),
            hvd.callbacks.BroadcastGlobalVariablesCallback(0),
            hvd.callbacks.MetricAverageCallback()])
    if r == 0:
        print("final loss:", hist.history["loss"][-1], flush=True)
    return {"history": hist.history,
            "weights": [np.asarray(w) for w in model.get_weights()]}


if __name__ == "__main__":
    main()
