"""Fault-tolerant Keras 3 MNIST with ``hvd.elastic.KerasState`` on the
torch backend.

Twin of ``examples/keras_elastic.py``: the model and the epoch live in a
``KerasState``; the epoch loop runs under ``@hvd.elastic.run``, which on
every (re)start restores the newest durable commit (weights, optimizer
slots, epoch) and syncs every rank; each epoch ends by advancing the epoch
and committing (``step_<N>.npz`` under ``--ckpt-dir``), so a restore never
replays work a commit already covers.  A second run with the same
``--ckpt-dir`` resumes past the last epoch and trains nothing.

    KERAS_BACKEND=torch python -m horovod_tpu_torch.examples.keras_elastic --epochs 2 --device cpu

One process per GPU on the card (``torchrun`` or the JAX package's
launcher sets rank and world, else a world of one); the script sets
``KERAS_BACKEND=torch`` when the variable is unset, before keras is
imported.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from horovod_tpu_torch import basics
from horovod_tpu_torch.data import shard_indices, synthetic_mnist


def main(argv=None) -> float | None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--samples", type=int, default=2048)
    p.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "hvd_torch_keras_elastic"))
    p.add_argument("--device", default=None,
                   help="'cpu' to run on the CPU; default: the GPU")
    args = p.parse_args(argv)

    os.environ.setdefault("KERAS_BACKEND", "torch")
    import horovod_tpu_torch.keras as hvd

    basics.init(args.device)
    keras = hvd._keras()
    keras.utils.set_random_seed(42)
    model = keras.Sequential([
        keras.layers.Input((28 * 28,)),
        keras.layers.Dense(128, activation="tanh"),
        keras.layers.Dense(10),
    ])
    model.compile(
        optimizer=hvd.DistributedOptimizer(
            keras.optimizers.SGD(args.lr * hvd.size(), momentum=0.5)),
        loss=keras.losses.SparseCategoricalCrossentropy(from_logits=True))
    state = hvd.elastic.KerasState(model, ckpt_dir=args.ckpt_dir, epoch=0)

    images, labels = synthetic_mnist(args.samples)
    images = images.reshape(len(images), -1)
    labels = labels.astype(np.int32)

    @hvd.elastic.run
    def train(state):
        # run() has restored the newest commit and synced every rank
        last = None                 # a resume may cover every epoch
        while state.epoch < args.epochs:
            idx = shard_indices(len(images), hvd.rank(), hvd.size(),
                                epoch=state.epoch, drop_last=True)
            hist = model.fit(images[idx], labels[idx],
                             batch_size=args.batch_size, shuffle=False,
                             epochs=1, verbose=0)
            last = float(hist.history["loss"][-1])
            if hvd.rank() == 0:
                print(f"epoch {state.epoch}: loss {last:.4f}", flush=True)
            state.epoch += 1
            state.commit()          # the epoch boundary is durable
        return last

    return train(state)


if __name__ == "__main__":
    main()
