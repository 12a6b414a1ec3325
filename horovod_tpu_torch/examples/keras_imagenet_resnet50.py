"""ResNet-50 on ImageNet-shaped data through Keras 3 on the torch backend,
with checkpoints and resume: the flagship CNN recipe.

Twin of ``examples/keras_imagenet_resnet50.py`` (the reference's
keras_imagenet_resnet50.py): rank 0 scans ``--ckpt-dir`` for the last
epoch's checkpoint and ``hvd.broadcast`` gives every rank its epoch
(reference :66-73); rank 0 resumes from it through ``hvd.load_model``
(the optimizer re-wrapped with its slots) and
``BroadcastGlobalVariablesCallback`` brings the others to its state; the
LR warms up to ``base_lr · size`` over ``--warmup-epochs`` and decays ×0.1
at epochs 30, 60 and 80 (``LearningRateWarmupCallback`` and
``LearningRateScheduleCallback``, reference :101-113), scaled from
``base_lr · size`` also after a resume, as the JAX script's optax schedule
is (the warm-up runs one batch ahead of it: the reference's callback
counts a batch as done when it begins); metrics are averaged
over the ranks, and rank 0 writes ``checkpoint-<epoch>.keras`` after each
epoch.  The model is ``keras.applications.ResNet50`` (random weights,
logits out); the data ``synthetic_imagenet``, each rank on every
``size``-th sample.  The JAX script adds ``0.5 · wd · ‖params‖²`` to its
loss; Keras takes ``--wd`` as SGD's weight decay, the same pull towards
zero applied to the weights directly.

    KERAS_BACKEND=torch python -m horovod_tpu_torch.examples.keras_imagenet_resnet50 --smoke --epochs 1 --device cpu

On the card drop ``--device cpu`` (bf16 compute there, as the JAX script
on the TPU); the script sets ``KERAS_BACKEND=torch`` when the variable is
unset, before keras is imported.
"""

from __future__ import annotations

import argparse
import os
import re
import tempfile

from horovod_tpu_torch import basics
from horovod_tpu_torch.data import synthetic_imagenet

_CKPT = re.compile(r"checkpoint-(\d+)\.keras$")


def last_epoch(ckpt_dir: str) -> int:
    """The newest ``checkpoint-<epoch>.keras`` in ``ckpt_dir``, 0 if none."""
    if not os.path.isdir(ckpt_dir):
        return 0
    found = [int(m.group(1)) for m in map(_CKPT.match, os.listdir(ckpt_dir))
             if m]
    return max(found, default=0)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--epochs", type=int, default=90)
    p.add_argument("--batch-per-chip", type=int, default=32)
    p.add_argument("--base-lr", type=float, default=0.0125)
    p.add_argument("--warmup-epochs", type=float, default=5.0)
    p.add_argument("--wd", type=float, default=5e-5)
    p.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "hvd_tpu_torch_resnet50"))
    p.add_argument("--samples", type=int, default=None,
                   help="synthetic images (default 2048; 256 with --smoke)")
    p.add_argument("--smoke", action="store_true",
                   help="32-pixel images, 256 of them")
    p.add_argument("--device", default=None,
                   help="'cpu' to run on the CPU; default: the GPU")
    args = p.parse_args(argv)
    size = 32 if args.smoke else 224
    n_images = args.samples or (256 if args.smoke else 2048)

    os.environ.setdefault("KERAS_BACKEND", "torch")
    import horovod_tpu_torch.keras as hvd

    basics.init(args.device)
    keras = hvd._keras()
    if basics.device().type == "cuda":
        keras.mixed_precision.set_global_policy("mixed_bfloat16")
    r, n = hvd.rank(), hvd.size()
    images, labels = synthetic_imagenet(n=n_images, image_size=size)
    x, y = images[r::n], labels[r::n]

    # Resume: the scan on rank 0, its epoch agreed by every rank.
    resume = int(hvd.broadcast(last_epoch(args.ckpt_dir) if r == 0 else 0,
                               root_rank=0, name="resume_from_epoch"))
    if resume > 0 and r == 0:
        model = hvd.load_model(
            os.path.join(args.ckpt_dir, f"checkpoint-{resume}.keras"))
        print(f"resuming from epoch {resume}", flush=True)
    else:
        keras.utils.set_random_seed(0)
        model = keras.applications.ResNet50(
            weights=None, input_shape=(size, size, 3), classes=1000,
            classifier_activation=None)
        model.compile(
            optimizer=hvd.DistributedOptimizer(keras.optimizers.SGD(
                args.base_lr * n, momentum=0.9, weight_decay=args.wd)),
            loss=keras.losses.SparseCategoricalCrossentropy(
                from_logits=True),
            metrics=["accuracy"])
    w = args.warmup_epochs
    schedules = [
        hvd.callbacks.LearningRateWarmupCallback(warmup_epochs=w),
        hvd.callbacks.LearningRateScheduleCallback(
            multiplier=1.0, start_epoch=w, end_epoch=30),
        hvd.callbacks.LearningRateScheduleCallback(
            multiplier=1e-1, start_epoch=30, end_epoch=60),
        hvd.callbacks.LearningRateScheduleCallback(
            multiplier=1e-2, start_epoch=60, end_epoch=80),
        hvd.callbacks.LearningRateScheduleCallback(
            multiplier=1e-3, start_epoch=80),
    ]

    class ScaleFromBase(keras.callbacks.Callback):
        """The schedules scale ``base_lr · size``, as the JAX script's
        optax schedule does.  They read their base from the optimizer at
        train begin, which after a resume holds the restored, warmed-up
        LR; this callback, after them, puts the base back."""

        def on_train_begin(self, logs=None):
            for cb in schedules:
                cb.initial_lr = args.base_lr * n

    callbacks = [
        hvd.callbacks.BroadcastGlobalVariablesCallback(0),
        hvd.callbacks.MetricAverageCallback(),
        *schedules, ScaleFromBase(),
    ]
    if r == 0:
        os.makedirs(args.ckpt_dir, exist_ok=True)
        callbacks.append(keras.callbacks.ModelCheckpoint(
            os.path.join(args.ckpt_dir, "checkpoint-{epoch}.keras")))
    hist = model.fit(x, y, batch_size=args.batch_per_chip,
                     epochs=args.epochs, initial_epoch=resume,
                     callbacks=callbacks, verbose=0)
    if r == 0:
        for e, loss in enumerate(hist.history.get("loss", []), resume):
            print(f"epoch {e}: loss {loss:.4f}", flush=True)
    return {"history": hist.history, "resumed_from": resume}


if __name__ == "__main__":
    main()
