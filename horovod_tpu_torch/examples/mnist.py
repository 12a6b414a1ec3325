"""MNIST on the port: one process per GPU, the canonical minimal recipe.

Twin of ``examples/jax_mnist.py``: ``init`` → scale the LR by the world size
→ wrap the optimizer (``DistributedOptimizer(SGD(lr·size, momentum=0.9))``)
→ broadcast parameters and optimizer state from rank 0 → train ``MnistMLP``
on this rank's shard of ``synthetic_mnist`` (``ShardedLoader``, reshuffled
per epoch).  Rank 0 prints each epoch's world-averaged loss and, with
``--ckpt-dir``, writes ``{"params", "opt"}`` to ``<dir>/step_<epoch>``.

    python -m horovod_tpu_torch.examples.mnist --smoke --device cpu

On the card (one process per GPU; ``torchrun`` or the JAX package's
launcher sets rank and world, else a world of one):

    python -m horovod_tpu_torch.examples.mnist --epochs 2
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from horovod_tpu_torch import basics
from horovod_tpu_torch.checkpoint import save_checkpoint
from horovod_tpu_torch.data import ShardedLoader, synthetic_mnist
from horovod_tpu_torch.models.mnist import MnistMLP
from horovod_tpu_torch.optim.distributed_optimizer import (
    DistributedOptimizer, broadcast_optimizer_state, broadcast_parameters,
    make_train_step)


def main(argv=None) -> list[float]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--batch-per-chip", type=int, default=32)
    p.add_argument("--base-lr", type=float, default=0.01)
    p.add_argument("--samples", type=int, default=4096)
    p.add_argument("--ckpt-dir", default=None,
                   help="write a rank-0 checkpoint here after each epoch")
    p.add_argument("--smoke", action="store_true",
                   help="2 epochs of 256 samples")
    p.add_argument("--device", default=None,
                   help="'cpu' for the gloo CPU world; default the card")
    args = p.parse_args(argv)
    if args.smoke:
        args.epochs, args.samples = 2, 256

    basics.init(args.device)
    dev = basics.device()
    model = MnistMLP(device=dev, seed=42)
    images, labels = synthetic_mnist(args.samples)

    def loss_fn(model, batch):
        x, y = batch
        return F.cross_entropy(model(x), y)

    # Scale the LR by world size (the reference recipe's first rule).
    opt = DistributedOptimizer(torch.optim.SGD(
        model.parameters(), lr=args.base_lr * basics.size(), momentum=0.9))
    # Broadcast the initial state from rank 0 so all ranks agree.
    broadcast_parameters(model, root_rank=0)
    broadcast_optimizer_state(opt, root_rank=0)

    step = make_train_step(loss_fn, opt)
    loader = ShardedLoader((images, labels), args.batch_per_chip, seed=1,
                           device=dev)
    means = []
    for epoch in range(args.epochs):
        loader.set_epoch(epoch)
        losses = [step(model, batch).loss for batch in loader]
        means.append(float(torch.stack(losses).mean()))
        if basics.rank() == 0:
            print(f"epoch {epoch}: loss {means[-1]:.4f}")
        if args.ckpt_dir is not None:
            save_checkpoint(args.ckpt_dir, {"params": model, "opt": opt},
                            step=epoch)
    basics.shutdown()
    return means


if __name__ == "__main__":
    main()
