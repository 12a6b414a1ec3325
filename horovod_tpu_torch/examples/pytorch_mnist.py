"""PyTorch MNIST through the port's Horovod frontend, hook-driven.

Twin of ``examples/pytorch_mnist.py`` (the reference's headline torch
example) on :mod:`horovod_tpu_torch.torch_frontend`: ``init`` → scale the
LR by the world size → ``broadcast_parameters`` and
``broadcast_optimizer_state`` from rank 0 → ``DistributedOptimizer``,
whose hooks all-reduce each gradient during the backward → train on this
rank's shard of ``synthetic_mnist`` (``shard_indices``, reshuffled each
epoch); rank 0 prints each epoch's loss and the rank-averaged final loss.

    python -m horovod_tpu_torch.examples.pytorch_mnist --epochs 1 --device cpu
    python -m horovod_tpu_torch.examples.pytorch_mnist          # the card

One process per GPU: ``torchrun`` or the JAX package's launcher sets rank
and world (and ``HVD_TORCH_CONTROLLER_TRANSPORT`` the engine's control
plane), else a world of one.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch.torch_frontend as hvd
from horovod_tpu_torch import basics
from horovod_tpu_torch.data import shard_indices, synthetic_mnist


class Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = torch.nn.Linear(784, 128)
        self.fc2 = torch.nn.Linear(128, 10)

    def forward(self, x):
        x = torch.tanh(self.fc1(x.reshape(x.shape[0], -1)))
        return self.fc2(x)


def main(argv=None) -> float:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--samples", type=int, default=2048)
    p.add_argument("--device", default=None,
                   help="'cpu' for the gloo CPU world; default the card")
    args = p.parse_args(argv)

    hvd.init(args.device)
    dev = basics.device()
    torch.manual_seed(42)                       # same init everywhere...
    model = Net().to(dev)
    # ...but broadcast anyway, like the reference (robust to seed drift).
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = torch.optim.SGD(model.parameters(), lr=args.lr * hvd.size(),
                          momentum=0.5)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    opt = hvd.DistributedOptimizer(opt,
                                   named_parameters=model.named_parameters())

    images, labels = synthetic_mnist(args.samples)
    images = images.reshape(len(images), -1)
    losses = []
    for epoch in range(args.epochs):
        idx = shard_indices(len(images), hvd.rank(), hvd.size(), epoch=epoch,
                            drop_last=True)
        losses = []
        for s in range(0, len(idx) - args.batch_size + 1, args.batch_size):
            b = idx[s:s + args.batch_size]
            x = torch.from_numpy(images[b]).to(dev)
            y = torch.from_numpy(labels[b].astype(np.int64)).to(dev)
            opt.zero_grad()
            loss = F.cross_entropy(model(x), y)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
        if hvd.rank() == 0:
            print(f"epoch {epoch}: loss {np.mean(losses):.4f}")
    final = hvd.allreduce(torch.tensor([float(np.mean(losses))], device=dev),
                          average=True, name="final_loss")
    if hvd.rank() == 0:
        print(f"final loss (rank-averaged): {float(final[0]):.4f}")
    return float(final[0])


if __name__ == "__main__":
    main()
