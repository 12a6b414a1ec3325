"""Fault-tolerant PyTorch MNIST with ``hvd.elastic.TorchState``.

Twin of ``examples/pytorch_elastic.py`` on
:mod:`horovod_tpu_torch.torch_frontend`: declare the model, optimizer and
progress in ``TorchState``, wrap the loop in ``@hvd.elastic.run`` (which
restores the newest durable commit on every (re)start and replays after a
``HorovodInternalError``), and commit on a cadence, advance-then-commit, so
that a restore never replays work the commit covers.

    python -m horovod_tpu_torch.examples.pytorch_elastic --epochs 2 --device cpu
    python -m horovod_tpu_torch.examples.pytorch_elastic          # the card

One process per GPU under a launcher that relaunches the whole gang:

    python -m horovod_tpu.launch --nproc 2 --cpu --restarts 3 -- \\
        python -m horovod_tpu_torch.examples.pytorch_elastic --device cpu
"""

from __future__ import annotations

import argparse
import os
import tempfile

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


def main(argv=None) -> float | None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--samples", type=int, default=2048)
    p.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "hvd_tpu_torch_elastic"))
    p.add_argument("--device", default=None,
                   help="'cpu' for the gloo CPU world; default the card")
    args = p.parse_args(argv)

    hvd.init(args.device)
    dev = basics.device()
    torch.manual_seed(42)
    model = Net().to(dev)
    opt = torch.optim.SGD(model.parameters(), lr=args.lr * hvd.size(),
                          momentum=0.5)
    dist_opt = hvd.DistributedOptimizer(
        opt, named_parameters=model.named_parameters())

    state = hvd.elastic.TorchState(model=model, optimizer=opt,
                                   ckpt_dir=args.ckpt_dir, epoch=0)

    images, labels = synthetic_mnist(args.samples)
    images = images.reshape(len(images), -1)

    @hvd.elastic.run
    def train(state):
        # run() already restored the newest commit and synced every rank
        # (the reference's broadcast_parameters + broadcast_optimizer_state
        # preamble).
        losses = []                 # a resume may cover every epoch
        while state.epoch < args.epochs:
            idx = shard_indices(len(images), hvd.rank(), hvd.size(),
                                epoch=state.epoch, drop_last=True)
            losses = []
            for s in range(0, len(idx) - args.batch_size + 1,
                           args.batch_size):
                b = idx[s:s + args.batch_size]
                x = torch.from_numpy(images[b]).to(dev)
                y = torch.from_numpy(labels[b].astype(np.int64)).to(dev)
                dist_opt.zero_grad()
                loss = F.cross_entropy(state.model(x), y)
                loss.backward()
                dist_opt.step()
                losses.append(float(loss.detach()))
            if hvd.rank() == 0 and losses:
                print(f"epoch {state.epoch}: loss {np.mean(losses):.4f}",
                      flush=True)
            state.epoch += 1
            state.commit()          # the epoch boundary is durable
        return float(np.mean(losses)) if losses else None

    out = train(state)
    hvd.shutdown()
    return out


if __name__ == "__main__":
    main()
