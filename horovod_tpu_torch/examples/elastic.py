"""Fault-tolerant MNIST with ``elastic``: commit, restore, replay.

Twin of ``examples/jax_elastic.py``: every piece of resumable state is
declared in a state object, here :class:`~horovod_tpu_torch.torch_elastic.
TorchState` over the live ``MnistMLP``, its optimizer and the ``epoch`` and
``batch`` counters; the loop is wrapped in ``@elastic.run``, which on entry
restores the newest durable commit (so a relaunched gang resumes by
itself) and replays after a ``HorovodInternalError``; ``state.commit()``
every ``--commit-every`` batches and at each epoch's end, advance then
commit, so that a restore never replays work onto parameters that already
hold it.  A second run on the same ``--ckpt-dir`` restores the final
commit, past the last epoch, and trains nothing.

    python -m horovod_tpu_torch.examples.elastic --epochs 2 --device cpu

Under the gang launcher, kill a worker mid-run to watch it resume:

    python -m horovod_tpu.launch --nproc 2 --cpu --restarts 3 -- \\
        python -m horovod_tpu_torch.examples.elastic --device cpu
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch
import torch.nn.functional as F

from horovod_tpu_torch import basics, elastic
from horovod_tpu_torch.data import ShardedLoader, synthetic_mnist
from horovod_tpu_torch.models.mnist import MnistMLP
from horovod_tpu_torch.optim.distributed_optimizer import (
    DistributedOptimizer, make_train_step)
from horovod_tpu_torch.torch_elastic import TorchState


def main(argv=None, state_dict=None) -> dict:
    """Every step's loss this run, and the epoch and commit it ends on.
    ``state_dict``: the initial parameters in place of the seeded draw
    (the JAX script's flax init through
    ``models.convert.vision_state_dict_from_flax``, say); a restored
    commit replaces them."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--batch-per-chip", type=int, default=32)
    p.add_argument("--base-lr", type=float, default=0.01)
    p.add_argument("--samples", type=int, default=2048)
    p.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "hvd_tpu_torch_elastic_mnist"))
    p.add_argument("--commit-every", type=int, default=20,
                   help="batches between durable commits")
    p.add_argument("--device", default=None,
                   help="'cpu' for the gloo CPU world; default the card")
    args = p.parse_args(argv)

    basics.init(args.device)
    dev = basics.device()
    model = MnistMLP(device=dev, seed=42)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    images, labels = synthetic_mnist(args.samples)

    def loss_fn(model, batch):
        x, y = batch
        return F.cross_entropy(model(x), y)

    sgd = torch.optim.SGD(model.parameters(),
                          lr=args.base_lr * basics.size(), momentum=0.9)
    train_step = make_train_step(loss_fn, DistributedOptimizer(sgd))
    state = TorchState(model=model, optimizer=sgd, ckpt_dir=args.ckpt_dir,
                       epoch=0, batch=0)
    losses: list[float] = []

    @elastic.run
    def train(state):
        # The loader's order is a function of the epoch (seed=epoch): that
        # is what makes skipping a restored commit's batches sound.
        while state.epoch < args.epochs:
            loader = ShardedLoader((images, labels), args.batch_per_chip,
                                   seed=state.epoch, device=dev)
            out = None              # a resume may skip the whole epoch
            for i, batch in enumerate(loader):
                if i < state.batch:
                    continue        # covered by the restored commit
                out = train_step(state.model, batch)
                losses.append(float(out.loss))
                state.batch = i + 1
                if state.batch % args.commit_every == 0:
                    state.commit()
            if basics.rank() == 0 and out is not None:
                print(f"epoch {state.epoch}: loss {float(out.loss):.4f}",
                      flush=True)
            state.epoch += 1
            state.batch = 0
            state.commit()          # the epoch boundary is always durable
        return state

    train(state)
    out = {"losses": losses, "epoch": state.epoch,
           "commit_step": state.commit_step}
    basics.shutdown()
    return out


if __name__ == "__main__":
    main()
