"""MNIST on the hook route: the define-by-run recipe on the port.

Twin of ``examples/jax_mnist_eager.py`` (the reference's
pytorch_mnist.py): each gradient's allreduce is enqueued by its
post-accumulate-grad hook during the backward
(:class:`~horovod_tpu_torch.optim.eager_optimizer.EagerDistributedOptimizer`),
``step()`` waits for them and updates; ``MnistMLP`` on this rank's shard of
``synthetic_mnist`` (``ShardedLoader``), parameters broadcast from rank 0 at
the start, SGD at ``base_lr · size`` with momentum 0.9.  ``--sparse`` takes
the fork's top-k sparse allreduce (5 % of each gradient).  Rank 0 prints
each epoch's last loss averaged over the ranks; ``main`` returns every
step's loss.

    python -m horovod_tpu_torch.examples.mnist_eager --smoke --device cpu

On the card drop ``--device cpu``.
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from horovod_tpu_torch import basics
from horovod_tpu_torch.data import ShardedLoader, synthetic_mnist
from horovod_tpu_torch.models.mnist import MnistMLP
from horovod_tpu_torch.optim.distributed_optimizer import broadcast_parameters
from horovod_tpu_torch.optim.eager_optimizer import EagerDistributedOptimizer


def main(argv=None, state_dict=None) -> list[float]:
    """``state_dict``: the initial parameters in place of the seeded draw
    (the JAX script's flax init through
    ``models.convert.vision_state_dict_from_flax``, say)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--batch-per-chip", type=int, default=32)
    p.add_argument("--base-lr", type=float, default=0.01)
    p.add_argument("--samples", type=int, default=4096)
    p.add_argument("--sparse", action="store_true",
                   help="use the fork's top-k sparse allreduce for grads")
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
    if state_dict is not None:
        model.load_state_dict(state_dict)
    images, labels = synthetic_mnist(args.samples)
    broadcast_parameters(model, root_rank=0)

    def loss_fn(model, batch):
        x, y = batch
        return F.cross_entropy(model(x), y)

    opt = EagerDistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=args.base_lr * basics.size(),
                        momentum=0.9),
        model.named_parameters(), is_sparse=args.sparse, sparse_ratio=0.05)
    loader = ShardedLoader((images, labels), args.batch_per_chip, seed=1,
                           device=dev)
    losses = []
    for epoch in range(args.epochs):
        loader.set_epoch(epoch)
        for batch in loader:
            losses.append(opt.backward(loss_fn, model, batch))  # hooks fire
            opt.step()
            opt.zero_grad()
        if basics.rank() == 0:
            print(f"epoch {epoch}: loss {float(opt.last_loss()):.4f}",
                  flush=True)
    basics.shutdown()
    return [float(x) for x in losses]


if __name__ == "__main__":
    main()
