"""MNIST with a train/eval estimator-style loop on the port.

Twin of ``examples/jax_mnist_estimator.py`` (the reference's
tensorflow_mnist_estimator.py): steps, not epochs, are the unit; the
parameters are broadcast from rank 0 before step 0 (the
``BroadcastGlobalVariablesHook``); ``MnistConvNet`` trains with
``DistributedOptimizer(Adam(base_lr · size))`` through ``make_train_step``
on this rank's shard of ``synthetic_mnist``; every ``--eval-every`` steps
the held-out accuracy is evaluated (``make_eval_step``, averaged over the
ranks), and rank 0 checkpoints the parameters at the end.  Each rank runs
``train_steps // size + 1`` steps, so the world's work is the same at any
size.

    python -m horovod_tpu_torch.examples.mnist_estimator --smoke --device cpu

On the card drop ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch
import torch.nn.functional as F

from horovod_tpu_torch import basics
from horovod_tpu_torch.checkpoint import save_checkpoint
from horovod_tpu_torch.data import ShardedLoader, synthetic_mnist, to_device
from horovod_tpu_torch.models.mnist import MnistConvNet
from horovod_tpu_torch.optim.distributed_optimizer import (
    DistributedOptimizer, broadcast_parameters, make_train_step)
from horovod_tpu_torch.training import make_eval_step


def main(argv=None, state_dict=None) -> dict:
    """Every step's loss, the evaluations and the final parameters.
    ``state_dict``: the initial parameters in place of the seeded draw
    (the JAX script's flax init through
    ``models.convert.vision_state_dict_from_flax``, say)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--train-steps", type=int, default=200)
    p.add_argument("--eval-every", type=int, default=50)
    p.add_argument("--batch-per-chip", type=int, default=16)
    p.add_argument("--base-lr", type=float, default=0.005)
    p.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "hvd_tpu_torch_mnist_estimator"))
    p.add_argument("--smoke", action="store_true",
                   help="12 steps, evaluated every 4")
    p.add_argument("--device", default=None,
                   help="'cpu' for the gloo CPU world; default the card")
    args = p.parse_args(argv)
    if args.smoke:
        args.train_steps, args.eval_every = 12, 4

    basics.init(args.device)
    dev = basics.device()
    model = MnistConvNet(device=dev, seed=0)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    images, labels = synthetic_mnist(4096)
    eval_images, eval_labels = synthetic_mnist(512, seed=7)
    eval_batch = (to_device(eval_images, dev),
                  to_device(eval_labels, dev))

    def loss_fn(model, batch):
        x, y = batch
        return F.cross_entropy(model(x), y)

    def metrics(model, batch):
        x, y = batch
        logits = model(x)
        return {"accuracy": (logits.argmax(-1) == y).float().mean(),
                "loss": F.cross_entropy(logits, y)}

    opt = DistributedOptimizer(torch.optim.Adam(
        model.parameters(), lr=args.base_lr * basics.size()))
    # The BroadcastGlobalVariablesHook: every rank starts from rank 0's.
    broadcast_parameters(model, root_rank=0)

    step_fn = make_train_step(loss_fn, opt)
    evaluate = make_eval_step(metrics)
    loader = ShardedLoader((images, labels), args.batch_per_chip, seed=3,
                           device=dev)
    it, epoch = iter(loader), 0
    losses, evals = [], []
    step = 0
    for step in range(args.train_steps // basics.size() + 1):
        try:
            batch = next(it)
        except StopIteration:
            epoch += 1
            loader.set_epoch(epoch)
            it = iter(loader)
            batch = next(it)
        out = step_fn(model, batch)
        losses.append(float(out.loss))
        if step % args.eval_every == 0:
            model.eval()
            m = evaluate(model, eval_batch)
            model.train()
            evals.append({"step": step, **m})
            if basics.rank() == 0:
                print(f"step {step}: loss {losses[-1]:.4f} "
                      f"eval_acc {m['accuracy']:.3f}", flush=True)
    save_checkpoint(args.ckpt_dir, {"params": model}, step=step)
    basics.shutdown()
    return {"losses": losses, "evals": evals,
            "params": {k: v.detach().cpu()
                       for k, v in model.state_dict().items()}}


if __name__ == "__main__":
    main()
