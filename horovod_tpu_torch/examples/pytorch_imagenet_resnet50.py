"""ImageNet ResNet-50 through Horovod's PyTorch API on the port: the
canonical fault-recovery recipe.

Twin of ``examples/pytorch_imagenet_resnet50.py`` (which drives the JAX
package's torch frontend) on :mod:`horovod_tpu_torch.torch_frontend`,
every Horovod step kept:

1. ``hvd.init()``; rank 0 alone prints;
2. scan the disk for the last epoch's checkpoint, then
   ``hvd.broadcast(resume_from_epoch, root_rank=0)``, so that every rank
   agrees although only rank 0 holds the files;
3. each rank trains on its shard (``shard_indices``, reshuffled by epoch);
4. the LR scaled by the world size, warmed up over ``--warmup-epochs`` and
   decayed stepwise after (epochs 30, 60, 80);
5. ``--fp16-allreduce``: gradients cross the wire as fp16;
6. ``hvd.DistributedOptimizer(named_parameters=...)``;
7. resume: rank 0 alone loads, then ``broadcast_parameters`` and
   ``broadcast_optimizer_state`` bring every rank to the root's state;
8. train, validate, and rank 0 writes ``checkpoint-{epoch}.pt`` each epoch.

``--crash-after N`` kills a rank (``os._exit(3)``) right after epoch N's
checkpoint is on disk, as a preempted worker goes: the last rank, which is
not rank 0 where the world has two or more (the JAX script kills a
non-zero rank), and rank 0 itself in a world of one.  Relaunched with the
same ``--checkpoint-dir`` it resumes from N and prints ``resumed_from N``.

The model is the JAX script's compact ResNet (BasicBlock v1.5, ResNet-50's
stage layout), its weights drawn under ``torch.manual_seed(--seed)`` and the
data from ``numpy.random.default_rng(--seed)`` as there, so the two
scripts' losses agree.

    python -m horovod_tpu_torch.examples.pytorch_imagenet_resnet50 --smoke --device cpu

On the card drop ``--device cpu``; one process a GPU under a launcher
(``torchrun``, or ``python -m horovod_tpu.launch --nproc N -- python -m
horovod_tpu_torch.examples.pytorch_imagenet_resnet50``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch.torch_frontend as hvd
from horovod_tpu_torch import basics
from horovod_tpu_torch.data import shard_indices


class BasicBlock(torch.nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = torch.nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = torch.nn.BatchNorm2d(cout)
        self.conv2 = torch.nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = torch.nn.BatchNorm2d(cout)
        self.down = None
        if stride != 1 or cin != cout:
            self.down = torch.nn.Sequential(
                torch.nn.Conv2d(cin, cout, 1, stride, bias=False),
                torch.nn.BatchNorm2d(cout),
            )

    def forward(self, x):
        r = x if self.down is None else self.down(x)
        x = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(x)) + r)


class ResNet(torch.nn.Module):
    """ResNet-50's stage layout (3, 4, 6, 3) on BasicBlocks."""

    def __init__(self, num_classes=1000, width=64, stages=(3, 4, 6, 3)):
        super().__init__()
        self.stem = torch.nn.Sequential(
            torch.nn.Conv2d(3, width, 7, 2, 3, bias=False),
            torch.nn.BatchNorm2d(width),
            torch.nn.ReLU(),
            torch.nn.MaxPool2d(3, 2, 1),
        )
        blocks, cin = [], width
        for i, n in enumerate(stages):
            cout = width * (2 ** i)
            for j in range(n):
                blocks.append(BasicBlock(cin, cout,
                                         2 if (i > 0 and j == 0) else 1))
                cin = cout
        self.blocks = torch.nn.Sequential(*blocks)
        self.head = torch.nn.Linear(cin, num_classes)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        return self.head(x.mean(dim=(2, 3)))


def checkpoint_path(args, epoch: int) -> str:
    return os.path.join(args.checkpoint_dir, f"checkpoint-{epoch}.pt")


def save_checkpoint(args, model, optimizer, epoch: int) -> None:
    """Rank 0 writes the model and optimizer state."""
    if hvd.rank() != 0:
        return
    os.makedirs(args.checkpoint_dir, exist_ok=True)
    torch.save({"model": model.state_dict(),
                "optimizer": optimizer.state_dict()},
               checkpoint_path(args, epoch))


def adjust_learning_rate(args, optimizer, epoch: int) -> None:
    """Warm up from ``base_lr`` to ``size · base_lr`` over
    ``--warmup-epochs``, then decay ×0.1 at epochs 30, 60 and 80."""
    if epoch < args.warmup_epochs:
        alpha = (epoch + 1) / max(args.warmup_epochs, 1)
        adj = 1.0 / hvd.size() * (alpha * (hvd.size() - 1) + 1)
    elif epoch < 30:
        adj = 1.0
    elif epoch < 60:
        adj = 1e-1
    elif epoch < 80:
        adj = 1e-2
    else:
        adj = 1e-3
    for group in optimizer.param_groups:
        group["lr"] = args.base_lr * hvd.size() * adj


def metric_average(value: float, name: str) -> float:
    """A scalar averaged over the ranks."""
    t = torch.tensor([float(value)], device=basics.device())
    return float(hvd.allreduce(t, average=True, name=name)[0])


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--epochs", type=int, default=90)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--val-batch-size", type=int, default=32)
    p.add_argument("--base-lr", type=float, default=0.0125)
    p.add_argument("--warmup-epochs", type=int, default=5)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--wd", type=float, default=5e-5)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--fp16-allreduce", action="store_true",
                   help="gradients cross the wire as fp16")
    p.add_argument("--checkpoint-dir", default="./checkpoints")
    p.add_argument("--samples", type=int, default=1024,
                   help="synthetic dataset size")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--smoke", action="store_true",
                   help="tiny everything: the fault-recovery drill in "
                        "seconds")
    p.add_argument("--crash-after", type=int, default=0, metavar="N",
                   help="die abruptly (os._exit) right after epoch N's "
                        "checkpoint is saved; a relaunch resumes from N")
    p.add_argument("--device", default=None,
                   help="'cpu' for the gloo CPU world; default the card")
    args = p.parse_args(argv)
    if args.smoke:
        args.epochs, args.batch_size, args.val_batch_size = 2, 4, 4
        args.samples, args.image_size, args.num_classes = 32, 32, 10
        args.width, args.warmup_epochs = 8, 1

    hvd.init(args.device)
    dev = basics.device()
    verbose = hvd.rank() == 0

    # Resume point: only rank 0 has the checkpoints; every rank takes its
    # epoch.
    resume_from_epoch = 0
    for try_epoch in range(args.epochs, 0, -1):
        if os.path.exists(checkpoint_path(args, try_epoch)):
            resume_from_epoch = try_epoch
            break
    resume_from_epoch = int(hvd.broadcast(
        torch.tensor(resume_from_epoch, device=dev), root_rank=0,
        name="resume_from_epoch").item())

    rng = np.random.default_rng(args.seed)
    images = rng.standard_normal(
        (args.samples, 3, args.image_size, args.image_size), np.float32)
    labels = rng.integers(0, args.num_classes, args.samples)

    # nn.Module initialisers draw from the global generator: seed it for
    # the construction only, and leave the caller's state as it was.
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        model = ResNet(num_classes=args.num_classes, width=args.width)
    model = model.to(dev)
    optimizer = torch.optim.SGD(
        model.parameters(), lr=args.base_lr * hvd.size(),
        momentum=args.momentum, weight_decay=args.wd)
    compression = (hvd.Compression.fp16 if args.fp16_allreduce
                   else hvd.Compression.none)

    # Restore on rank 0 only, then broadcast.
    if resume_from_epoch > 0 and hvd.rank() == 0:
        ckpt = torch.load(checkpoint_path(args, resume_from_epoch),
                          map_location=dev, weights_only=True)
        model.load_state_dict(ckpt["model"])
        optimizer.load_state_dict(ckpt["optimizer"])
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(optimizer, root_rank=0)

    optimizer = hvd.DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters(),
        compression=compression)

    def batch(idx):
        return (torch.from_numpy(images[idx]).to(dev),
                torch.from_numpy(labels[idx].astype(np.int64)).to(dev))

    history = []
    n_train = int(args.samples * 0.75)
    for epoch in range(resume_from_epoch, args.epochs):
        model.train()
        adjust_learning_rate(args, optimizer, epoch)
        idx = shard_indices(n_train, hvd.rank(), hvd.size(), epoch=epoch,
                            drop_last=True)
        losses, accs = [], []
        for s in range(0, len(idx) - args.batch_size + 1, args.batch_size):
            x, y = batch(idx[s:s + args.batch_size])
            optimizer.zero_grad()
            out = model(x)
            loss = F.cross_entropy(out, y)
            loss.backward()
            optimizer.step()
            losses.append(float(loss.detach()))
            accs.append(float((out.argmax(1) == y).float().mean()))
        row = {"epoch": epoch + 1,
               "train_loss": metric_average(np.mean(losses), "train_loss"),
               "train_acc": metric_average(np.mean(accs), "train_accuracy")}

        # Validation on the held-out shard.
        model.eval()
        vidx = shard_indices(args.samples - n_train, hvd.rank(), hvd.size(),
                             drop_last=True) + n_train
        with torch.no_grad():
            vx, vy = batch(vidx)
            vout = model(vx)
            row["val_loss"] = metric_average(
                float(F.cross_entropy(vout, vy)), "val_loss")
            row["val_acc"] = metric_average(
                float((vout.argmax(1) == vy).float().mean()), "val_accuracy")
        history.append(row)
        if verbose:
            print(f"epoch {epoch + 1}: train_loss {row['train_loss']:.4f} "
                  f"train_acc {row['train_acc']:.3f} val_loss "
                  f"{row['val_loss']:.4f} val_acc {row['val_acc']:.3f}",
                  flush=True)
        save_checkpoint(args, model, optimizer, epoch + 1)
        if args.crash_after and epoch + 1 >= args.crash_after:
            # The barrier returns only after rank 0 is back from
            # torch.save: the checkpoint is durable before a rank dies,
            # with no shutdown and no clean-up, as a preempted worker goes.
            hvd.allreduce(torch.zeros(1, device=dev), name="crash_barrier")
            if hvd.rank() == hvd.size() - 1:
                print(f"CRASH-INJECTED after epoch {epoch + 1}", flush=True)
                os._exit(3)

    if verbose:
        print(f"done: trained epochs {resume_from_epoch + 1}..{args.epochs} "
              f"resumed_from {resume_from_epoch}", flush=True)
    hvd.shutdown()
    return history


if __name__ == "__main__":
    main()
