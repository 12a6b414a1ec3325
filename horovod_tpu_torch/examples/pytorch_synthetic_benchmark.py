"""PyTorch synthetic benchmark through the port's Horovod frontend.

Twin of ``examples/pytorch_synthetic_benchmark.py`` (the reference's
harness, examples/pytorch_synthetic_benchmark.py:96-110) on
:mod:`horovod_tpu_torch.torch_frontend`: random data, the hook-driven
``DistributedOptimizer``, img/sec per worker as mean ± 1.96σ over
``--num-iters`` groups of ``--num-batches-per-iter`` batches, and the
total.  The models are the twin's (a compact ConvNet, or ``--model mlp``).

    python -m horovod_tpu_torch.examples.pytorch_synthetic_benchmark --smoke --device cpu
    python -m horovod_tpu_torch.examples.pytorch_synthetic_benchmark   # the card
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch.torch_frontend as hvd
from horovod_tpu_torch import basics


class ConvNet(torch.nn.Module):
    def __init__(self, classes: int = 1000):
        super().__init__()
        self.c1 = torch.nn.Conv2d(3, 32, 3, stride=2, padding=1)
        self.c2 = torch.nn.Conv2d(32, 64, 3, stride=2, padding=1)
        self.c3 = torch.nn.Conv2d(64, 128, 3, stride=2, padding=1)
        self.fc = torch.nn.Linear(128, classes)

    def forward(self, x):
        x = F.relu(self.c1(x))
        x = F.relu(self.c2(x))
        x = F.relu(self.c3(x))
        return self.fc(x.mean(dim=(2, 3)))


class Mlp(torch.nn.Module):
    def __init__(self, classes: int = 1000):
        super().__init__()
        self.fc1 = torch.nn.Linear(3 * 32 * 32, 256)
        self.fc2 = torch.nn.Linear(256, classes)

    def forward(self, x):
        return self.fc2(torch.tanh(self.fc1(x.flatten(1))))


def main(argv=None) -> list[float]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="convnet", choices=["convnet", "mlp"])
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--num-iters", type=int, default=10)
    p.add_argument("--num-batches-per-iter", type=int, default=10)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--device", default=None,
                   help="'cpu' for the gloo CPU world; default the card")
    args = p.parse_args(argv)
    if args.smoke:
        args.image_size = 32
        args.num_iters, args.num_batches_per_iter = 2, 2

    hvd.init(args.device)
    dev = basics.device()
    torch.manual_seed(0)
    model = (ConvNet if args.model == "convnet" else Mlp)().to(dev)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01 * hvd.size(),
                        momentum=0.9),
        named_parameters=model.named_parameters())

    data = torch.randn(args.batch_size, 3, args.image_size, args.image_size,
                       device=dev)
    target = torch.randint(0, 1000, (args.batch_size,), device=dev)

    def benchmark_step():
        opt.zero_grad()
        loss = F.cross_entropy(model(data), target)
        loss.backward()
        opt.step()

    if hvd.rank() == 0:
        print(f"Model: {args.model}  Batch size: {args.batch_size}  "
              f"Workers: {hvd.size()}")
    benchmark_step()                         # warm-up

    img_secs = []
    for i in range(args.num_iters):
        t0 = time.perf_counter()
        for _ in range(args.num_batches_per_iter):
            benchmark_step()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        rate = (args.batch_size * args.num_batches_per_iter
                / (time.perf_counter() - t0))
        img_secs.append(rate)
        if hvd.rank() == 0:
            print(f"Iter #{i}: {rate:.1f} img/sec per worker")

    mean, conf = np.mean(img_secs), 1.96 * np.std(img_secs)
    if hvd.rank() == 0:
        print(f"Img/sec per worker: {mean:.1f} +-{conf:.1f}")
        print(f"Total img/sec on {hvd.size()} worker(s): "
              f"{mean * hvd.size():.1f} +-{conf * hvd.size():.1f}")
    return img_secs


if __name__ == "__main__":
    main()
