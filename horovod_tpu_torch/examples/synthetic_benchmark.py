"""ResNet-50 synthetic throughput benchmark on the port.

Twin of ``examples/synthetic_benchmark.py`` (the reference's
``pytorch_synthetic_benchmark.py``): ResNet-50 on random data through
``DistributedOptimizer(SGD(0.01·size, momentum=0.9))`` and
``make_train_step``; img/sec per card as mean ± 1.96σ over ``--num-iters``
groups of ``--num-batches-per-iter`` batches, and the world's total.  bf16
compute with f32 parameters and BN on the card (``channels_last``, cuDNN
autotuning on), f32 on the CPU.

    python -m horovod_tpu_torch.examples.synthetic_benchmark --smoke --device cpu
    python -m horovod_tpu_torch.examples.synthetic_benchmark        # the card

``--compression`` takes the JAX twin's choices: none, fp16, bf16, int8,
powersgd (``PowerSGDCompressor(rank=4)``) and ef-topk
(``ErrorFeedback(TopKCompressor(ratio=0.01))``); ``--adasum`` combines the
gradients with Adasum (with none, fp16 or bf16 only).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from horovod_tpu_torch import basics
from horovod_tpu_torch.data import synthetic_imagenet, to_device
from horovod_tpu_torch.models.resnet import ResNet50
from horovod_tpu_torch.ops.collective_ops import Adasum, Average
from horovod_tpu_torch.ops.compression import Compression, TopKCompressor
from horovod_tpu_torch.ops.powersgd import ErrorFeedback, PowerSGDCompressor
from horovod_tpu_torch.optim.distributed_optimizer import (
    DistributedOptimizer, broadcast_parameters, make_train_step)

_LOSSY = ("int8", "powersgd", "ef-topk")


def compressor(name: str):
    """The JAX twin's mapping of ``--compression``."""
    if name == "powersgd":
        return PowerSGDCompressor(rank=4)
    if name == "ef-topk":
        return ErrorFeedback(TopKCompressor(ratio=0.01))
    return getattr(Compression, name)


def main(argv=None) -> list[float]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch-size", type=int, default=32,
                   help="per-card batch (reference default 32)")
    p.add_argument("--num-iters", type=int, default=10)
    p.add_argument("--num-batches-per-iter", type=int, default=10)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--compression", default="none",
                   choices=["none", "fp16", "bf16", *_LOSSY],
                   help="gradient compression on the wire")
    p.add_argument("--adasum", action="store_true",
                   help="combine gradients with op=Adasum instead of Average")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--device", default=None,
                   help="'cpu' for the gloo CPU world; default the card")
    args = p.parse_args(argv)
    if args.adasum and args.compression in _LOSSY:
        p.error("--adasum composes with none/fp16/bf16 compression only")
    if args.smoke:
        args.image_size, args.num_iters, args.num_batches_per_iter = 32, 2, 2
        args.batch_size = min(args.batch_size, 2)

    basics.init(args.device)
    dev = basics.device()
    on_card = dev.type == "cuda"
    torch.backends.cudnn.benchmark = on_card
    n = basics.size()
    model = ResNet50(dtype=torch.bfloat16 if on_card else torch.float32,
                     device=dev)
    images, labels = synthetic_imagenet(args.batch_size, args.image_size)
    batch = (to_device(images, dev), to_device(labels, dev))

    def loss_fn(model, batch):
        x, y = batch
        return F.cross_entropy(model(x, train=True), y)

    opt = DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01 * n, momentum=0.9),
        compression=compressor(args.compression),
        op=Adasum if args.adasum else Average)
    broadcast_parameters(model, root_rank=0)
    step = make_train_step(loss_fn, opt)
    if basics.rank() == 0:
        print(f"Model: ResNet50  Batch size/card: {args.batch_size}  "
              f"Cards: {n}  Device: {dev}  Compression: {args.compression}"
              + ("  Op: Adasum" if args.adasum else ""))

    float(step(model, batch).loss)                     # warm-up
    img_secs = []
    for i in range(args.num_iters):
        t0 = time.perf_counter()
        for _ in range(args.num_batches_per_iter):
            out = step(model, batch)
        float(out.loss)                                # waits for the card
        rate = args.batch_size * args.num_batches_per_iter / (
            time.perf_counter() - t0)
        img_secs.append(rate)
        if basics.rank() == 0:
            print(f"Iter #{i}: {rate:.1f} img/sec per card")
    mean, conf = np.mean(img_secs), 1.96 * np.std(img_secs)
    if basics.rank() == 0:
        print(f"Img/sec per card: {mean:.1f} +-{conf:.1f}")
        print(f"Total img/sec on {n} card(s): {mean * n:.1f} +-{conf * n:.1f}")
    basics.shutdown()
    return img_secs


if __name__ == "__main__":
    main()
