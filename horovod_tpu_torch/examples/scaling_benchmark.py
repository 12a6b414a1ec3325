"""Scaling efficiency on the port: Horovod's headline metric.

Twin of ``examples/scaling_benchmark.py``: per-rank throughput of the
synthetic data-parallel step (``DistributedOptimizer`` and
``make_train_step``) in worlds of growing size n, divided by its value at
n = 1, and beside it the contention curve C(n): the per-rank rate of a
communication-free workload (a chain of batched matrix products) in the
same world, so that ``collective_efficiency`` isolates what the gradient
collectives cost where the n ranks share cores.

On the CPU each n ∈ {1, 2, 4, ...} up to ``--max-world`` is a gloo world
of n processes on this host (n = 1 is this process).  On the card only
n = 1 runs: a world of more ranks needs a card each (NCCL refuses two
ranks on one GPU), and the output says so.  Images and labels are ones
and zeros, as in the JAX script.

    python -m horovod_tpu_torch.examples.scaling_benchmark --smoke --device cpu
    python -m horovod_tpu_torch.examples.scaling_benchmark --model resnet50   # the card
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import tempfile
import time

import torch
import torch.nn.functional as F

from horovod_tpu_torch import basics


def _build(model_name: str, on_card: bool, image_size: int, dev):
    """(model, per-example input shape, classes); bf16 compute on the
    card, f32 on the CPU."""
    dtype = torch.bfloat16 if on_card else torch.float32
    if model_name == "mlp":
        from horovod_tpu_torch.models.mnist import MnistMLP

        return MnistMLP(device=dev, seed=0), (28 * 28,), 10
    if model_name == "vit":
        from horovod_tpu_torch.models.vit import ViT_B16

        model = ViT_B16(dtype=dtype, image_size=image_size, device=dev)
    elif model_name == "inception":
        from horovod_tpu_torch.models.inception import InceptionV3

        model = InceptionV3(dtype=dtype, device=dev)
    else:
        from horovod_tpu_torch.models.resnet import ResNet50

        model = ResNet50(dtype=dtype, device=dev)
    return model, (image_size, image_size, 3), 1000


def _throughput(args) -> dict:
    """Images/s a rank of the distributed step in the current world, the
    best of ``--iters`` groups of ``--batches`` steps; and the steps'
    losses (each averaged over the world)."""
    from horovod_tpu_torch.optim.distributed_optimizer import (
        DistributedOptimizer, broadcast_parameters, make_train_step)

    dev = basics.device()
    model, in_shape, classes = _build(args.model, dev.type == "cuda",
                                      args.img, dev)
    if args.state_dict is not None:
        model.load_state_dict(args.state_dict)
    images = torch.ones((args.bs, *in_shape), device=dev)
    labels = torch.zeros((args.bs,), dtype=torch.int64, device=dev)
    kw = {"train": True} if args.model != "mlp" else {}

    def loss_fn(model, batch):
        x, y = batch
        out = model(x, **kw)
        logits = out[0] if isinstance(out, tuple) else out
        return F.cross_entropy(logits.float(), y)

    broadcast_parameters(model, root_rank=0)
    step = make_train_step(loss_fn, DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)))
    losses = [float(step(model, (images, labels)).loss)]
    rates = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        for _ in range(args.batches):
            out = step(model, (images, labels))
        losses.append(float(out.loss))            # waits for the card
        rates.append(args.bs * args.batches / (time.perf_counter() - t0))
    return {"rate": max(rates), "losses": losses}


def _contention(args) -> float:
    """Per-rank rate of a communication-free workload on this rank: six
    tanh(x @ x) over a [bs, 192, 192] batch, the JAX script's C(n)."""
    dev = basics.device()
    x = torch.ones((args.bs, 192, 192), device=dev)

    def local(c):
        for _ in range(6):
            c = torch.tanh(c @ c)
        return c

    r = local(x)
    rates = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        for _ in range(args.batches):
            r = local(r)
        float(r[0, 0, 0])
        rates.append(args.bs * args.batches / (time.perf_counter() - t0))
    return max(rates)


def _measure(args) -> dict:
    torch.manual_seed(0)
    out = _throughput(args)
    if not args.no_contention_baseline:
        out["contention"] = _contention(args)
    return out


def _rank(rank: int, n: int, port: int, args, out_dir: str) -> None:
    """One rank of a gloo world of ``n`` on this host."""
    os.environ.update(
        HOROVOD_TPU_PROCESS_ID=str(rank), HOROVOD_TPU_NUM_PROCESSES=str(n),
        HOROVOD_TPU_COORDINATOR=f"127.0.0.1:{port}",
        HOROVOD_TPU_LOCAL_RANK=str(rank), HOROVOD_TPU_LOCAL_SIZE=str(n))
    torch.set_num_threads(1)
    basics.init("cpu")
    try:
        res = _measure(args)
    finally:
        basics.shutdown()
    if rank == 0:
        with open(os.path.join(out_dir, "rank0.json"), "w") as f:
            json.dump(res, f)


def _world(n: int, args) -> dict:
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory(prefix="hvd-scaling-") as d:
        mp.start_processes(_rank, args=(n, port, args, d), nprocs=n,
                           start_method="spawn")
        with open(os.path.join(d, "rank0.json")) as f:
            return json.load(f)


def main(argv=None, state_dict=None) -> dict:
    """The efficiency table and each world's step losses.
    ``state_dict``: the model's initial parameters in every world, in
    place of the seeded draw (the JAX script's flax init through
    ``models.convert.vision_state_dict_from_flax``, say)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="resnet50",
                   choices=["resnet50", "inception", "vit", "mlp"])
    p.add_argument("--bs", type=int, default=None, help="batch per rank")
    p.add_argument("--img", type=int, default=None)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--batches", type=int, default=5)
    p.add_argument("--no-contention-baseline", action="store_true",
                   help="skip the communication-free C(n) arm")
    p.add_argument("--max-world", type=int, default=8,
                   help="largest gloo world on the CPU")
    p.add_argument("--smoke", action="store_true",
                   help="the MLP at batch 2, worlds of 1 and 2, one group "
                        "of 2 steps")
    p.add_argument("--device", default=None,
                   help="'cpu' for gloo worlds on this host; default the "
                        "card")
    args = p.parse_args(argv)
    args.state_dict = state_dict        # pickled to the spawned ranks
    if args.smoke:
        args.model, args.bs, args.iters, args.batches = "mlp", 2, 1, 2
        args.max_world = min(args.max_world, 2)

    basics.init(args.device)
    on_card = basics.device().type == "cuda"
    args.bs = args.bs or (32 if on_card else 2)
    if args.model == "inception":
        # Inception V3's stride-2 VALID reductions need H, W >= 75.
        args.img = args.img or (299 if on_card else 128)
    else:
        args.img = args.img or (224 if on_card else 32)
    sizes = [1] if on_card else [n for n in (1, 2, 4, 8, 16, 32, 64, 128)
                                 if n <= args.max_world]
    if on_card:
        print("one card: n = 1 only (a world of n ranks needs n cards; "
              "NCCL refuses two ranks on one GPU)", flush=True)

    results = {}
    for n in sizes:
        results[n] = _measure(args) if n == 1 else _world(n, args)
        line = f"n={n:4d}  {results[n]['rate']:10.2f} img/s/rank"
        if "contention" in results[n]:
            line += f"   C(n)={results[n]['contention']:12.1f}"
        print(line, flush=True)
    basics.shutdown()

    base = results[sizes[0]]
    table = {}
    for n, r in results.items():
        row = {"img_per_sec_per_rank": round(r["rate"], 2),
               "scaling_efficiency": round(r["rate"] / base["rate"], 4)}
        if "contention" in r:
            c_rel = r["contention"] / base["contention"]
            row["contention_factor"] = round(c_rel, 4)
            row["collective_efficiency"] = round(
                (r["rate"] / base["rate"]) / c_rel, 4)
        table[n] = row
    print(json.dumps({"model": args.model, "batch_per_rank": args.bs,
                      "scaling": table}), flush=True)
    return {"scaling": table,
            "losses": {n: r["losses"] for n, r in results.items()}}


if __name__ == "__main__":
    main()
