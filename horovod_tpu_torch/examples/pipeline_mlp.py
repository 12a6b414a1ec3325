"""Pipeline-parallel training on the port: one process a stage.

Twin of ``examples/pipeline_mlp.py``: a residual MLP block per stage,
microbatches streaming through one ``ppermute`` hop a tick, the fill,
steady state and drain of ``M + S - 1`` ticks, and the backward through
the hops' reverse.  Each rank builds the same four stages from the seed
and keeps its own (``stack_stage_params`` row ``rank``); the loss is
masked to the last stage and replicated without double-counting its
gradient (``pipeline_loss_fn``); Adam updates each stage where it lives.

    # four gloo processes, one a stage (the JAX package's launcher
    # variables, or torchrun's)
    HOROVOD_TPU_PROCESS_ID=r HOROVOD_TPU_NUM_PROCESSES=4 \\
        HOROVOD_TPU_COORDINATOR=127.0.0.1:<port> \\
        python -m horovod_tpu_torch.examples.pipeline_mlp --device cpu

The loss goes DOWN while every parameter lives on exactly one stage.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from horovod_tpu_torch import basics
from horovod_tpu_torch.parallel.pipeline import (pipeline_loss_fn,
                                                 stack_stage_params)


def stage_fn(params, h):
    """One residual MLP block (one width, so activations keep one shape
    across stages: the pipeline's contract)."""
    return h + torch.tanh(h @ params["w"] + params["b"])


def main(argv=None) -> list[float]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--microbatches", type=int, default=8)
    p.add_argument("--microbatch-size", type=int, default=8)
    p.add_argument("--width", type=int, default=32)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--device", default=None,
                   help="'cpu' for the gloo CPU world; default: the GPU")
    args = p.parse_args(argv)

    basics.init(args.device)
    dev = basics.device()
    stages, rank = basics.size(), basics.rank()
    d = args.width
    rng = np.random.default_rng(0)
    stacked = stack_stage_params([
        {"w": torch.as_tensor(rng.normal(0, 0.3, (d, d)), dtype=torch.float32),
         "b": torch.zeros(d)} for _ in range(stages)])
    mine = {k: v[rank].clone().to(dev).requires_grad_()
            for k, v in stacked.items()}

    def loss_fn(y, target):
        return ((y - target) ** 2).mean()

    pipe_loss = pipeline_loss_fn(stage_fn, loss_fn)
    opt = torch.optim.Adam(list(mine.values()), lr=args.lr)

    # Synthetic regression task: match a fixed random linear map.
    m, mb = args.microbatches, args.microbatch_size
    x = torch.as_tensor(rng.normal(0, 1, (m, mb, d)), dtype=torch.float32)
    w_true = torch.as_tensor(rng.normal(0, 0.5, (d, d)), dtype=torch.float32)
    batch = (x.to(dev), torch.tanh(x @ w_true).to(dev))

    losses = []
    for i in range(args.steps):
        loss = pipe_loss(mine, batch)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        losses.append(float(loss))
        if (i % 10 == 0 or i == args.steps - 1) and rank == 0:
            print(f"step {i}: loss {losses[-1]:.5f}", flush=True)
    if rank == 0:
        print(f"loss {losses[0]:.5f} -> {losses[-1]:.5f} over {stages} "
              f"stages", flush=True)
    basics.shutdown()
    if losses[-1] >= losses[0]:
        raise RuntimeError("pipeline training did not reduce the loss")
    return losses


if __name__ == "__main__":
    main()
