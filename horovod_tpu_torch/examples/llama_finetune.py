"""Llama-3 data-parallel training on the port: one process per GPU.

Twin of ``examples/llama_finetune.py``: ``init`` → ``broadcast_parameters``
→ ``DistributedOptimizer(AdamW(lr, betas=(0.9, 0.95), weight_decay=0.1))``
with global-norm clipping at 1.0 after the gradient allreduce →
``make_train_step(loss_fn)`` → steps on random tokens.  ``--zero`` takes
``make_zero_train_step`` (AdamW over the rank's 1/n shard, the clip from
the shards' norms), ``--fsdp`` ``make_fsdp_train_step`` over
``shard_params`` (the clip from the shards' norms too).  Remat follows the config (on for Llama-3-8B,
off for the tiny model), as in the JAX package.

    python -m horovod_tpu_torch.examples.llama_finetune --tiny --steps 2 --device cpu

On the card (one process per GPU; ``torchrun`` or the JAX package's launcher
sets rank and world, else a world of one):

    python -m horovod_tpu_torch.examples.llama_finetune --attn flash --n-layers 8 --steps 4

Two gloo ranks on the CPU: ``HOROVOD_TPU_PROCESS_ID``/``_NUM_PROCESSES``/
``_COORDINATOR`` per process, then ``--zero`` or ``--fsdp``.

The sequence-parallel engines (``--attn ring``, ``ulysses``,
``ulysses_flash``) are refused: they need each rank to hold a slice of the
sequence and ``forward``'s ``sp_group``, and this example builds no such
group (the reference's example passes no ``sp_axis`` and fails at its
first step).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from horovod_tpu_torch import basics
from horovod_tpu_torch.models import llama
from horovod_tpu_torch.optim.distributed_optimizer import (
    DistributedOptimizer,
    broadcast_parameters,
    make_train_step,
    tree_leaves,
)
from horovod_tpu_torch.optim.fsdp import (fsdp_partition_specs,
                                          make_fsdp_train_step, shard_params)
from horovod_tpu_torch.optim.zero import make_zero_train_step

_SEQUENCE_PARALLEL = ("ring", "ulysses", "ulysses_flash")


def main(argv=None) -> list[float]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tiny", action="store_true", help="toy widths")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--max-steps", type=int, default=None,
                   help="stop after this many steps whatever --steps says")
    p.add_argument("--batch-per-chip", type=int, default=1)
    p.add_argument("--seq-len", type=int, default=0,
                   help="0 = model max_seq_len")
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--attn", default="dense",
                   choices=["dense", "blockwise", "ring", "ulysses",
                            "ulysses_flash", "flash"])
    p.add_argument("--zero", action="store_true",
                   help="ZeRO sharded optimizer (state at 1/n per rank)")
    p.add_argument("--fsdp", action="store_true",
                   help="fully-sharded params AND optimizer state (1/n per "
                        "rank between steps)")
    p.add_argument("--fused-loss", action="store_true",
                   help="chunked fused linear+cross-entropy (no [B*L, V] "
                        "logits)")
    p.add_argument("--device", default=None,
                   help="'cpu' for the gloo CPU world; default: the GPU")
    p.add_argument("--n-layers", type=int, default=None,
                   help="model depth (default: the config's); widths never "
                        "change")
    args = p.parse_args(argv)
    if args.zero and args.fsdp:
        p.error("--zero and --fsdp are alternative sharding strategies")
    if args.attn in _SEQUENCE_PARALLEL:
        raise NotImplementedError(
            f"--attn {args.attn} is sequence-parallel: each rank would hold "
            f"a slice of the sequence and pass forward an sp_group, and this "
            f"example builds no sequence-parallel group")

    basics.init(args.device)
    dev = basics.device()
    n, rank = basics.size(), basics.rank()
    overrides = dict(attn_impl=args.attn, fused_loss_chunk=(
        (64 if args.tiny else 8192) if args.fused_loss else None))
    if args.n_layers is not None:
        overrides["n_layers"] = args.n_layers
    cfg = (llama.llama_tiny if args.tiny else llama.llama3_8b)(**overrides)
    seq = args.seq_len or min(cfg.max_seq_len, 512 if args.tiny else 4096)

    params = llama.init_params(cfg, 0, device=dev)
    params = broadcast_parameters(params, root_rank=0)
    loss_fn = llama.make_loss_fn(cfg)

    def adamw(leaves):
        return torch.optim.AdamW(leaves, lr=args.lr, betas=(0.9, 0.95),
                                 weight_decay=0.1, fused=dev.type == "cuda")

    if args.fsdp:
        # Params and AdamW moments at 1/n a rank between steps.
        step, init_opt = make_fsdp_train_step(loss_fn, adamw,
                                              clip_global_norm=1.0)
        params = shard_params(params, fsdp_partition_specs(params))
        opt_state = init_opt(params)
    elif args.zero:
        # AdamW's moments at 1/n a rank; the clip from the shards' norms.
        step, init_opt = make_zero_train_step(loss_fn, adamw,
                                              clip_global_norm=1.0)
        for t in tree_leaves(params):
            t.requires_grad_()
        opt_state = init_opt(params)
    else:
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_()
        replicated = make_train_step(
            loss_fn, DistributedOptimizer(adamw(leaves)), max_grad_norm=1.0)
        opt_state = None

        def step(params, opt_state, batch):
            return replicated(params, batch)

    if rank == 0:
        print(f"params: {llama.num_params(cfg) / 1e6:.1f}M  gpus: {n}  "
              f"seq: {seq}  attn: {cfg.attn_impl}  device: {dev}")

    steps = args.steps if args.max_steps is None else min(args.steps,
                                                          args.max_steps)
    rng = np.random.default_rng(0)
    b = args.batch_per_chip
    losses = []
    for i in range(steps):
        # Rank-major like the JAX example's batch; each rank takes its rows.
        tokens = rng.integers(0, cfg.vocab_size, size=(b * n, seq + 1))
        mine = torch.as_tensor(tokens[rank * b:(rank + 1) * b], device=dev)
        out = step(params, opt_state, (mine[:, :-1], mine[:, 1:]))
        losses.append(float(out.loss))
        if i % 10 == 0 and rank == 0:
            print(f"step {i}: loss {losses[-1]:.4f}")
    basics.shutdown()
    return losses


if __name__ == "__main__":
    main()
