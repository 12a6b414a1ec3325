"""Serving recipes on the port: continuous batching and speculative decoding.

Twin of ``examples/llama_serving.py``: a fixed-slot ``ContinuousBatcher``
absorbing more mixed-length requests than it has slots, and
draft-and-verify ``speculative_generate`` with a smaller draft model,
whose greedy output equals the target's own.  It prints the JAX
example's lines.  The tiny model's weights and prompts come from seeds
(the port's own numbers, not JAX's).

    python -m horovod_tpu_torch.examples.llama_serving --requests 6 --device cpu

On the card, drop ``--device cpu``.  ``--tp N`` serves the requests through
a tensor-parallel ``ServeEngine`` instead: N processes (a gloo world on the
CPU; one process a card over NCCL on N GPUs), rank 0 leading and the
others following its commands, and checks its tokens against a tp = 1
engine's:

    python -m horovod_tpu_torch.examples.llama_serving --tp 2 --device cpu
"""

from __future__ import annotations

import argparse
import os
import socket
import time

import numpy as np
import torch

from horovod_tpu_torch import resolve_device
from horovod_tpu_torch.models import llama
from horovod_tpu_torch.serving import (ContinuousBatcher, Request,
                                       speculative_generate)


def _requests(cfg, args) -> list[Request]:
    rng = np.random.default_rng(1)
    return [Request(prompt=rng.integers(0, cfg.vocab_size,
                                        2 + int(rng.integers(0, 5))).tolist(),
                    max_new_tokens=args.new_tokens)
            for _ in range(args.requests)]


def _tp_rank(rank: int, args, port: int) -> None:
    """One rank of ``--tp``: rank 0 leads the engine, the others follow."""
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.serving_scheduler import ServeEngine

    os.environ.update(
        HOROVOD_TPU_PROCESS_ID=str(rank),
        HOROVOD_TPU_NUM_PROCESSES=str(args.tp),
        HOROVOD_TPU_COORDINATOR=f"127.0.0.1:{port}",
        HOROVOD_TPU_LOCAL_RANK=str(rank), HOROVOD_TPU_LOCAL_SIZE=str(args.tp))
    basics.init(args.device)
    try:
        cfg = llama.llama_tiny(dtype=torch.float32)
        params = llama.init_params(cfg, 0, device=basics.device())
        reqs = _requests(cfg, args)
        kw = dict(n_slots=args.slots, max_len=32, chunk=8, sampler=False)
        eng = ServeEngine(params, cfg, tp_size=args.tp, **kw)
        if not eng.is_leader:
            eng.follow()
            return
        t0 = time.monotonic()
        out = [[int(t) for t in r] for r in eng.run(reqs)]
        dt = time.monotonic() - t0
        eng.close()
        plain = ServeEngine(params, cfg, tp_size=1, **kw)
        same = out == [[int(t) for t in r] for r in plain.run(reqs)]
        print(f"tp engine: {args.tp} ranks, {len(out)} requests, "
              f"{sum(map(len, out))} tokens in {dt:.2f}s")
        print(f"tp engine == tp=1 engine: {same}", flush=True)
        if not same:
            raise SystemExit("the tensor-parallel engine disagreed")
    finally:
        basics.shutdown()


def _serve_tp(args) -> None:
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.start_processes(_tp_rank, args=(args, port), nprocs=args.tp,
                       start_method="spawn")


def main(argv=None) -> bool:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--draft-k", type=int, default=3)
    ap.add_argument("--tp", type=int, default=1,
                    help="serve through a tensor-parallel engine over this "
                         "many processes (ranks)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; default: the GPU")
    args = ap.parse_args(argv)

    if args.tp > 1:
        _serve_tp(args)
        return True
    dev = resolve_device(args.device)
    cfg = llama.llama_tiny(dtype=torch.float32)
    params = llama.init_params(cfg, 0, device=dev)

    # -- continuous batching: more requests than slots, mixed lengths ----
    reqs = _requests(cfg, args)
    srv = ContinuousBatcher(params, cfg, n_slots=args.slots, max_len=32,
                            admit_width=8)
    t0 = time.monotonic()
    results = srv.run(reqs)
    dt = time.monotonic() - t0
    total = sum(len(r) for r in results)
    print(f"batcher: {len(results)} requests through {args.slots} slots, "
          f"{total} tokens in {dt:.2f}s")

    # -- speculative decoding: draft = a smaller model -------------------
    dcfg = llama.llama_tiny(dtype=torch.float32, dim=32, n_layers=1,
                            n_heads=2, n_kv_heads=1, ffn_dim=64)
    dparams = llama.init_params(dcfg, 2, device=dev)
    prompt = torch.tensor([reqs[0].prompt], device=dev)
    plain = llama.generate(params, prompt, cfg,
                           max_new_tokens=args.new_tokens, max_len=32)
    spec = speculative_generate(params, cfg, dparams, dcfg, prompt,
                                max_new_tokens=args.new_tokens,
                                draft_k=args.draft_k, max_len=40)
    same = bool(torch.equal(spec, plain))
    print(f"speculative == plain greedy: {same}")
    if not same:
        raise SystemExit("speculative decoding disagreed with greedy")
    return same


if __name__ == "__main__":
    main()
