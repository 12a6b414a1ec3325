"""Llama autoregressive generation on the port: the inference path end to end.

Twin of ``examples/llama_generate.py``: one prefill
(:func:`~horovod_tpu_torch.models.llama.prefill`), then a loop of cached
decode steps (``decode_step``) through ``llama.generate``, greedy or
sampled (temperature, top-k, nucleus).  The prompt is the JAX script's,
``numpy.random.default_rng(0)`` integers of ``[batch, prompt_len]``; the
weights are random from seed 0 (the port's own numbers) unless ``--ckpt``
names a checkpoint written by :func:`horovod_tpu_torch.save_checkpoint`.
As there, one call warms up and a second is timed; the tokens printed and
returned are the second call's.

    python -m horovod_tpu_torch.examples.llama_generate --tiny --max-new-tokens 16 --device cpu

On the card drop ``--device cpu``: without ``--tiny`` that is Llama-3-8B
(32 layers, bf16 weights), dense attention as in the JAX script.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from horovod_tpu_torch import resolve_device
from horovod_tpu_torch.models import llama


def run(params: dict, cfg, *, batch: int = 2, prompt_len: int = 8,
        max_new_tokens: int = 32, temperature: float = 0.0,
        top_k: int | None = None, top_p: float | None = None,
        verbose: bool = True) -> dict:
    """Generate from the JAX script's prompt with ``params``: a warm-up
    call (sampling seed 1), then the timed one (seed 2).  Returns the
    prompt, the timed call's tokens ``[batch, max_new_tokens]``, its
    seconds and tokens/s (``batch · max_new_tokens`` over the whole call,
    prefill included, as the JAX script counts)."""
    dev = params["embed"].device
    prompt = torch.as_tensor(    # the JAX script's prompt
        np.random.default_rng(0).integers(0, cfg.vocab_size,
                                          (batch, prompt_len)),
        dtype=torch.int64, device=dev)

    def gen(seed: int) -> torch.Tensor:
        with torch.no_grad():
            return llama.generate(
                params, prompt, cfg, max_new_tokens=max_new_tokens,
                temperature=temperature, top_k=top_k, top_p=top_p,
                key=torch.Generator(device=dev).manual_seed(seed))

    def wait() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    gen(1)                                  # warm-up, as the JAX compile
    wait()
    t0 = time.perf_counter()
    toks = gen(2)
    wait()
    dt = time.perf_counter() - t0
    rate = batch * max_new_tokens / dt
    if verbose:
        print(f"params: {llama.num_params(cfg) / 1e6:.1f}M  "
              f"decode: {rate:.1f} tok/s "
              f"(temperature={temperature} top_k={top_k} top_p={top_p})",
              flush=True)
        print("tokens[0]:", toks[0].tolist(), flush=True)
    return {"prompt": prompt, "tokens": toks, "seconds": dt,
            "tokens_per_s": rate}


def main(argv=None) -> torch.Tensor:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tiny", action="store_true", help="toy widths")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--prompt-len", type=int, default=8)
    p.add_argument("--max-new-tokens", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy")
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--top-p", type=float, default=None)
    p.add_argument("--ckpt", default=None,
                   help="checkpoint file (default: random init)")
    p.add_argument("--device", default=None,
                   help="'cpu' to run on the CPU; default: the GPU")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    if args.tiny:
        cfg = llama.llama_tiny()
    else:
        # bf16 weights: the f32 masters of 8B (32 GB) serve no purpose here
        cfg = llama.llama3_8b(param_dtype=torch.bfloat16)
    params = llama.init_params(cfg, 0, device=dev)
    if args.ckpt:
        from horovod_tpu_torch import basics
        from horovod_tpu_torch.checkpoint import restore_checkpoint

        basics.init(args.device)
        params = restore_checkpoint(args.ckpt, params)
    out = run(params, cfg, batch=args.batch, prompt_len=args.prompt_len,
              max_new_tokens=args.max_new_tokens,
              temperature=args.temperature, top_k=args.top_k,
              top_p=args.top_p)
    return out["tokens"]


if __name__ == "__main__":
    main()
