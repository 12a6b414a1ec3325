#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``horovod_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--n-layers N] [--train-layers N] [--seed S]
                          [--vit-ab {fwd,bwd}]

Phases, one JSON line each; any failure exits non-zero before the result:

1. ``device``: requires CUDA; prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them.
2. ``build``: compiles every kernel under ``horovod_tpu_torch/csrc`` with
   ``nvcc`` for ``sm_90a`` (one process per source, all at once) into
   ``build/horovod_tpu_torch/``.
3. ``kernel flash_fwd``: the hand-written flash-attention forward (the
   Hopper kernel for bf16/f16, the ``mma.sync`` kernel for f32) against its
   plain PyTorch version on the same inputs at the kernel's own tile sizes,
   at Llama-3-8B attention shapes (generate's prefill and the training
   shape among them).  Timed cases report the kernel's device time (from
   ``torch.profiler``), its CUDA-event loop time and the wrapper's host
   time per call; ``prev_ms`` and ``prev_host_us_per_call``, the earlier
   ``mma.sync`` kernel on the same bf16 inputs through the same wrapper; the
   plain version's time; and PyTorch's
   ``scaled_dot_product_attention`` (only a yardstick: the port never
   makes it).
4. ``kernel flash_bwd``: the dQ and dK/dV kernels (the Hopper kernels for
   bf16/f16, the ``mma.sync`` kernels for f32) against their plain versions
   on the same inputs (O and LSE from the forward kernel, a random dO),
   with tails around the 64-row tiles; at the training shape each kernel's
   device time, loop time and host time per call, ``prev_ms`` (the
   ``mma.sync`` kernel on the same inputs), its bound, and SDPA's backward
   in device time as the pair's yardstick.
5. ``serve generate``: Llama-3-8B at full width (random weights from the
   seed), greedy ``generate`` over four ragged prompts; the flash kernel
   must launch once per layer of the prefill, and the prefill's logits
   must agree with ``attn_impl="dense"``.
6. ``serve batcher``: a 512-token shared prefix (``precompute_prefix``,
   through the kernel) and a ``ContinuousBatcher`` answering eight
   requests; first tokens are held against solo ``generate``.
7. ``train``: Llama-3-8B width cut to ``--train-layers`` (default 8), remat,
   flash attention, f32 master weights and bf16 compute, through the port's
   ``basics.init`` (NCCL, a world of one), ``broadcast_parameters``,
   ``DistributedOptimizer(AdamW)`` with clipping at 1.0 after the
   gradient allreduce, and ``make_train_step``: four timed steps on one
   repeated batch of 4096 tokens, then a fifth under ``torch.profiler``
   (device time by kind of kernel, the device's idle share; taken again,
   at most twice, when the profiler dropped the backward kernels).  Each step
   must launch the forward kernel twice per layer (forward and remat
   recompute) and each backward kernel once, and the profile must show
   the Hopper backward kernels; the loss must fall; step 0's
   gradients must agree with the blockwise recompute and the fused loss
   with the plain one.

8. ``kernel d64`` (run right after ``kernel flash_bwd``): the three
   kernels at head dim 64, the ViT's (the Hopper D = 64 kernels for
   bf16/f16, the ``mma.sync`` kernels for f32): the ViT-B/16 shape (B=64,
   L=196, 12 heads, non-causal) in bf16, f16 and f32, a causal case and
   tails, each held against its plain version; at the ViT shape the times,
   bounds, ``prev_ms`` and SDPA.
9. ``train resnet101`` (``bench.py _bench_resnet``): ResNet-101 at full
   depth, batch 64 at 224 × 224 from ``synthetic_imagenet``, bf16 compute
   with f32 parameters and BN, ``SGD(0.01, momentum=0.9)`` through
   ``basics.init``, ``broadcast_parameters``, ``broadcast_optimizer_state``,
   ``DistributedOptimizer`` and ``make_train_step``: two warm-up steps,
   eight timed, one profiled; images/s and the model-FLOP share (FLOP from
   ``torch.utils.flop_counter``); losses finite and falling, BN running
   statistics moved.
10. ``train vit_b16`` (``bench.py _bench_vit`` with the flash kernels):
    ViT-B/16, bf16, ``attn_impl="flash"``, batch 64 at 224,
    ``AdamW(1e-3, weight_decay=1e-4)``, the same wrapper; each step must
    launch the forward, dQ and dK/dV kernels 12 times and the profiled
    step must show exactly the Hopper D = 64 kernels; step 0's logits and
    gradients are held against dense attention and the blockwise backward.
    With ``--vit-ab fwd`` (``--vit-ab bwd``), an A/B in the same process:
    the timed steps again with the forward (the backward) on the
    ``mma.sync`` kernels and on the Hopper kernels, in turns (images/s, the
    profiled idle share and the route's kernels' ms of each).
11. ``train vgg16`` (BASELINE config 4, with its fusion buckets and
    allreduce bytes per step) and ``train inception_v3`` (299 × 299): batch
    64, one warm-up and two timed steps each.
12. ``train compressed`` (the synthetic benchmark twin's model): ResNet-50
    at full width, batch 32 at 224, bf16 compute with f32 parameters,
    ``SGD(0.01, momentum=0.9)``, NCCL with a world of one, through each
    reduction route in turn from the same weights: ``none``, ``int8`` and
    ``int4`` (``allreduce``'s dispatch in the fusion buckets),
    ``powersgd`` and ``ef-topk`` (stateful), ``is_sparse`` (top-k 1 %) and
    ``adasum``.  A warm-up step, a checked step (the gradients copied to
    the host before the reduction, the reduction held against the same
    functions on that copy: codes and ``roundtrip`` bit for bit, top-k
    selections, PowerSGD's approximation + residual = M and P̂
    orthonormal, the input itself at a world of one), four timed steps
    (images/s) and one whose reduction runs under ``torch.profiler``
    (device ms, launches, wall ms).  Losses finite and falling on every
    route; the ``powersgd`` route's (model, optimizer) checkpoint restores
    bit for bit, PowerSGD's state included.
13. ``fit mnist`` (BASELINE config 1): ``MnistConvNet`` through ``fit``,
    ``ShardedLoader`` over ``synthetic_mnist`` and the broadcast,
    metric-average, warm-up and checkpoint callbacks, two epochs; the loss
    must fall, a checkpoint lands per epoch under ``$TMPDIR``,
    ``latest_checkpoint`` finds the last, ``restore_checkpoint`` into fresh
    objects equals the trained state bit for bit, and ``load_model``
    returns a ``DistributedOptimizer`` around the optimizer it was given,
    which holds the trained momentum bit for bit.

The training phases share one process group, shut down after the last.
Then a ``{"kernels": [...]}`` line (each kernel at head dims 128 and 64)
and, last, the result line ``{"ok": true, "device": {...}}``.  A failed
phase prints its JSON line with ``"ok": false`` and its traceback on
standard error, and the run exits 1.
``--n-layers`` and ``--train-layers`` cut depth, never width; the vision
paths run at full depth.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
DEV = "cuda"

# H100 SXM dense peaks (NVIDIA data sheet), for the roofline bound.
PEAK_FLOPS = {"bf16": 989e12, "f16": 989e12, "f32": 67e12}
PEAK_BYTES = 3.35e12

# Tolerances of the kernel against its plain version, compared at the
# kernel's own tiles (128 × 128 for the D = 128 Hopper kernel, 64 × 64 for
# the D = 64 one and for f32), so
# both round P to the storage dtype at the same running max.  P still
# differs by a few f32 units in the last place (the kernel takes exp2 with
# log2(e)·scale folded in, the reference exp of the scaled score, and the
# products sum in another order), which moves P's rounding only at a tie;
# both round o once.  So o may differ by about two units in the last place
# of the storage dtype relative to |o|, plus the f32 summation order.  The
# LSE is f32 from exact products.
O_TOL = {"bf16": (1e-2, 2 ** -7), "f16": (2e-3, 2 ** -9), "f32": (1e-4, 1e-5)}
LSE_TOL = 1e-3

# Random-weight Llama-3-8B: prefill logits with the flash kernel against
# dense attention, relative to the largest |logit|.  Each of the 32 layers
# rounds its attention output to bf16 in both; the flash path also rounds
# P, and the difference grows through the residual stream.
LOGIT_RTOL = 5e-2
# A first token is held to solo generate's only where solo's top-2 logit
# margin exceeds this share of the largest |logit| (bf16 ties are not
# claimed across batch shapes).
MARGIN_RTOL = 5e-2


# Llama-3-8B attention heads (H, KVH, D) of every kernel case.
ATTN_HEADS = (32, 8, 128)
# The training shape: those heads over one causal sequence of 4096 tokens,
# bf16.
TRAIN_SHAPE = ("causal_b1_l4096", 1, 4096, True)
TRAIN_TOKENS = 4096

# Train phase, step 0's gradients with the backward kernels against the
# blockwise recompute (bwd="blockwise") on the same weights and batch.  The
# forward is the same kernel in both; the backward differs by the kernels'
# bf16 roundings of P and dS (unbiased, 2**-8 relative per element, summed
# over 4096 keys or queries), which then flow through the earlier layers'
# backward: held as relative Frobenius distances.
GRAD_NORM_RTOL = 2e-2       # |‖g_kernel‖ − ‖g_blockwise‖| / ‖g_blockwise‖
GRAD_LEAF_RTOL = 5e-2       # ‖g_kernel − g_blockwise‖ / ‖g_blockwise‖, per leaf
# The fused loss (f32 logits, chunks of 8192 columns) against the plain loss
# (logits rounded to bf16 by the lm_head product): each logit differs by at
# most one bf16 rounding (2**-9 relative), unbiased, averaged over 4096
# tokens.  Relative to the loss.
FUSED_LOSS_RTOL = 1e-3
PEAK_BF16 = PEAK_FLOPS["bf16"]


class PhaseError(RuntimeError):
    pass


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def sync() -> None:
    import torch

    torch.cuda.synchronize()


def device_ms(fn, n: int = 20, tries: int = 3) -> tuple[float, list[str]]:
    """Device time per call of ``fn`` from ``torch.profiler`` over ``n``
    calls: for each kernel name, the median of its own device intervals
    times how many it launches per call, summed; and the kernels' names.
    The profiler drops events now and then (seen on the card): a session
    where some kernel's count is not a whole multiple of ``n`` is tried
    again, and if every session lost some, the last one whose time is not 0
    stands (the median keeps each kernel's time right)."""
    import torch
    from torch.autograd import DeviceType

    fn()
    sync()
    partial = None
    for _ in range(tries):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            sync()
        by_name: dict[str, list[float]] = {}
        for e in prof.events():
            if (e.device_type == DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)):
                by_name.setdefault(e.name, []).append(e.device_time_total)
        us = sum(statistics.median(d) * round(len(d) / n)
                 for d in by_name.values())
        if us <= 0:
            continue
        partial = us / 1e3, sorted(name[:80] for name in by_name)
        if all(len(d) % n == 0 for d in by_name.values()):
            return partial
    if partial is not None:
        return partial
    raise PhaseError("torch.profiler recorded no device time")


def host_us(fn, n: int = 50) -> float:
    """Host time per call of ``fn`` (its checks, allocations and launch),
    the device left to run behind it."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    seconds = time.perf_counter() - t0
    sync()
    return seconds / n * 1e6


def time_ms(fn, *, reps: int = 7, inner: int = 5, warmup: int = 2) -> float:
    """Median over ``reps`` of the mean time of ``inner`` calls, from CUDA
    events around each batch."""
    import torch

    for _ in range(warmup):
        fn()
    sync()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


# -- phases ----------------------------------------------------------------


def phase_device() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise PhaseError("CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if smi.returncode != 0 or not line:
        raise PhaseError(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(line, flush=True)
    info = {"name": torch.cuda.get_device_name(0), "nvidia_smi": line,
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda}
    emit("device", ok=True, **info)
    return info


def phase_build() -> None:
    from horovod_tpu_torch import _build

    t0 = time.perf_counter()
    _build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = [ln.strip() for log in _build.build_logs.values()
             for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "entry function" in ln
             or _ptxas_warning(ln)]
    emit("build", ok=True, seconds=seconds, sources=_build.sources(),
         ptxas=ptxas)
    return {"seconds": seconds, "kernels": _ptxas_kernels(ptxas)}


def _ptxas_warning(line: str) -> bool:
    """A warning of ptxas's report, or one of its notes on wgmma (C7512,
    C7519, C7520: an injected fence or serialized wgmma), which it prints
    as ``info``."""
    return "warning" in line or "(C75" in line


def _ptxas_kernels(lines) -> dict:
    """``{mangled kernel name: {"registers": n, "spill_bytes": n,
    "warnings": [...]}}`` (spill stores; ptxas's warnings and wgmma notes
    that name the kernel) from ``nvcc -Xptxas -v``'s report."""
    out: dict[str, dict] = {}
    name = None
    for ln in lines:
        if _ptxas_warning(ln):
            continue
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            out[name] = {}
        elif name and (spill := re.search(r"(\d+) bytes spill stores", ln)):
            out[name]["spill_bytes"] = int(spill.group(1))
        elif name and (used := re.search(r"Used (\d+) registers", ln)):
            out[name]["registers"] = int(used.group(1))
    for name, v in out.items():
        v["warnings"] = [ln for ln in lines
                         if _ptxas_warning(ln) and name in ln]
    return out


def _flash_flops(b, h, l, d, causal) -> int:
    pairs = l * (l + 1) // 2 if causal else l * l
    return 4 * b * h * d * pairs                  # Q·Kᵀ and P·V


def _flash_bound(b, h, kvh, l, d, causal, elem, tname):
    flops = _flash_flops(b, h, l, d, causal)
    nbytes = (2 * b * h + 2 * b * kvh) * l * d * elem + b * h * l * 4
    t_ops = flops / PEAK_FLOPS[tname]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_kernel(seed: int) -> dict:
    import torch

    from horovod_tpu_torch.parallel import flash_attention as fa

    H, KVH, D = ATTN_HEADS
    names = {torch.bfloat16: "bf16", torch.float16: "f16",
             torch.float32: "f32"}
    cases = [  # (name, B, L, causal, dtype); the first is generate's prefill
        ("causal_b4_l1024", 4, 1024, True, torch.bfloat16),
        (*TRAIN_SHAPE, torch.bfloat16),   # the train phase's forward and remat
        ("causal_b1_l512", 1, 512, True, torch.bfloat16),
        ("causal_b1_l1000", 1, 1000, True, torch.bfloat16),
        ("noncausal_b1_l512", 1, 512, False, torch.bfloat16),
        ("causal_b1_l333_f16", 1, 333, True, torch.float16),
        ("causal_b1_l200_f32", 1, 200, True, torch.float32),
    ]
    gen = torch.Generator(device=DEV).manual_seed(seed)
    results = []
    for name, b, l, causal, dtype in cases:
        tname = names[dtype]
        q = torch.randn((b * H, l, D), generator=gen, device=DEV).to(dtype)
        k = torch.randn((b * KVH, l, D), generator=gen, device=DEV).to(dtype)
        v = torch.randn((b * KVH, l, D), generator=gen, device=DEV).to(dtype)
        blk = 64 if dtype == torch.float32 else 128   # the kernel's tiles
        o, lse = fa._flash_forward_cuda(q, k, v, n_heads=H, n_kv_heads=KVH,
                                        causal=causal)
        sync()
        o_ref, lse_ref = fa._flash_forward_reference(
            q, k, v, n_heads=H, n_kv_heads=KVH, causal=causal,
            block_q=blk, block_k=blk)
        diff = (o.float() - o_ref.float()).abs()
        atol, rtol = O_TOL[tname]
        o_excess = float((diff - rtol * o_ref.float().abs()).max())
        o_err = float(diff.max())
        lse_err = float((lse - lse_ref).abs().max())
        finite = bool(torch.isfinite(o.float()).all() and torch.isfinite(lse).all())
        ok = finite and o_excess <= atol and lse_err <= LSE_TOL
        row = {"case": name, "dtype": tname, "B": b, "L": l, "H": H,
               "KVH": KVH, "D": D, "causal": causal,
               "entry": fa._FWD_ENTRY[dtype, D], "ref_block": blk,
               "o_max_abs_err": o_err, "o_tol": f"{atol} + {rtol}*|o|",
               "o_excess_over_tol": o_excess, "lse_max_abs_err": lse_err,
               "lse_tol": LSE_TOL, "ok": ok}
        if ok and (b > 1 or l >= 512):
            row.update(_time_forward(q, k, v, b, l, causal, blk, tname))
        results.append(row)
        emit("kernel flash_fwd", **row)
        del q, k, v, o, lse, o_ref, lse_ref
        if not ok:
            raise PhaseError(f"flash_fwd disagrees with its reference on {name}")
    return {"cases": results}


def _time_forward(q, k, v, b, l, causal, blk, tname,
                  heads=ATTN_HEADS) -> dict:
    """Times of one forward case: the kernel through its wrapper (device
    time, CUDA-event loop time, host time per call), the earlier mma.sync
    kernel on the same inputs through the same wrapper (``prev``, where the
    wrapper takes another kernel: the route switched with ``_mma_route``,
    the host times in turns), the plain version and SDPA."""
    import torch.nn.functional as F

    from horovod_tpu_torch.parallel import flash_attention as fa

    H, KVH, D = heads
    kw = dict(n_heads=H, n_kv_heads=KVH, causal=causal)

    def kernel():
        fa._flash_forward_cuda(q, k, v, **kw)

    rows = fa._kv_rows(b * H, H, KVH, DEV)
    q4 = q.view(b, H, l, D)
    k4 = k[rows].view(b, H, l, D)
    v4 = v[rows].view(b, H, l, D)

    def sdpa():
        F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)

    out = {}
    out["ms"], out["kernel_names"] = device_ms(kernel)
    out["wall_ms"] = time_ms(kernel)
    if fa._FWD_ENTRY[q.dtype, D] != fa._MMA_FWD:
        with _mma_route(fa._FWD_ENTRY, q.dtype, D):
            out["prev_ms"], out["prev_names"] = device_ms(kernel)
            out["prev_wall_ms"] = time_ms(kernel)
        out["host_us_per_call"], out["prev_host_us_per_call"] = _host_us_ab(
            kernel, fa._FWD_ENTRY, q.dtype, D)
    else:
        out["host_us_per_call"] = host_us(kernel)
    out["library_ms"], out["library_names"] = device_ms(sdpa)
    out["library_wall_ms"] = time_ms(sdpa)
    out["plain_ms"] = time_ms(lambda: fa._flash_forward_reference(
        q, k, v, block_q=blk, block_k=blk, **kw), reps=3, inner=1, warmup=1)
    out["bound_ms"], out["bound_by"] = _flash_bound(
        b, H, KVH, l, D, causal, q.element_size(), tname)
    out["tflops"] = _flash_flops(b, H, l, D, causal) / out["ms"] / 1e9
    out["share_of_bound"] = out["bound_ms"] / out["ms"]
    if "prev_ms" in out:
        out["speedup_vs_prev"] = out["prev_ms"] / out["ms"]
    return out


# Tolerances of the backward kernels against their plain versions, relative
# to the largest |grad| of each tensor.  Both round P and dS to the storage
# dtype (three roundings: dS before dS·K, P before Pᵀ·dO, dS before dSᵀ·Q)
# from f32 values that differ only in summation order (64-wide tiles on the
# tensor cores against 512-wide cuBLAS blocks), and both round dQ and the
# per-head dK/dV to the storage dtype once: so a gradient may differ by a
# few units in the last place of the storage dtype relative to the largest
# |grad|, the three roundings compounding over L keys or queries.
BWD_RTOL = {"bf16": 2 ** -6, "f16": 2 ** -8, "f32": 1e-4}
# Plus an absolute floor for gradients that cancel to f32 noise: where a
# query sees one key (L = 1) softmax is constant, so dQ and dK are 0 and
# dS = P∘(dP − Δ) holds only the rounding of dP and Δ in f32 (~1e-6).
BWD_ATOL = 1e-4


def _bwd_flops(b, h, l, d, causal, products) -> int:
    pairs = l * (l + 1) // 2 if causal else l * l
    return products * 2 * b * h * d * pairs


def _bwd_bound(b, h, kvh, l, d, causal, elem, tname, products, outputs):
    """Least time for one backward kernel: ``products`` matrix products
    over the (causal) score matrix, against reading q, dO, k, v, LSE and Δ
    once and writing ``outputs`` [B·H, L, D] tensors once."""
    flops = _bwd_flops(b, h, l, d, causal, products)
    nbytes = ((2 + outputs) * b * h + 2 * b * kvh) * l * d * elem \
        + 2 * b * h * l * 4
    t_ops = flops / PEAK_FLOPS[tname]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_kernel_bwd(seed: int) -> dict:
    import torch

    from horovod_tpu_torch.parallel import flash_attention as fa

    H, KVH, D = ATTN_HEADS
    names = {torch.bfloat16: "bf16", torch.float16: "f16",
             torch.float32: "f32"}
    # (name, B, L, causal, dtype); the first is the training shape.  The
    # others put L on both sides of the 64-row tiles (1, 63, 64, 65, 129,
    # 1000), with B = 2 where a ragged tail tile sits right before the next
    # head's rows in memory.
    cases = [
        (*TRAIN_SHAPE, torch.bfloat16),
        ("causal_b2_l1", 2, 1, True, torch.bfloat16),
        ("noncausal_b2_l63", 2, 63, False, torch.bfloat16),
        ("causal_b1_l64", 1, 64, True, torch.bfloat16),
        ("causal_b2_l65", 2, 65, True, torch.bfloat16),
        ("noncausal_b2_l129_f16", 2, 129, False, torch.float16),
        ("causal_b2_l1000", 2, 1000, True, torch.bfloat16),
        ("noncausal_b1_l1000", 1, 1000, False, torch.bfloat16),
        ("causal_b1_l333_f16", 1, 333, True, torch.float16),
        ("causal_b2_l200_f32", 2, 200, True, torch.float32),
        ("noncausal_b1_l65_f32", 1, 65, False, torch.float32),
    ]
    gen = torch.Generator(device=DEV).manual_seed(seed + 2)
    results = []
    for name, b, l, causal, dtype in cases:
        tname = names[dtype]
        q = torch.randn((b * H, l, D), generator=gen, device=DEV).to(dtype)
        k = torch.randn((b * KVH, l, D), generator=gen, device=DEV).to(dtype)
        v = torch.randn((b * KVH, l, D), generator=gen, device=DEV).to(dtype)
        do = torch.randn((b * H, l, D), generator=gen, device=DEV).to(dtype)
        o, lse = fa._flash_forward_cuda(q, k, v, n_heads=H, n_kv_heads=KVH,
                                        causal=causal)
        lse = lse.view(b * H, l)
        delta = fa._delta(o, do)
        kw = dict(n_heads=H, n_kv_heads=KVH, causal=causal)
        blk = dict(block_q=min(512, l), block_k=min(512, l))
        dq = fa._flash_bwd_dq_cuda(q, k, v, do, lse, delta, **kw)
        dk_h, dv_h = fa._flash_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw)
        sync()
        dq_ref = fa._flash_bwd_dq_reference(q, k, v, do, lse, delta, **kw,
                                            **blk)
        dk_ref, dv_ref = fa._flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                     **kw, **blk)
        rtol = BWD_RTOL[tname]
        row = {"case": name, "dtype": tname, "B": b, "L": l, "H": H,
               "KVH": KVH, "D": D, "causal": causal,
               "entries": list(fa._BWD_ENTRY[dtype, D]),
               "tol": f"{BWD_ATOL} + {rtol} * max|grad|", "ok": True}
        for gname, got, ref in (("dq", dq, dq_ref), ("dk", dk_h, dk_ref),
                                ("dv", dv_h, dv_ref)):
            err = float((got.float() - ref.float()).abs().max())
            scale = float(ref.float().abs().max())
            finite = bool(torch.isfinite(got.float()).all())
            row[f"{gname}_max_abs_err"] = err
            row[f"{gname}_max_abs"] = scale
            row["ok"] = (row["ok"] and finite
                         and err <= BWD_ATOL + rtol * scale)
        if row["ok"] and name == TRAIN_SHAPE[0]:
            row["times"] = _time_backward(q, k, v, do, lse, delta, b, l,
                                          causal, tname)
        results.append(row)
        emit("kernel flash_bwd", **row)
        del q, k, v, do, o, lse, delta, dq, dk_h, dv_h, dq_ref, dk_ref, dv_ref
        if not row["ok"]:
            raise PhaseError(f"flash backward kernels disagree with their "
                             f"plain versions on {name}")
    return {"cases": results}


def _time_backward(q, k, v, do, lse, delta, b, l, causal, tname,
                   heads=ATTN_HEADS) -> dict:
    """Times of the two backward kernels at one shape, each as the forward
    is timed: through its wrapper (device time, CUDA-event loop time, host
    time per call), the earlier mma.sync kernel on the same inputs through
    the same wrapper (``prev``: device time and host time per call, the
    route switched with ``_mma_route``; the host times in turns), the
    plain version, the bound;
    and, for the pair, SDPA's backward in device time (``library_ms``).
    ``prev`` only where the wrappers take the Hopper kernels."""
    import torch

    from horovod_tpu_torch.parallel import flash_attention as fa

    H, KVH, D = heads
    hopper = fa._BWD_ENTRY[q.dtype, D] != fa._MMA_BWD
    kw = dict(n_heads=H, n_kv_heads=KVH, causal=causal)
    blk = dict(block_q=min(512, l), block_k=min(512, l))

    out = {}
    for kname, fn, plain, outputs, products in (
            ("dq", lambda: fa._flash_bwd_dq_cuda(q, k, v, do, lse, delta,
                                                 **kw),
             lambda: fa._flash_bwd_dq_reference(q, k, v, do, lse, delta,
                                                **kw, **blk), 1, 3),
            ("dkv", lambda: fa._flash_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                                   **kw),
             lambda: fa._flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                 **kw, **blk), 2, 4)):
        r = {}
        r["ms"], r["kernel_names"] = device_ms(fn)
        r["wall_ms"] = time_ms(fn)
        if hopper:
            with _mma_route(fa._BWD_ENTRY, q.dtype, D):
                r["prev_ms"], r["prev_names"] = device_ms(fn)
            r["speedup_vs_prev"] = r["prev_ms"] / r["ms"]
            r["host_us_per_call"], r["prev_host_us_per_call"] = _host_us_ab(
                fn, fa._BWD_ENTRY, q.dtype, D)
        else:
            r["host_us_per_call"] = host_us(fn)
        r["plain_ms"] = time_ms(plain, reps=3, inner=1, warmup=1)
        r["bound_ms"], r["bound_by"] = _bwd_bound(
            b, H, KVH, l, D, causal, q.element_size(), tname, products,
            outputs)
        r["tflops"] = _bwd_flops(b, H, l, D, causal, products) / r["ms"] / 1e9
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        out[kname] = r
    out["library_ms"], out["library_names"] = _sdpa_backward_ms(
        q, k, v, do, b, H, KVH, l, D, causal)
    return out


@contextlib.contextmanager
def _mma_route(table: dict, dtype, head_dim: int):
    """Routes the wrappers of ``table`` (``_FWD_ENTRY`` or ``_BWD_ENTRY``)
    at (dtype, head dim) to the mma.sync kernels while the block runs: the
    yardstick of ``prev_ms`` and of the ViT-B/16 step's A/B."""
    from horovod_tpu_torch.parallel import flash_attention as fa

    key = (dtype, head_dim)
    entries = table[key]
    table[key] = fa._MMA_FWD if table is fa._FWD_ENTRY else fa._MMA_BWD
    try:
        yield
    finally:
        table[key] = entries


def _host_us_ab(fn, table: dict, dtype, head_dim: int, rounds: int = 25,
                n: int = 10):
    """Host time per call of a wrapper of ``table`` on its route and on the
    mma.sync route, in short turns (``n`` calls of each, the first route
    alternating), since the host's clock drifts by more than the routes
    differ: the median of ``rounds`` turns of each."""
    times = {False: [], True: []}            # by "on the mma.sync route"
    for i in range(rounds):
        for mma in (bool(i % 2), not i % 2):
            with (_mma_route(table, dtype, head_dim) if mma
                  else contextlib.nullcontext()):
                times[mma].append(host_us(fn, n))
    return statistics.median(times[False]), statistics.median(times[True])


def _sdpa_backward_ms(q, k, v, do, b, h, kvh, l, d, causal):
    """The yardstick for the backward pair: device time of the autograd
    grad of PyTorch's ``scaled_dot_product_attention`` (KV expanded to H
    heads) minus that of its forward, with the backward's kernel names.
    The port never calls it."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.parallel import flash_attention as fa

    rows = fa._kv_rows(b * h, h, kvh, DEV)
    q4 = q.view(b, h, l, d).detach().requires_grad_()
    k4 = k[rows].view(b, h, l, d).detach().requires_grad_()
    v4 = v[rows].view(b, h, l, d).detach().requires_grad_()
    do4 = do.view(b, h, l, d)

    def fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)

    def fwd_bwd():
        out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
        torch.autograd.grad(out, (q4, k4, v4), do4)

    both, names = device_ms(fwd_bwd)
    fwd_only, fwd_names = device_ms(fwd)
    return both - fwd_only, [n for n in names if n not in fwd_names]


# ViT-B/16 attention at 224 px: 12 heads of 64 over 196 patches, no GQA,
# bidirectional; ``bench.py _bench_vit``'s batch of 64.
VIT_HEADS = (12, 12, 64)
VIT_SHAPE = ("vit_b16_b64_l196", 64, 196, False)


def phase_kernel_d64(seed: int) -> dict:
    """The three kernels at head dim 64 (64 × 64 tiles; the Hopper D = 64
    kernels for bf16/f16, the mma.sync kernels for f32) against their plain
    versions (the forward blocked 64 × 64 as the kernels tile) with the
    D = 128 phases' tolerances, at the ViT-B/16 shape in bf16, f16 and f32,
    one causal case and tails L ∈ {1, 63, 65, 1000}; at the ViT shape in
    bf16 the kernels' times, bounds, ``prev_ms`` and
    ``prev_host_us_per_call`` (the mma.sync kernels through the same
    wrappers) and SDPA's forward and backward."""
    import torch

    from horovod_tpu_torch.parallel import flash_attention as fa

    H, KVH, D = VIT_HEADS
    names = {torch.bfloat16: "bf16", torch.float16: "f16",
             torch.float32: "f32"}
    cases = [(*VIT_SHAPE, torch.bfloat16), (*VIT_SHAPE, torch.float16),
             (*VIT_SHAPE, torch.float32),
             ("causal_b2_l333", 2, 333, True, torch.bfloat16),
             ("noncausal_b2_l1", 2, 1, False, torch.bfloat16),
             ("noncausal_b2_l63", 2, 63, False, torch.bfloat16),
             ("causal_b2_l65", 2, 65, True, torch.float16),
             ("noncausal_b1_l1000", 1, 1000, False, torch.bfloat16)]
    gen = torch.Generator(device=DEV).manual_seed(seed + 4)
    fwd_rows, bwd_rows = [], []
    for name, b, l, causal, dtype in cases:
        tname = names[dtype]
        q, k, v, do = (torch.randn((b * h, l, D), generator=gen,
                                   device=DEV).to(dtype)
                       for h in (H, KVH, KVH, H))
        kw = dict(n_heads=H, n_kv_heads=KVH, causal=causal)
        o, lse = fa._flash_forward_cuda(q, k, v, **kw)
        sync()
        o_ref, lse_ref = fa._flash_forward_reference(q, k, v, **kw,
                                                     block_q=64, block_k=64)
        atol, rtol = O_TOL[tname]
        diff = (o.float() - o_ref.float()).abs()
        frow = {"case": name, "dtype": tname, "B": b, "L": l, "H": H,
                "KVH": KVH, "D": D, "causal": causal,
                "entry": fa._FWD_ENTRY[dtype, D], "ref_block": 64,
                "o_max_abs_err": float(diff.max()),
                "o_tol": f"{atol} + {rtol}*|o|",
                "o_excess_over_tol": float(
                    (diff - rtol * o_ref.float().abs()).max()),
                "lse_max_abs_err": float((lse - lse_ref).abs().max()),
                "lse_tol": LSE_TOL}
        frow["ok"] = bool(torch.isfinite(o.float()).all()) and (
            frow["o_excess_over_tol"] <= atol
            and frow["lse_max_abs_err"] <= LSE_TOL)
        lse = lse.view(b * H, l)
        delta = fa._delta(o, do)
        dq = fa._flash_bwd_dq_cuda(q, k, v, do, lse, delta, **kw)
        dk_h, dv_h = fa._flash_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw)
        sync()
        blk = dict(block_q=min(512, l), block_k=min(512, l))
        refs = (fa._flash_bwd_dq_reference(q, k, v, do, lse, delta, **kw,
                                           **blk),
                *fa._flash_bwd_dkv_reference(q, k, v, do, lse, delta, **kw,
                                             **blk))
        brow = {"case": name, "dtype": tname, "B": b, "L": l, "H": H,
                "KVH": KVH, "D": D, "causal": causal,
                "entries": list(fa._BWD_ENTRY[dtype, D]),
                "tol": f"{BWD_ATOL} + {BWD_RTOL[tname]} * max|grad|",
                "ok": True}
        for gname, got, ref in zip(("dq", "dk", "dv"), (dq, dk_h, dv_h),
                                   refs):
            err = float((got.float() - ref.float()).abs().max())
            scale = float(ref.float().abs().max())
            brow[f"{gname}_max_abs_err"] = err
            brow[f"{gname}_max_abs"] = scale
            brow["ok"] = (brow["ok"] and bool(torch.isfinite(got.float()).all())
                          and err <= BWD_ATOL + BWD_RTOL[tname] * scale)
        if frow["ok"] and brow["ok"] and (name, dtype) == (
                VIT_SHAPE[0], torch.bfloat16):
            frow.update(_time_forward(q, k, v, b, l, causal, 64, tname,
                                      heads=VIT_HEADS))
            brow["times"] = _time_backward(q, k, v, do, lse, delta, b, l,
                                           causal, tname, heads=VIT_HEADS)
        fwd_rows.append(frow)
        bwd_rows.append(brow)
        emit("kernel flash_fwd d64", **frow)
        emit("kernel flash_bwd d64", **brow)
        del q, k, v, do, o, lse, delta, dq, dk_h, dv_h, o_ref, lse_ref, refs
        if not (frow["ok"] and brow["ok"]):
            raise PhaseError(f"the D = 64 kernels disagree with their plain "
                             f"versions on {name} {tname}")
    return {"fwd": fwd_rows, "bwd": bwd_rows}


def _model(n_layers: int, seed: int):
    import torch

    from horovod_tpu_torch.models import llama

    cfg = llama.llama3_8b(attn_impl="flash", n_layers=n_layers,
                          param_dtype=torch.bfloat16)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    params = llama.init_params(cfg, gen, device=DEV)
    return cfg, params


def phase_generate(cfg, params, seed: int) -> dict:
    import numpy as np
    import torch

    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.parallel import flash_attention as fa

    rng = np.random.RandomState(seed)
    b, width, n_new = 4, 1024, 16
    lengths = [300, 517, 777, 1024]
    prompt = np.zeros((b, width), np.int64)
    for r, n in enumerate(lengths):
        prompt[r, :n] = rng.randint(0, cfg.vocab_size, n)
    prompt_t = torch.as_tensor(prompt, device=DEV)
    lengths_t = torch.as_tensor(lengths, device=DEV)

    # warm-up (cuBLAS handles, the kernel library) outside the counted run
    llama.prefill(params, prompt_t[:1, :64], cfg,
                  llama.init_cache(cfg, 1, 64, device=DEV))
    sync()

    fa.launches = 0
    t0 = time.perf_counter()
    toks = llama.generate(params, prompt_t, cfg, max_new_tokens=n_new,
                          prompt_lengths=lengths_t)
    sync()
    t_gen = time.perf_counter() - t0
    launches = fa.launches

    t0 = time.perf_counter()
    logits_f, _ = llama.prefill(params, prompt_t, cfg,
                                llama.init_cache(cfg, b, width, device=DEV),
                                lengths=lengths_t)
    sync()
    t_prefill = time.perf_counter() - t0
    dense = dataclasses.replace(cfg, attn_impl="dense")
    logits_d, _ = llama.prefill(params, prompt_t, dense,
                                llama.init_cache(dense, b, width, device=DEV),
                                lengths=lengths_t)
    sync()
    scale = float(logits_d.abs().max())
    err = float((logits_f - logits_d).abs().max())
    toks_host = toks.cpu().numpy()
    in_vocab = bool(((toks_host >= 0) & (toks_host < cfg.vocab_size)).all())
    finite = bool(torch.isfinite(logits_f).all())
    out = {
        "B": b, "padded_width": width, "prompt_lengths": lengths,
        "new_tokens": n_new, "n_layers": cfg.n_layers, "dim": cfg.dim,
        "flash_launches": launches, "expected_launches": cfg.n_layers,
        "logits_max_abs_diff_flash_vs_dense": err, "logits_max_abs": scale,
        "logits_rtol": LOGIT_RTOL, "tokens_in_vocab": in_vocab,
        "logits_finite": finite, "generate_s": t_gen, "prefill_s": t_prefill,
        "prefill_tokens_per_s": b * width / t_prefill,
        "decode_tokens_per_s": b * (n_new - 1) / max(t_gen - t_prefill, 1e-9),
        "first_tokens": toks_host[:, 0].tolist(),
    }
    out["ok"] = (launches == cfg.n_layers and in_vocab and finite
                 and err <= LOGIT_RTOL * scale)
    emit("serve generate", **out)
    if not out["ok"]:
        raise PhaseError("serve generate failed its checks")
    return {"launches": launches}


def phase_batcher(cfg, params, seed: int) -> dict:
    import numpy as np
    import torch

    from horovod_tpu_torch import serving
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.parallel import flash_attention as fa

    rng = np.random.RandomState(seed + 1)
    system = rng.randint(0, cfg.vocab_size, 512).tolist()
    suffix_lengths = [1, 37, 100, 255, 256, 300, 513, 700]
    n_new = 16
    reqs = [serving.Request(prompt=rng.randint(0, cfg.vocab_size, n).tolist(),
                            max_new_tokens=n_new)
            for n in suffix_lengths]

    fa.launches = 0
    t0 = time.perf_counter()
    prefix = serving.precompute_prefix(params, cfg, system)
    for r in reqs:
        r.prefix = prefix
    batcher = serving.ContinuousBatcher(params, cfg, n_slots=4, max_len=2048,
                                        admit_width=256)
    results = batcher.run(reqs)
    sync()
    t_serve = time.perf_counter() - t0
    launches = fa.launches

    budgets_ok = all(len(r) == n_new for r in results)
    checked = agreed = same_seq = same_tok = 0
    for req, got in zip(reqs, results):
        full = torch.as_tensor([system + req.prompt], device=DEV)
        logits, _ = llama.prefill(
            params, full, cfg,
            llama.init_cache(cfg, 1, full.shape[1], device=DEV))
        top2 = torch.topk(logits[0], 2).values
        margin = float(top2[0] - top2[1])
        solo = llama.generate(params, full, cfg,
                              max_new_tokens=n_new)[0].tolist()
        if margin > MARGIN_RTOL * float(logits.abs().max()):
            checked += 1
            agreed += int(got[0] == solo[0])
        same_seq += int(list(got) == solo)
        same_tok += sum(int(a == b) for a, b in zip(got, solo))
    out = {
        "prefix_tokens": len(system), "suffix_lengths": suffix_lengths,
        "n_slots": 4, "max_len": 2048, "admit_width": 256,
        "new_tokens": n_new, "flash_launches": launches,
        "expected_launches": cfg.n_layers, "budgets_ok": budgets_ok,
        "first_tokens_checked": checked, "first_tokens_agreed": agreed,
        "margin_rtol": MARGIN_RTOL,
        "sequence_agreement": same_seq / len(reqs),
        "token_agreement": same_tok / (len(reqs) * n_new),
        "serve_s": t_serve,
        "served_tokens_per_s": len(reqs) * n_new / t_serve,
    }
    out["ok"] = (budgets_ok and launches == cfg.n_layers and agreed == checked)
    emit("serve batcher", **out)
    if not out["ok"]:
        raise PhaseError("serve batcher failed its checks")
    return {"launches": launches}


def _train_flops(cfg, tokens: int) -> float:
    """Model FLOP of one train step: 6·N·T for the N weights of the layers'
    and the lm_head's products, plus six attention products per layer
    (Q·Kᵀ and P·V forward; dP, dV, dQ and dK backward) over the causal
    triangle.  The remat recompute is not counted."""
    d, f, v = cfg.dim, cfg.ffn_dim, cfg.vocab_size
    kdim = cfg.n_kv_heads * cfg.head_dim
    n_mm = cfg.n_layers * (2 * d * d + 2 * d * kdim + 3 * d * f) + d * v
    pairs = tokens * (tokens + 1) // 2
    attn = cfg.n_layers * 6 * 2 * cfg.n_heads * cfg.head_dim * pairs
    return 6 * n_mm * tokens + attn


# Kernel names → the layer they belong to, for the train step's breakdown.
_KERNEL_KINDS = (
    ("flash_fwd", ("flash_fwd_wgmma_kernel", "flash_fwd_d64_kernel",
                   "flash_fwd_mma_kernel")),
    ("batch norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
    ("conv (cuDNN)", ("fprop", "dgrad", "wgrad", "implicit_convolve",
                      "winograd", "cudnn")),
    ("flash_bwd_dq", ("flash_bwd_dq_",)),
    ("flash_bwd_dkv", ("flash_bwd_dkv_",)),
    ("matmul (cuBLAS)", ("gemm", "xmma", "cutlass", "nvjet")),
    ("optimizer (AdamW)", ("adam",)),
    ("nccl", ("nccl",)),
    ("memcpy/memset", ("memcpy", "memset")),
)


# The kernels the bf16 backward entries launch: the train step's profile
# must show these and not the mma.sync kernels.
BWD_KERNELS = ("flash_bwd_dq_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel")
# The kernel behind each entry a bf16 route can take at D = 64: its name in
# the profile and in ptxas's report, the bf16 D = 64 instance's template
# arguments in the mangled name, and the design (the source is
# ``flash_attention._LIBRARY``'s).
_ENTRY_KERNELS = {
    "hvd_flash_fwd_mma": ("flash_fwd_mma_kernel", "I13__nv_bfloat16Li64E",
                          "cuda mma.sync"),
    "hvd_flash_fwd_d64": ("flash_fwd_d64_kernel", "I13__nv_bfloat16",
                          "cuda wgmma+tma"),
    "hvd_flash_bwd_dq_mma": ("flash_bwd_dq_mma_kernel",
                             "I13__nv_bfloat16Li64E", "cuda mma.sync"),
    "hvd_flash_bwd_dkv_mma": ("flash_bwd_dkv_mma_kernel",
                              "I13__nv_bfloat16Li64E", "cuda mma.sync"),
    "hvd_flash_bwd_dq_d64": ("flash_bwd_dq_d64_kernel", "I13__nv_bfloat16",
                             "cuda wgmma+tma"),
    "hvd_flash_bwd_dkv_d64": ("flash_bwd_dkv_d64_kernel", "I13__nv_bfloat16",
                              "cuda wgmma+tma"),
}


def _device_breakdown(prof, wall_s: float) -> dict:
    """Device time of one profiled step by kind of kernel, the device's busy
    time (the union of kernel intervals) and its idle share of the step's
    host wall time.  Profiling adds host overhead, so the idle share is an
    upper bound for an unprofiled step."""
    from torch.autograd import DeviceType

    # Device events minus the ranges user annotations (Optimizer.step and
    # the like) draw over the kernels they contain.
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    ms_by_kind: dict[str, float] = {}
    by_name: dict[str, list] = {}
    spans = []
    for e in kernels:
        low = e.name.lower()
        kind = next((k for k, keys in _KERNEL_KINDS
                     if any(key in low for key in keys)),
                    "other (elementwise, reductions, casts)")
        ms = e.device_time_total / 1e3
        ms_by_kind[kind] = ms_by_kind.get(kind, 0.0) + ms
        entry = by_name.setdefault(e.name[:90], [0.0, 0])
        entry[0] += ms
        entry[1] += 1
        spans.append((e.time_range.start, e.time_range.end))
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy_ms = busy_us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "flash_kernel_names": sorted(n for n in by_name if "flash" in n),
        "kernels": len(kernels), "wall_ms": wall_s * 1e3,
        "device_busy_ms": busy_ms,
        "device_idle_share": (1 - busy_ms / (wall_s * 1e3)
                              if kernels else None),
        "ms_by_kind": ms_by_kind,
        "top_kernels": [{"name": n, "ms": v[0], "count": v[1]}
                        for n, v in top],
    }


def phase_train(n_layers: int, seed: int) -> dict:
    import numpy as np
    import torch

    from horovod_tpu_torch import basics
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.optim.distributed_optimizer import (
        DistributedOptimizer, broadcast_parameters, make_train_step,
        tree_leaves)
    from horovod_tpu_torch.parallel import flash_attention as fa

    basics.init()                     # NCCL, a world of one
    cfg = llama.llama3_8b(attn_impl="flash", n_layers=n_layers)
    assert cfg.remat and cfg.param_dtype == torch.float32
    params = broadcast_parameters(llama.init_params(cfg, seed, device=DEV))
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_()
    rng = np.random.RandomState(seed + 3)
    tokens = torch.as_tensor(
        rng.randint(0, cfg.vocab_size, (1, TRAIN_TOKENS + 1)), device=DEV)
    batch = (tokens[:, :-1], tokens[:, 1:])
    loss_fn = llama.make_loss_fn(cfg)

    # Step 0's gradients, kernel backward against the blockwise recompute.
    watched = ("wq", "wk", "wv", "wo")

    def grads(bwd: str):
        os.environ["HVD_TORCH_FLASH_BWD"] = bwd
        try:
            loss_fn(params, batch).backward()
        finally:
            os.environ.pop("HVD_TORCH_FLASH_BWD")
        norm = float(torch.sqrt(sum(t.grad.float().pow(2).sum()
                                    for t in leaves)))
        kept = {n: params["layers"][n].grad.float().clone() for n in watched}
        for t in leaves:
            t.grad = None
        return norm, kept

    norm_k, g_k = grads("kernel")
    norm_b, g_b = grads("blockwise")
    leaf_err = {n: float((g_k[n] - g_b[n]).norm() / g_b[n].norm())
                for n in watched}
    del g_k, g_b
    with torch.no_grad():
        loss_plain = float(loss_fn(params, batch))
        loss_fused = float(llama.loss_fn(
            params, batch, dataclasses.replace(cfg, fused_loss_chunk=8192)))

    opt = DistributedOptimizer(torch.optim.AdamW(
        leaves, lr=2e-5, betas=(0.9, 0.95), weight_decay=0.1, fused=True))
    step = make_train_step(loss_fn, opt, max_grad_norm=1.0)
    sync()
    torch.cuda.reset_peak_memory_stats()
    losses, seconds, per_step = [], [], []
    # Four timed steps, then one under the profiler; the profiled step is
    # taken again (at most twice) when the profiler dropped the backward
    # kernels' events, so the route check reads a whole profile.
    for i in range(7):
        profiling = i >= 4
        prof = (torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) if profiling
            else contextlib.nullcontext())
        fa.launches = fa.dq_launches = fa.dkv_launches = 0
        with prof:
            t0 = time.perf_counter()
            out = step(params, batch)
            losses.append(float(out.loss))    # synchronises
            sync()
            seconds.append(time.perf_counter() - t0)
        per_step.append({"flash_fwd": fa.launches,
                         "flash_bwd_dq": fa.dq_launches,
                         "flash_bwd_dkv": fa.dkv_launches})
        if profiling:
            profiled = _device_breakdown(prof, seconds[-1])
            bwd_names = [n for n in profiled["flash_kernel_names"]
                         if "flash_bwd" in n]
            if len(bwd_names) >= len(BWD_KERNELS):
                break
    step_s = statistics.median(seconds[1:4])
    flops = _train_flops(cfg, TRAIN_TOKENS)
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkv": cfg.n_layers}
    out = {
        "n_layers": cfg.n_layers, "dim": cfg.dim, "n_heads": cfg.n_heads,
        "n_kv_heads": cfg.n_kv_heads, "ffn_dim": cfg.ffn_dim,
        "vocab_size": cfg.vocab_size, "tokens_per_step": TRAIN_TOKENS,
        "remat": cfg.remat, "attn_impl": cfg.attn_impl,
        "params": llama.num_params(cfg), "world_size": basics.size(),
        "losses": losses, "step_seconds": seconds,
        "step_s_median_2_4": step_s,
        "profiled_step_5": profiled,
        "train_tokens_per_s": TRAIN_TOKENS / step_s,
        "model_flop_per_step": flops,
        "model_flop_share_of_989T": flops / step_s / PEAK_BF16,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches_per_step": per_step, "expected_launches_per_step": want,
        "grad_norm_kernel": norm_k, "grad_norm_blockwise": norm_b,
        "grad_norm_rtol": GRAD_NORM_RTOL, "grad_leaf_rel_err": leaf_err,
        "grad_leaf_rtol": GRAD_LEAF_RTOL,
        "loss_plain": loss_plain, "loss_fused_8192": loss_fused,
        "fused_loss_rtol": FUSED_LOSS_RTOL,
    }
    checks = {
        "launches": all(p == want for p in per_step),
        "bwd_kernels": all(any(k in n for n in bwd_names) for k in BWD_KERNELS)
        and all(any(k in n for k in BWD_KERNELS) for n in bwd_names),
        "finite": all(np.isfinite(losses)),
        "decreasing": losses[-1] < losses[0],
        "grad_norm": abs(norm_k - norm_b) <= GRAD_NORM_RTOL * norm_b,
        "grad_leaves": all(e <= GRAD_LEAF_RTOL for e in leaf_err.values()),
        "fused_loss": abs(loss_fused - loss_plain)
        <= FUSED_LOSS_RTOL * abs(loss_plain),
    }
    out["checks"] = checks
    out["ok"] = all(checks.values())
    emit("train", **out)
    if not out["ok"]:
        raise PhaseError(f"train failed its checks: "
                         f"{[k for k, v in checks.items() if not v]}")
    return {"launches": {k: sum(p[k] for p in per_step) for k in want}}


# -- vision paths ------------------------------------------------------------

VISION_BATCH = 64        # bench.py _bench_resnet / _bench_vit, per card
# ViT-B/16 step 0: logits with the kernels against attn_impl="dense" on the
# same weights, relative to the largest |logit|.  Both round the attention
# output to bf16; dense also rounds the scores to bf16 before the softmax,
# the kernel rounds P; twelve layers' residual stream carries it (the
# Llama prefill check's bound).
VIT_LOGIT_RTOL = 5e-2
# ViT-B/16 step 0's gradients with the kernels against the blockwise
# recompute and against dense attention: the Llama train check's bounds.
# Each attention backward rounds P and dS to bf16 in another place (the
# kernels at each 64 × 64 tile, dense autograd at its bf16 products, the
# blockwise recompute not at all), unbiased at 2**-8 relative per element,
# then twelve layers' backward carry it.
VIT_GRAD_NORM_RTOL = 2e-2
VIT_GRAD_LEAF_RTOL = 5e-2


def _cross_entropy(model, batch):
    import torch.nn.functional as F

    x, y = batch
    return F.cross_entropy(model(x, train=True).float(), y)


def _step_flops(model, batch) -> int:
    """FLOP of one forward and backward as ``torch.utils.flop_counter``
    counts them (convolutions and matrix products; norms, activations and
    the optimizer are not counted)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        _cross_entropy(model, batch).backward()
    model.zero_grad(set_to_none=True)
    return counter.get_total_flops()


def _vision_batch(seed: int, image_size: int):
    from horovod_tpu_torch.data import synthetic_imagenet, to_device

    images, labels = synthetic_imagenet(VISION_BATCH, image_size, seed=seed)
    return to_device(images, DEV), to_device(labels, DEV)


def _run_steps(step, model, batch, warmup: int, timed: int,
               profile: bool) -> dict:
    """``warmup`` + ``timed`` steps, then one under ``torch.profiler`` when
    ``profile``; the flash launch counters are set to 0 before each step and
    read after it."""
    import torch

    from horovod_tpu_torch.parallel import flash_attention as fa

    losses, seconds, launches = [], [], []
    n = warmup + timed + int(profile)
    prof = None
    for i in range(n):
        profiled = profile and i == n - 1
        ctx = (torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) if profiled
            else contextlib.nullcontext())
        fa.launches = fa.dq_launches = fa.dkv_launches = 0
        with ctx as prof_i:
            t0 = time.perf_counter()
            out = step(model, batch)
            losses.append(float(out.loss))    # synchronises
            sync()
            seconds.append(time.perf_counter() - t0)
        if profiled:
            prof = prof_i
        launches.append({"flash_fwd": fa.launches,
                         "flash_bwd_dq": fa.dq_launches,
                         "flash_bwd_dkv": fa.dkv_launches})
    step_s = statistics.median(seconds[warmup:warmup + timed])
    return {"losses": losses, "step_seconds": seconds, "step_s": step_s,
            "images_per_s": VISION_BATCH / step_s, "launches": launches,
            "profiled_step": (_device_breakdown(prof, seconds[-1])
                              if profile else None)}


def _vision_train(name: str, model, opt, batch, *, warmup: int, timed: int,
                  profile: bool, flops: int | None, extra: dict,
                  after=None) -> dict:
    """The data-parallel step a user runs: ``broadcast_parameters``,
    ``broadcast_optimizer_state``, ``DistributedOptimizer``,
    ``make_train_step``; timed, with the checks every vision path shares
    (finite losses that fall on the repeated batch), the checks in
    ``extra["checks"]`` and, once the steps ran, ``after(step, run)``'s
    ``"checks"`` (its other keys join the phase's line)."""
    import numpy as np

    from horovod_tpu_torch import basics
    from horovod_tpu_torch.optim.distributed_optimizer import (
        DistributedOptimizer, broadcast_optimizer_state,
        broadcast_parameters, make_train_step)

    broadcast_parameters(model)
    opt = DistributedOptimizer(opt)
    broadcast_optimizer_state(opt)
    step = make_train_step(_cross_entropy, opt)
    run = _run_steps(step, model, batch, warmup, timed, profile)
    out = {"batch": VISION_BATCH, "world_size": basics.size(),
           "params": sum(p.numel() for p in model.parameters()), **run,
           **extra}
    if flops is not None:
        out["model_flop_per_step"] = flops
        out["model_flop_counted_by"] = ("torch.utils.flop_counter over one "
                                        "forward+backward")
        out["model_flop_share_of_989T"] = flops / run["step_s"] / PEAK_BF16
    checks = {"finite": bool(np.isfinite(run["losses"]).all()),
              "decreasing": run["losses"][-1] < run["losses"][0]}
    late = after(step, run) if after else {}
    out["checks"] = {**checks, **out.pop("checks", {}),
                     **late.pop("checks", {})}
    out.update(late)
    out["ok"] = all(out["checks"].values())
    emit(name, **out)
    if not out["ok"]:
        raise PhaseError(f"{name} failed its checks: "
                         f"{[k for k, v in out['checks'].items() if not v]}")
    return out


def phase_resnet101(seed: int) -> dict:
    """``bench.py _bench_resnet``: ResNet-101, batch 64 at 224 × 224, bf16
    compute with f32 parameters and BN, ``SGD(0.01, momentum=0.9)``."""
    import torch

    from horovod_tpu_torch import basics
    from horovod_tpu_torch.models.resnet import ResNet101

    basics.init()
    torch.backends.cudnn.benchmark = True
    model = ResNet101(dtype=torch.bfloat16, device=DEV, seed=seed)
    batch = _vision_batch(seed + 5, 224)
    flops = _step_flops(model, batch)
    stats = [m.running_mean.clone() for m in model.modules()
             if hasattr(m, "running_mean")]
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)

    def stats_moved(step, run):
        moved = [m.running_mean for m in model.modules()
                 if hasattr(m, "running_mean")]
        return {"checks": {"bn_stats_moved": all(
            not torch.equal(a, b) for a, b in zip(stats, moved))}}

    out = _vision_train("train resnet101", model, opt, batch, warmup=2,
                        timed=8, profile=True, flops=flops, extra={},
                        after=stats_moved)
    return out


def _vit_grads(model, batch, bwd: str | None = None):
    """Loss, logits and every parameter's gradient (f32 copies) of one
    forward and backward; ``bwd`` sets ``HVD_TORCH_FLASH_BWD``."""
    import torch.nn.functional as F

    x, y = batch
    if bwd is not None:
        os.environ["HVD_TORCH_FLASH_BWD"] = bwd
    try:
        logits = model(x).float()
        F.cross_entropy(logits, y).backward()
    finally:
        os.environ.pop("HVD_TORCH_FLASH_BWD", None)
    grads = {n: p.grad.float().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return logits.detach(), grads


def _grad_distance(g, ref) -> dict:
    """Global-norm difference and the attention weights' per-leaf relative
    distances, against ``ref``."""
    import torch

    norm = float(torch.sqrt(sum(t.pow(2).sum() for t in g.values())))
    norm_ref = float(torch.sqrt(sum(t.pow(2).sum() for t in ref.values())))
    leaves = {n: float((g[n] - ref[n]).norm() / ref[n].norm())
              for n in g if ".attn." in n and n.endswith("weight")}
    return {"norm": norm, "norm_ref": norm_ref,
            "norm_rel_diff": abs(norm - norm_ref) / norm_ref,
            "max_leaf_rel": max(leaves.values()),
            "worst_leaf": max(leaves, key=leaves.get)}


def _vit_route_ab(step, model, batch, run, table: dict) -> dict:
    """The ViT-B/16 step's A/B of one route, the forward's (``table`` is
    ``_FWD_ENTRY``) or the backward pair's (``_BWD_ENTRY``): the same steps
    with that route on the mma.sync kernels and on the routed ones, in
    turns (mma, routed, mma, routed after the routed ``run``), each run's
    images/s, profiled idle share and the route's kernels' profiled ms, and
    the medians by route."""
    import torch

    from horovod_tpu_torch.parallel import flash_attention as fa

    kind = "flash_fwd" if table is fa._FWD_ENTRY else "flash_bwd"
    runs = [("routed", run)]
    for route in ("mma", "routed", "mma", "routed"):
        ctx = (_mma_route(table, torch.bfloat16, 64) if route == "mma"
               else contextlib.nullcontext())
        with ctx:
            runs.append((route, _run_steps(step, model, batch, 2, 8, True)))
    ab = {"runs": [], "images_per_s": {}, "device_idle_share": {}}
    for route, r in runs:
        prof = r["profiled_step"]
        ab["runs"].append({
            "route": route, "images_per_s": r["images_per_s"],
            "step_s": r["step_s"],
            "device_idle_share": prof["device_idle_share"],
            "device_busy_ms": prof["device_busy_ms"],
            f"{kind}_ms": {k: v for k, v in prof["ms_by_kind"].items()
                           if k.startswith(kind)}})
    for key in ("images_per_s", "device_idle_share"):
        for route in ("routed", "mma"):
            got = [x[key] for x in ab["runs"]
                   if x["route"] == route and x[key] is not None]
            ab[key][route] = statistics.median(got) if got else None
    return ab


def phase_vit_b16(seed: int, ab: tuple = ()) -> dict:
    """``bench.py _bench_vit`` with the flash kernels: ViT-B/16, bf16,
    ``attn_impl="flash"`` (head dim 64, L = 196, non-causal), batch 64 at
    224, ``AdamW(1e-3, weight_decay=1e-4)``.  Each step must launch the
    forward, dQ and dK/dV kernels once per block, and the profiled step
    must show exactly the forward and backward kernels the bf16 routes
    name; step 0's logits and gradients are held against dense attention
    and the blockwise backward on the same weights.  ``ab`` names the
    routes (``"fwd"``, ``"bwd"``) to A/B after the timed steps
    (``_vit_route_ab``)."""
    import torch

    from horovod_tpu_torch import basics
    from horovod_tpu_torch.models.vit import ViT_B16

    basics.init()
    model = ViT_B16(dtype=torch.bfloat16, attn_impl="flash", device=DEV,
                    seed=seed)
    dense = ViT_B16(dtype=torch.bfloat16, attn_impl="dense", device=DEV,
                    seed=seed)
    dense.load_state_dict(model.state_dict())
    batch = _vision_batch(seed + 6, 224)
    logits_k, g_k = _vit_grads(model, batch)
    _, g_b = _vit_grads(model, batch, "blockwise")
    logits_d, g_d = _vit_grads(dense, batch)
    flops = _step_flops(dense, batch)    # the kernels are not counted
    del dense
    scale = float(logits_d.abs().max())
    err = float((logits_k - logits_d).abs().max())
    vs_blockwise, vs_dense = _grad_distance(g_k, g_b), _grad_distance(g_k, g_d)
    del g_k, g_b, g_d
    depth = len(model.blocks)
    want = {"flash_fwd": depth, "flash_bwd_dq": depth,
            "flash_bwd_dkv": depth}
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4,
                            fused=True)
    checks = {
        "logits_vs_dense": err <= VIT_LOGIT_RTOL * scale,
        "grads_vs_blockwise": (
            vs_blockwise["norm_rel_diff"] <= VIT_GRAD_NORM_RTOL
            and vs_blockwise["max_leaf_rel"] <= VIT_GRAD_LEAF_RTOL),
        "grads_vs_dense": (
            vs_dense["norm_rel_diff"] <= VIT_GRAD_NORM_RTOL
            and vs_dense["max_leaf_rel"] <= VIT_GRAD_LEAF_RTOL),
    }
    extra = {"depth": depth, "dim": 768, "heads": 12, "head_dim": 64,
             "tokens": 196, "attn_impl": "flash",
             "logits_max_abs_diff_vs_dense": err, "logits_max_abs": scale,
             "logits_rtol": VIT_LOGIT_RTOL,
             "grads_vs_blockwise": vs_blockwise, "grads_vs_dense": vs_dense,
             "grad_norm_rtol": VIT_GRAD_NORM_RTOL,
             "grad_leaf_rtol": VIT_GRAD_LEAF_RTOL,
             "expected_launches_per_step": want, "checks": checks}
    from horovod_tpu_torch.parallel import flash_attention as fa

    def routed_and_ab(step, run):
        """The profiled step went through exactly the kernels
        ``_FWD_ENTRY`` and ``_BWD_ENTRY`` name for bf16 at D = 64, and the
        A/B of each route ``ab`` names."""
        names = run["profiled_step"]["flash_kernel_names"]

        def routed(kind, entries):
            want = [_ENTRY_KERNELS[e][0] for e in entries]
            got = [n for n in names if kind in n]
            return (all(any(k in n for n in got) for k in want)
                    and all(any(k in n for k in want) for n in got))

        fwd_entry = fa._FWD_ENTRY[torch.bfloat16, 64]
        bwd_entries = fa._BWD_ENTRY[torch.bfloat16, 64]
        late = {"checks": {
                    "fwd_kernels_routed": routed("flash_fwd", (fwd_entry,)),
                    "bwd_kernels_routed": routed("flash_bwd", bwd_entries)},
                "fwd_route": fwd_entry, "bwd_route": list(bwd_entries)}
        tables = {"fwd": fa._FWD_ENTRY, "bwd": fa._BWD_ENTRY}
        for route in ab:
            late[f"ab_{route}_route"] = _vit_route_ab(step, model, batch, run,
                                                      tables[route])
        return late

    out = _vision_train("train vit_b16", model, opt, batch, warmup=2,
                        timed=8, profile=True, flops=flops, extra=extra,
                        after=routed_and_ab)
    if not all(p == want for p in out["launches"]):
        raise PhaseError(f"train vit_b16: launches per step "
                         f"{out['launches']}, want {want}")
    return {**out, "launches_total": {
        k: sum(p[k] for p in out["launches"]) for k in want}}


def phase_vgg16(seed: int) -> dict:
    """BASELINE config 4: VGG-16 (138 M parameters, most in the classifier),
    batch 64 at 224, bf16, ``SGD(0.01, momentum=0.9)``; the gradients'
    fusion buckets and allreduce bytes per step."""
    import torch

    from horovod_tpu_torch import basics
    from horovod_tpu_torch.models.vgg import VGG16
    from horovod_tpu_torch.ops.fusion import plan_buckets

    basics.init()
    torch.backends.cudnn.benchmark = True
    model = VGG16(dtype=torch.bfloat16, device=DEV, seed=seed,
                  dropout_seed=seed)
    params = list(model.parameters())
    threshold = basics.config().fusion_threshold_bytes
    extra = {"fusion_threshold_bytes": threshold,
             "fusion_buckets_per_step": len(plan_buckets(params, threshold)),
             "allreduce_bytes_per_step": sum(p.numel() * p.element_size()
                                             for p in params)}
    opt = torch.optim.SGD(params, lr=0.01, momentum=0.9)
    out = _vision_train("train vgg16", model, opt, _vision_batch(seed + 7, 224),
                        warmup=1, timed=2, profile=False, flops=None,
                        extra=extra)
    return out


def phase_inception_v3(seed: int) -> dict:
    """Inception V3, batch 64 at 299 × 299, bf16, ``SGD(0.01,
    momentum=0.9)``."""
    import torch

    from horovod_tpu_torch import basics
    from horovod_tpu_torch.models.inception import InceptionV3

    basics.init()
    torch.backends.cudnn.benchmark = True
    model = InceptionV3(dtype=torch.bfloat16, device=DEV, seed=seed)
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    out = _vision_train("train inception_v3", model, opt,
                        _vision_batch(seed + 8, 299), warmup=1, timed=2,
                        profile=False, flops=None, extra={"image_size": 299})
    return out


# -- compressed and alternative reductions ----------------------------------

# The synthetic benchmark twin's defaults (the reference's
# pytorch_synthetic_benchmark.py): ResNet-50, batch 32 a card at 224.
COMPRESSED_BATCH = 32
COMPRESSED_IMAGE = 224
COMPRESSED_ROUTES = ("none", "int8", "int4", "powersgd", "ef-topk",
                     "is_sparse", "adasum")
# PowerSGD: approximation + residual against M, relative; P̂'s live columns
# against the identity.
POWERSGD_SUM_RTOL = 1e-5
POWERSGD_ORTHO_TOL = 1e-4
# Error feedback around top-k: reduced + residual against the corrected
# gradient, relative to its largest magnitude (f32 rounding of one add).
EF_SUM_RTOL = 1e-6


def _route_options(route: str) -> dict:
    """``DistributedOptimizer`` keywords of each route, the synthetic
    benchmark twin's mapping (``--compression``, ``--adasum``) plus the
    fork's ``is_sparse``."""
    from horovod_tpu_torch.examples.synthetic_benchmark import compressor
    from horovod_tpu_torch.ops.collective_ops import Adasum

    if route == "is_sparse":
        return {"is_sparse": True, "sparse_ratio": 0.01}
    if route == "adasum":
        return {"op": Adasum}
    return {"compression": compressor(route)}


def _host(x):
    """A CPU copy of a tensor or of a compressor state entry."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return type(x)(*(_host(t) for t in x))


def _topk_agree(card_idx, cpu_idx, mag) -> bool:
    """The same top-k on the card and on the CPU: the same indices, or,
    where |x| ties at the k-th magnitude, the same indices above it and as
    many at it."""
    a, b = set(card_idx.tolist()), set(cpu_idx.tolist())
    if a == b:
        return True
    kth = mag[cpu_idx].min()
    return len(a) == len(b) and all(bool(mag[i] == kth) for i in a ^ b)


def _check_topk(comp, corrected, reduced, residual) -> dict:
    """Per leaf: at most k non-zeros, the card's selection equal to the
    CPU's, the picked entries sent as they are, and (with a residual)
    reduced + residual = corrected."""
    import torch

    ok = {"at_most_k": True, "same_indices": True, "picked_values": True,
          "sum_to_corrected": True}
    ties = 0
    for i, c in enumerate(corrected):
        flat, red = c.reshape(-1), reduced[i].reshape(-1)
        k = comp._k_for(flat.numel())
        cpu_idx = comp.select(flat)
        card_idx = comp.select(flat.to(DEV)).cpu()
        ok["at_most_k"] &= int((red != 0).sum()) <= k
        same = _topk_agree(card_idx, cpu_idx, flat.abs())
        ties += int(same and set(card_idx.tolist()) != set(cpu_idx.tolist()))
        ok["same_indices"] &= same
        ok["picked_values"] &= bool(torch.equal(red[card_idx],
                                                flat[card_idx]))
        if residual is not None:
            err = (red + residual[i].reshape(-1) - flat).abs().max()
            ok["sum_to_corrected"] &= bool(
                err <= EF_SUM_RTOL * flat.abs().max())
    return {"checks": ok, "leaves_with_boundary_ties": ties}


def _check_quantized(cls, grads, reduced, threshold) -> dict:
    """Per fusion bucket (the blocks follow its boundaries): the reduced
    gradient equals ``roundtrip`` of the CPU copy bit for bit, the card's
    codes and scales equal the CPU's, and every element lies within one
    step (block max-abs / LEVELS) of the gradient."""
    import torch

    from horovod_tpu_torch.ops.fusion import plan_buckets

    ok = {"roundtrip_bit_equal": True, "codes_bit_equal": True,
          "within_one_step": True}
    plan = plan_buckets(grads, threshold)
    for bucket in plan:
        flat = torch.cat([grads[i].reshape(-1) for i in bucket])
        red = torch.cat([reduced[i].reshape(-1) for i in bucket])
        ok["roundtrip_bit_equal"] &= bool(torch.equal(red,
                                                      cls.roundtrip(flat)))
        codes, scale, n = cls._block_quantize(flat)
        ccodes, cscale, _ = cls._block_quantize(flat.to(DEV))
        ok["codes_bit_equal"] &= bool(torch.equal(codes, ccodes.cpu())
                                      and torch.equal(scale, cscale.cpu()))
        pad = scale.shape[0] * cls.BLOCK - n
        err = torch.nn.functional.pad((red - flat).abs(), (0, pad))
        ok["within_one_step"] &= bool(
            (err.reshape(scale.shape[0], -1) <= scale).all())
    return {"checks": ok, "fusion_buckets": len(plan)}


def _check_powersgd(grads, reduced, before, after) -> dict:
    """Per compressed leaf: approximation + residual = M (relative), P̂'s
    live columns orthonormal (P̂ from the card, and from the CPU on the
    same M and Q); dense leaves reduced as they are."""
    import torch

    from horovod_tpu_torch.ops.powersgd import (_orthonormalize,
                                                _PowerSGDLeafState)

    ok = {"approx_plus_residual": True, "p_hat_orthonormal": True,
          "dense_leaves_exact": True}
    worst = {"sum_rel": 0.0, "ortho": 0.0, "p_hat_card_vs_cpu": 0.0}
    compressed = 0
    for g, red, st0, st1 in zip(grads, reduced, before, after):
        if not isinstance(st0, _PowerSGDLeafState):
            ok["dense_leaves_exact"] &= bool(torch.equal(red, g))
            continue
        compressed += 1
        n, m = st0.residual.shape
        mat = g.reshape(n, m) + st0.residual
        rel = float((red.reshape(n, m) + st1.residual - mat).norm()
                    / mat.norm().clamp(min=1e-30))
        p_hat = _orthonormalize(mat.to(DEV) @ st0.q.to(DEV)).cpu()
        live = p_hat.norm(dim=0) > 0.5
        gram = p_hat[:, live].T @ p_hat[:, live]
        ortho = float((gram - torch.eye(int(live.sum()))).abs().amax()
                      ) if live.any() else 0.0
        cpu_p = _orthonormalize(mat @ st0.q)
        worst["sum_rel"] = max(worst["sum_rel"], rel)
        worst["ortho"] = max(worst["ortho"], ortho)
        worst["p_hat_card_vs_cpu"] = max(worst["p_hat_card_vs_cpu"], float(
            (p_hat - cpu_p).abs().max()))
        ok["approx_plus_residual"] &= rel <= POWERSGD_SUM_RTOL
        ok["p_hat_orthonormal"] &= ortho <= POWERSGD_ORTHO_TOL
    return {"checks": ok, "compressed_leaves": compressed, "worst": worst}


def _checkpoint_round_trip(model, opt, route: str, make_model) -> dict:
    """``save_checkpoint`` of (model, optimizer) under ``$TMPDIR`` and
    ``restore_checkpoint`` into fresh ones: parameters, BN statistics,
    momentum and the compressor's state equal bit for bit."""
    import shutil
    import tempfile

    import torch

    from horovod_tpu_torch.checkpoint import (restore_checkpoint,
                                              save_checkpoint)
    from horovod_tpu_torch.optim.distributed_optimizer import \
        DistributedOptimizer

    tmp = tempfile.mkdtemp(prefix="hvd_ckpt_")
    try:
        path = save_checkpoint(tmp, (model, opt), step=0)
        model2 = make_model()
        opt2 = DistributedOptimizer(
            torch.optim.SGD(model2.parameters(), lr=0.01, momentum=0.9),
            **_route_options(route))
        restore_checkpoint(path, (model2, opt2))
        same = all(torch.equal(a, b) for a, b in zip(
            model.state_dict().values(), model2.state_dict().values()))
        mom = all(torch.equal(opt.state[p]["momentum_buffer"],
                              opt2.state[q]["momentum_buffer"])
                  for p, q in zip(model.parameters(), model2.parameters()))
        comp = all(torch.equal(a, b) for s, t in zip(opt.comp_state,
                                                     opt2.comp_state)
                   for a, b in zip(*((x,) if isinstance(x, torch.Tensor)
                                     else tuple(x) for x in (s, t))))
        return {"checkpoint_params_bit_equal": same,
                "checkpoint_momentum_bit_equal": mom,
                "checkpoint_powersgd_state_bit_equal": comp}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _compressed_route(route, model, init, batch, *, timed: int) -> dict:
    """One route: a warm-up step, a checked step (its gradients copied to
    the host before the reduction, the reduction held against the same
    functions on that copy), ``timed`` steps through ``make_train_step``
    and one step whose reduction runs under ``torch.profiler``."""
    import torch

    from horovod_tpu_torch import basics
    from horovod_tpu_torch.ops.compression import Int4Compressor, \
        Int8Compressor, TopKCompressor
    from horovod_tpu_torch.optim.distributed_optimizer import (
        DistributedOptimizer, make_train_step)

    model.load_state_dict(init)
    params = list(model.parameters())
    opt = DistributedOptimizer(
        torch.optim.SGD(params, lr=0.01, momentum=0.9),
        **_route_options(route))
    step = make_train_step(_cross_entropy, opt)
    losses = [float(step(model, batch).loss)]                 # warm-up

    loss = _cross_entropy(model, batch)
    loss.backward()
    grads = [_host(p.grad).float() for p in params]
    before = [_host(s) for s in opt.comp_state] if opt.stateful else None
    opt.synchronize()
    reduced = [_host(p.grad) for p in params]
    after = [_host(s) for s in opt.comp_state] if opt.stateful else None
    opt.step()
    opt.zero_grad()
    losses.append(float(loss.detach()))
    if route in ("int8", "int4"):
        cls = Int8Compressor if route == "int8" else Int4Compressor
        check = _check_quantized(cls, grads, reduced,
                                 basics.config().fusion_threshold_bytes)
    elif route == "ef-topk":
        corrected = [g + e for g, e in zip(grads, before)]
        check = _check_topk(opt.compression.inner, corrected, reduced, after)
    elif route == "is_sparse":
        check = _check_topk(TopKCompressor(ratio=opt.sparse_ratio), grads,
                            reduced, None)
    elif route == "powersgd":
        check = _check_powersgd(grads, reduced, before, after)
    else:   # none, adasum: a world of one reduces to the input itself
        check = {"checks": {"output_is_input": all(
            torch.equal(r, g) for r, g in zip(reduced, grads))}}
    del grads, reduced, before, after

    seconds = []
    for _ in range(timed):
        t0 = time.perf_counter()
        losses.append(float(step(model, batch).loss))         # synchronises
        seconds.append(time.perf_counter() - t0)

    loss = _cross_entropy(model, batch)
    loss.backward()
    sync()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        opt.synchronize()
        sync()
        wall = time.perf_counter() - t0
    opt.step()
    opt.zero_grad()
    losses.append(float(loss.detach()))
    prof_out = _device_breakdown(prof, wall)
    step_s = statistics.median(seconds)
    out = {"route": route, "losses": losses, "step_seconds": seconds,
           "step_s": step_s, "images_per_s": COMPRESSED_BATCH / step_s,
           "reduce_launches": prof_out["kernels"],
           "reduce_device_ms": sum(prof_out["ms_by_kind"].values()),
           "reduce_wall_ms": prof_out["wall_ms"],
           "reduce_device_idle_share": prof_out["device_idle_share"],
           "reduce_top_kernels": prof_out["top_kernels"][:5],
           **{k: v for k, v in check.items() if k != "checks"}}
    checks = {**check["checks"],
              "finite": all(map(math.isfinite, losses)),
              "decreasing": losses[-1] < losses[0]}
    if route == "powersgd":
        from horovod_tpu_torch.models.resnet import ResNet50

        checks.update(_checkpoint_round_trip(
            model, opt, route,
            lambda: ResNet50(dtype=torch.bfloat16, device=DEV)))
    out["checks"] = checks
    return out


def phase_train_compressed(seed: int, timed: int = 4) -> dict:
    """The synthetic benchmark twin's model at full width (ResNet-50, batch
    32 at 224, bf16 compute with f32 parameters, ``SGD(0.01,
    momentum=0.9)``, NCCL with a world of one), through each reduction
    route in turn, each from the same weights on the same repeated batch."""
    import torch

    from horovod_tpu_torch import basics
    from horovod_tpu_torch.data import synthetic_imagenet, to_device
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.optim.distributed_optimizer import \
        broadcast_parameters

    basics.init()
    torch.backends.cudnn.benchmark = True
    model = ResNet50(dtype=torch.bfloat16, device=DEV, seed=seed)
    broadcast_parameters(model)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    images, labels = synthetic_imagenet(COMPRESSED_BATCH, COMPRESSED_IMAGE,
                                        seed=seed + 9)
    batch = (to_device(images, DEV), to_device(labels, DEV))
    params = list(model.parameters())
    routes = [_compressed_route(r, model, init, batch, timed=timed)
              for r in COMPRESSED_ROUTES]
    out = {"model": "ResNet-50", "batch": COMPRESSED_BATCH,
           "image_size": COMPRESSED_IMAGE, "world_size": basics.size(),
           "params": sum(p.numel() for p in params), "leaves": len(params),
           "gradient_bytes": sum(p.numel() * 4 for p in params),
           "routes": routes,
           "checks": {f"{r['route']}.{k}": v for r in routes
                      for k, v in r["checks"].items()}}
    out["ok"] = all(out["checks"].values())
    emit("train compressed", **out)
    if not out["ok"]:
        raise PhaseError("train compressed failed its checks: "
                         f"{[k for k, v in out['checks'].items() if not v]}")
    return out


def phase_fit_mnist(seed: int) -> dict:
    """BASELINE config 1 through ``fit``: ``MnistConvNet`` on two epochs of
    ``synthetic_mnist`` (4096), ``ShardedLoader`` (32 a rank), SGD(0.01·size,
    momentum 0.9) behind ``DistributedOptimizer``, and the broadcast,
    metric-average, warm-up and checkpoint callbacks (``step_<epoch>``
    under ``$TMPDIR``); then ``latest_checkpoint``, ``restore_checkpoint``
    into fresh objects (bit for bit) and ``load_model`` (its wrapper holds
    the given optimizer, restored bit for bit)."""
    import shutil
    import tempfile

    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch import basics, callbacks, checkpoint
    from horovod_tpu_torch.data import ShardedLoader, synthetic_mnist
    from horovod_tpu_torch.models.mnist import MnistConvNet
    from horovod_tpu_torch.optim.distributed_optimizer import \
        DistributedOptimizer
    from horovod_tpu_torch.training import fit

    basics.init()
    model = MnistConvNet(device=DEV, seed=seed)
    images, labels = synthetic_mnist(4096, seed=seed)
    loader = ShardedLoader((images, labels), 32, seed=1, device=DEV)
    lr = 0.01 * basics.size()

    def sgd(m):
        return torch.optim.SGD(m.parameters(), lr=lr, momentum=0.9)

    opt = DistributedOptimizer(sgd(model))

    def loss_fn(model, batch):
        x, y = batch
        return F.cross_entropy(model(x), y)

    ckpt_dir = tempfile.mkdtemp(prefix="hvd_mnist_ckpt_")
    cbs = [callbacks.BroadcastGlobalVariablesCallback(0),
           callbacks.MetricAverageCallback(),
           callbacks.LearningRateWarmupCallback(lr, warmup_epochs=1),
           callbacks.ModelCheckpointCallback(ckpt_dir, async_save=True)]
    try:
        t0 = time.perf_counter()
        _, _, history = fit(model, opt, loss_fn, loader, epochs=2,
                            callbacks=cbs, verbose=False)
        sync()
        seconds = time.perf_counter() - t0
        checkpoint.wait_for_checkpoints()
        latest = checkpoint.latest_checkpoint(ckpt_dir)
        model2 = MnistConvNet(device=DEV, seed=seed + 1)
        opt2 = DistributedOptimizer(sgd(model2))
        checkpoint.restore_checkpoint(latest, (model2, opt2))
        model3 = MnistConvNet(device=DEV, seed=seed + 2)
        sgd3 = sgd(model3)
        _, opt3 = checkpoint.load_model(latest, sgd3, template=(model3, sgd3))
        ckpt = {
            "checkpoints": sorted(os.listdir(ckpt_dir)),
            "latest": os.path.basename(latest or ""),
            "params_bit_equal": all(torch.equal(a, b) for a, b in zip(
                model.state_dict().values(), model2.state_dict().values())),
            "momentum_bit_equal": all(torch.equal(
                opt.state[p]["momentum_buffer"],
                opt2.state[q]["momentum_buffer"]) for p, q in zip(
                    model.parameters(), model2.parameters())),
            "load_model_wraps": isinstance(opt3, DistributedOptimizer)
                                and opt3.optimizer is sgd3,
            "load_model_params_bit_equal": all(torch.equal(a, b) for a, b in
                                               zip(model.state_dict().values(),
                                                   model3.state_dict().values())),
            "load_model_momentum_bit_equal": all(torch.equal(
                opt.state[p]["momentum_buffer"],
                opt3.state[q]["momentum_buffer"]) for p, q in zip(
                    model.parameters(), model3.parameters()))}
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    losses = [h["loss"] for h in history]
    out = {"epochs": 2, "samples": 4096, "batch_per_rank": 32,
           "steps_per_epoch": len(loader), "world_size": basics.size(),
           "history": history, "fit_seconds": seconds,
           "images_per_s": 2 * 4096 / seconds, "checkpoint": ckpt,
           "checks": {"finite": all(map(math.isfinite, losses)),
                      "decreasing": losses[-1] < losses[0],
                      "checkpoint_per_epoch": ckpt["checkpoints"] == [
                          "step_0", "step_1"],
                      "latest_is_last_epoch": ckpt["latest"] == "step_1",
                      "restore_params_bit_equal": ckpt["params_bit_equal"],
                      "restore_momentum_bit_equal":
                          ckpt["momentum_bit_equal"],
                      "load_model_wraps": ckpt["load_model_wraps"],
                      "load_model_params_bit_equal":
                          ckpt["load_model_params_bit_equal"],
                      "load_model_momentum_bit_equal":
                          ckpt["load_model_momentum_bit_equal"]}}
    out["ok"] = all(out["checks"].values())
    emit("fit mnist", **out)
    if not out["ok"]:
        raise PhaseError(f"fit mnist failed its checks: {out['checks']}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-layers", type=int, default=32,
                    help="model depth (32 = Llama-3-8B); widths never change")
    ap.add_argument("--train-layers", type=int, default=8,
                    help="depth of the train phase (full width; 8 fits "
                         "f32 weights, gradients and AdamW moments in 80 GB)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--vit-ab", action="append", default=[],
                    choices=("fwd", "bwd"),
                    help="after the ViT-B/16 phase, time its step with this "
                         "route (the forward or the backward pair) on the "
                         "mma.sync kernels and on the routed ones, in turns; "
                         "may be given twice")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import horovod_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 2
    phase = "device"
    try:
        info = phase_device()
        phase = "build"
        build = phase_build()
        phase = "kernel flash_fwd"
        kern = phase_kernel(args.seed)
        phase = "kernel flash_bwd"
        kern_bwd = phase_kernel_bwd(args.seed)
        phase = "kernel d64"
        kern64 = phase_kernel_d64(args.seed)
        phase = "serve generate"
        if args.n_layers != 32:
            emit("depth cut", path="serve", n_layers=args.n_layers, of=32)
        cfg, params = _model(args.n_layers, args.seed)
        gen = phase_generate(cfg, params, args.seed)
        phase = "serve batcher"
        bat = phase_batcher(cfg, params, args.seed)
        del params
        torch.cuda.empty_cache()
        phase = "train"
        emit("depth cut", path="train", n_layers=args.train_layers, of=32)
        train = phase_train(args.train_layers, args.seed)
        torch.cuda.empty_cache()
        phase = "train resnet101"
        phase_resnet101(args.seed)
        phase = "train vit_b16"
        vit = phase_vit_b16(args.seed, tuple(args.vit_ab))
        phase = "train vgg16"
        phase_vgg16(args.seed)
        phase = "train inception_v3"
        phase_inception_v3(args.seed)
        phase = "train compressed"
        phase_train_compressed(args.seed)
        phase = "fit mnist"
        phase_fit_mnist(args.seed)
    except Exception as e:  # every failure ends the run without a result
        emit(phase, ok=False, error=f"{type(e).__name__}: {e}")
        print(f"chip_smoke: phase {phase!r} failed", file=sys.stderr)
        traceback.print_exc()
        return 1
    finally:    # the phases share one process group, as a user's run does
        from horovod_tpu_torch import basics

        basics.shutdown()
    print(json.dumps({"kernels": _kernel_rows(build, kern, kern_bwd, gen, bat,
                                              train, kern64, vit)}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["name"], "count": info["count"]}}),
        flush=True)
    return 0


def _ptx(build, kernel: str) -> dict:
    """Registers and spill bytes of ``kernel`` (its largest instantiation)
    and ptxas's warnings about it (C7512, C7519, C7520: serialized wgmma)
    from the build's ``-Xptxas -v`` report."""
    found = [v for k, v in build["kernels"].items() if kernel in k]
    out = {key: max((p.get(key, 0) for p in found), default=None)
           for key in ("registers", "spill_bytes")}
    out["ptxas_warnings"] = sum(len(p["warnings"]) for p in found)
    return out


def _kernel_rows(build, kern, kern_bwd, gen, bat, train, kern64,
                 vit) -> list[dict]:
    """One row per kernel and head dim: its launches on the main paths
    (D = 128: serving's generate and batcher, the Llama train steps; D =
    64: the ViT-B/16 train steps), its largest error over the bf16 cases
    and its times at its main shape (the generate prefill for the forward,
    the Llama training shape for the backward pair, the ViT-B/16 shape at
    D = 64).  ``ms`` is device time; ``prev_ms`` the earlier mma.sync kernel
    (same run, same inputs); with the build's registers, spills and ptxas
    warnings and the Hopper kernels' shared memory a block.  The forward's
    row adds the same times at the training shape."""
    from horovod_tpu_torch.parallel import flash_attention as fa

    fwd = kern["cases"][0]
    trn = next(c for c in kern["cases"] if c["case"] == TRAIN_SHAPE[0])
    bwd = kern_bwd["cases"][0]["times"]
    src = "horovod_tpu/parallel/flash_attention.py"
    times = ("ms", "wall_ms", "host_us_per_call", "prev_ms", "plain_ms",
             "library_ms", "bound_ms", "tflops", "share_of_bound")
    rows = [{
        "name": "flash_fwd", "route": "cuda", "design": "cuda wgmma+tma",
        "source": "horovod_tpu_torch/csrc/flash_fwd.cu",
        "replaces": f"{src}:62",
        "launches": (gen["launches"] + bat["launches"]
                     + train["launches"]["flash_fwd"]),
        "max_abs_err": max(c["o_max_abs_err"] for c in kern["cases"]
                           if c["dtype"] == "bf16"),
        "ms": fwd["ms"], "wall_ms": fwd["wall_ms"],
        "host_us_per_call": fwd["host_us_per_call"],
        "prev_ms": fwd["prev_ms"],
        "prev_host_us_per_call": fwd["prev_host_us_per_call"],
        "speedup_vs_prev": fwd["speedup_vs_prev"], "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
        "share_of_bound": fwd["share_of_bound"],
        "library_ms": fwd["library_ms"],
        **_ptx(build, "flash_fwd_wgmma_kernel"),
        "smem_bytes": fa.smem_bytes("flash_fwd", "hvd_flash_fwd"),
        "train_shape": {k: trn[k] for k in times},
    }]
    for name, key, line, grads, kernel, entry in (
            ("flash_bwd_dq", "dq", 188, ("dq",), BWD_KERNELS[0],
             "hvd_flash_bwd_dq"),
            ("flash_bwd_dkv", "dkv", 229, ("dk", "dv"), BWD_KERNELS[1],
             "hvd_flash_bwd_dkv")):
        t = bwd[key]
        rows.append({
            "name": name, "route": "cuda", "design": "cuda wgmma+tma",
            "source": "horovod_tpu_torch/csrc/flash_bwd.cu",
            "replaces": f"{src}:{line}",
            "launches": train["launches"][name],
            "max_abs_err": max(c[f"{g}_max_abs_err"] for c in kern_bwd["cases"]
                               for g in grads if c["dtype"] == "bf16"),
            **{k: t[k] for k in ("ms", "wall_ms", "host_us_per_call",
                                 "prev_ms", "prev_host_us_per_call",
                                 "speedup_vs_prev", "plain_ms", "bound_ms",
                                 "bound_by", "tflops", "share_of_bound")},
            # The backward pair's yardstick (SDPA's backward), on both rows.
            "library_ms": bwd["library_ms"],
            **_ptx(build, kernel),
            "smem_bytes": fa.smem_bytes("flash_bwd", entry),
        })
    # D = 64, timed at the ViT-B/16 shape: the kernels the bf16 entries
    # route to (design, ptxas report and source from the route taken).
    import torch

    vfwd = next(c for c in kern64["fwd"] if "ms" in c)
    vbwd = next(c for c in kern64["bwd"] if "times" in c)["times"]
    keys = ("ms", "wall_ms", "host_us_per_call", "plain_ms", "bound_ms",
            "bound_by", "tflops", "share_of_bound")
    prev_keys = ("prev_ms", "prev_host_us_per_call", "speedup_vs_prev")
    dq_entry, dkv_entry = fa._BWD_ENTRY[torch.bfloat16, 64]
    for name, entry, line, grads, t, lib in (
            ("flash_fwd_d64", fa._FWD_ENTRY[torch.bfloat16, 64], 62, ("o",),
             vfwd, vfwd["library_ms"]),
            ("flash_bwd_dq_d64", dq_entry, 188, ("dq",), vbwd["dq"],
             vbwd["library_ms"]),
            ("flash_bwd_dkv_d64", dkv_entry, 229, ("dk", "dv"), vbwd["dkv"],
             vbwd["library_ms"])):
        kernel, instance, design = _ENTRY_KERNELS[entry]
        cases = kern64["fwd"] if grads == ("o",) else kern64["bwd"]
        row = {
            "name": name, "route": "cuda", "design": design, "entry": entry,
            "source": f"horovod_tpu_torch/csrc/{fa._LIBRARY[entry]}.cu",
            "replaces": f"{src}:{line}",
            "head_dim": 64, "shape": VIT_SHAPE[0],
            "launches": vit["launches_total"][name.removesuffix("_d64")],
            "max_abs_err": max(c[f"{g}_max_abs_err"] for c in cases
                               for g in grads if c["dtype"] == "bf16"),
            **{k: t[k] for k in keys}, "library_ms": lib,
            **{k: t[k] for k in prev_keys if k in t},
            **_ptx(build, kernel + instance),
        }
        if design == "cuda wgmma+tma":
            row["smem_bytes"] = fa.smem_bytes(fa._LIBRARY[entry], entry)
        rows.append(row)
    return rows


if __name__ == "__main__":
    sys.exit(main())
