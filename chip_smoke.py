#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``horovod_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--n-layers N] [--train-layers N] [--seed S]
                          [--vit-ab {fwd,bwd}]

Phases, one JSON line each; any failure exits non-zero before the result:

1. ``device``: requires CUDA; prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them, and on a line of its own whether ``import keras`` works (in a
   child process, ``KERAS_BACKEND=torch``) and its version.
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
   ``examples`` (on the same weights): the example twins a user runs
   first.  ``llama_generate`` (``horovod_tpu_torch/examples/``) with the
   JAX script's defaults (batch 2, prompt 8, 32 new tokens), greedy: one
   D = 128 forward launch per layer a prefill, the prefill's first kernel
   call held against its plain version on the same tensors (L = 8: the
   tail tile alone) and timed, decode tokens/s, tokens in the vocabulary
   (the twin calls ``llama.generate``; its tokens against the dense
   route's are ``serve generate``'s check); sampled (``--top-k 40 --top-p
   0.9``, temperature 0.8): every token among ``torch.topk``'s 40 of the
   logits it was drawn from.  Every number beside the card's name and
   power limit.  (The twins that train, ``examples train``, run after
   ``fit mnist``.)
6. ``serve batcher``: a 512-token shared prefix (``precompute_prefix``,
   through the kernel) and a ``ContinuousBatcher`` answering eight
   requests; first tokens are held against solo ``generate``.
   ``serve speculative``: ``speculative_generate`` on generate's prompts,
   32 new tokens, four drafts a round, with a random draft of
   Llama-3.2-1B's widths (its prefill launches the D = 64 forward at 32/8
   heads, causal, once per layer) and with the target as its own draft;
   rounds, acceptance, tokens/s against ``generate`` at the same budget,
   first tokens equal to generate's, every token greedy-consistent (its
   logit within ``MARGIN_RTOL`` of the largest at its position in one
   target pass over prompt + output).  ``serve engine``: ``ServeEngine``
   (8 slots of 2048 positions, 256-token windows and blocks) over 16
   requests on a shared 512-token prefix, run four times in one process:
   FIFO, ``prefix_cache=True``, an overcommitted pool of 25 blocks with
   ``preempt_after=2``, and ``spec=True``; budgets exact, every token
   greedy-consistent, one argument signature per program, the block walk
   after every step, prefix hits, preemptions and proposals seen, paged
   logits equal to dense ones bit for bit; served tokens/s, TTFT and TPOT,
   the tick's phase shares, the memory report, and one profiled tick at
   eight slots beside one profiled ``generate`` decode step at B = 4.  The
   FIFO run also has device telemetry on and writes a port ``Timeline``
   (parsed back: counters and ``phase/*`` spans); then the measurement
   planes off, on, on, off on the FIFO requests ("on": device telemetry,
   a sampler at 0.05 s, the alert rules, the exporter on a free port with
   ``/metrics``, ``/snapshot`` and ``/device`` scraped once while it
   serves, every request traced): tokens and signatures equal on and off,
   tick and chunk FLOPs equal to the analytic count, ``serve.mfu`` in
   (0, 1) and equal to the window's FLOPs / s / peak, the HBM gauges equal
   to the allocator's, every tick's sync split summing to its wait, one
   span tree a request; served tokens/s off and on (medians of two).
   ``serve router`` (the fleet's front door, on the same weights): two
   ``LocalReplica`` engines of the engine's configuration (prefix cache
   on, the first with device telemetry) share one ``params`` behind a
   ``RouterServer`` on 127.0.0.1 with ``prefix_affinity``; 16 requests in
   four shared-prefix families a wave go through the HTTP door at once,
   and a solo ``ServeEngine`` serves the same waves, in turns (solo,
   fleet; fleet, solo): tokens equal bit for bit, fleet and solo tokens/s.
   Then the ``serve.router`` fault kills replica 0 mid-wave (tokens equal,
   ``router.failovers`` ≥ 1), ``ReplicaSupervisor`` respawns it with
   ``clone_engine`` (the same weight tensors, one more KV pool of memory)
   and the clone serves a further wave; a journaled router
   (``HVD_TORCH_ROUTER_JOURNAL`` under ``$TMPDIR``) stopped mid-flight is
   replayed by a new one with equal tokens, and a repeated idempotency key
   is answered from the journal; last ``measure_router_fleet`` (affinity's
   hit rate above round robin's).  ``route_decision_s`` and the journal
   append time p50/p99, the fleet ``/device`` summary before and after the
   respawn, the phase's peak memory, and the flash launches of the fleet's
   own waves, counted from 0 around each wave: none, because the engine's
   paged programs attend with plain einsums, as the reference's do.
   ``serve throughput`` (the same weights): ``measure_throughput``,
   ``measure_prefix_throughput`` and ``measure_spec_throughput`` on 16
   requests in four 128-token families (8 slots × 512, 256-token windows,
   128-token blocks): serve against static (fixed batches of ``generate``)
   and speculative against plain tokens request for request, equal or
   first split at a near-tie of the target (within 2 % of max|logit|)
   and greedy-consistent after it; every plane's overhead finite (recorded,
   unresolved), ``serve_mfu`` in (0, 1); the static baseline's D = 128
   forward launches exactly 32 × 2 batches × 2 passes, the engines' none.
   ``serve load``: ``measure_saturation`` through the HTTP door of two
   replicas (16 slots × 128), a probe rung, then a ladder of 0.5, 1, 2 and
   4 × the probe's served rate, each rung long enough to hold 20 arrivals;
   each rung's schedule digest equal to the rebuilt schedule's, every
   request answered, attribution coverage 1, the knee below the top rung,
   the top rung's p99 TTFT above the bottom's, an advisor with no
   ``load_report=`` reading the knee from ``serve_load_report.json`` under
   ``HVD_TORCH_BENCH_CACHE``.  ``serve chaos``: ``run_campaign`` on three
   replicas with the alert oracle, ``run_autoscale_campaign``,
   ``measure_autoscale_goodput``; every oracle, ≥ 1 respawn, each respawn
   or grow sharing the weights, holding one KV pool of its own within 1 %
   and moving the allocator by one pool within 25 %.  ``fleet simfleet`` (host only, after the
   serving phases): ``run_sim_campaign`` at 200 replicas × 100,000
   requests, every oracle and the reference's counts, wall seconds
   recorded.
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
   Then, at the same width cut to 4 of 32 layers (the same batch), on the
   same world of one: ``train sequence_parallel``: the ``ulysses_flash``
   logits (two all-to-alls around the flash kernels) bit for bit against
   ``flash``, the ``ring`` logits against the blockwise engine with one
   block (bit-equality recorded, within ``LOGIT_RTOL``), then one remat
   training step of each from the same weights: loss and every gradient
   bit for bit, 8 forward, 4 dQ and 4 dK/dV launches a step.  ``train
   zero`` and ``train fsdp``: three AdamW steps (clip 1.0) of
   ``make_zero_train_step`` and of ``make_fsdp_train_step`` from the
   same weights as three of the replicated ``DistributedOptimizer``
   route (its parameters after each step kept on the host): each step's
   loss and every leaf within ``PARAM_RTOL`` (bit-equality recorded),
   the launches as above, step seconds and peak memory of each route.
   ``train pipeline_moe``: a 1-stage ``pipeline_forward`` of a
   Llama-width SwiGLU block against the stage run microbatch by
   microbatch (bit for bit; the loss's gradients within
   ``BF16_GRAD_RTOL``), and ``expert_parallel_mlp`` against
   ``moe.forward`` at ``MoEConfig``'s own widths, 4,096 bf16 tokens, with
   gradients.

8. ``kernel d64`` (run right after ``kernel flash_bwd``): the three
   kernels at head dim 64, the ViT's (the Hopper D = 64 kernels for
   bf16/f16, the ``mma.sync`` kernels for f32): the ViT-B/16 shape (B=64,
   L=196, 12 heads, non-causal) in bf16, f16 and f32, a causal case and
   tails, and the draft model's prefill shape (B=4, L=1024, 32/8 heads,
   causal), each held against its plain version; at the ViT shape and the
   draft shape the times, bounds, ``prev_ms`` and SDPA.
   ``kernel batch_norm`` (after ``kernel d64``): the fused batch-norm
   kernels at ResNet-50's 53 batch-256 norms against their plain
   arithmetic (y, the statistics and running statistics, dx, dγ, dβ and
   d_residual, at the card tests' tolerances), and their device time a
   step against the bytes bound, ATen's ``F.batch_norm`` and the unfused
   chain.
9. ``train resnet101`` (``bench.py _bench_resnet``): ResNet-101 at full
   depth, batch 64 at 224 × 224 from ``synthetic_imagenet``, bf16 compute
   with f32 parameters and BN, ``SGD(0.01, momentum=0.9)`` through
   ``basics.init``, ``broadcast_parameters``, ``broadcast_optimizer_state``,
   ``DistributedOptimizer`` and ``make_train_step``: two warm-up steps,
   eight timed, one profiled; images/s and the model-FLOP share (FLOP from
   ``torch.utils.flop_counter``); losses finite and falling, BN running
   statistics moved, each norm one launch of each fused batch-norm kernel
   a step.
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
    64, one warm-up and two timed steps each; Inception's norms each one
    launch of each fused batch-norm kernel a step.
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
13. ``train eager`` (run right after ``train vit_b16``): Horovod's engine
    and PyTorch API (``ops/eager.py``, ``torch_frontend.py``) on NCCL at a
    world of one.  The module API with the native controller on (built
    from ``native/src`` with ``g++`` beside the kernels, ``local:``
    transport): every async collective (allreduce Sum/Average/Min/Max/
    Product, fp16/bf16, grouped, allgather, broadcast, alltoall,
    reducescatter, sparse, the frontend's in-place allreduce) equal bit for
    bit to the synchronous API's on 16 MiB inputs, ``poll`` turning true
    first, ``barrier`` and ``join``; two timelines parsed back with the
    engine's phases: the one ``HOROVOD_TIMELINE`` opens at ``init`` over
    the allreduces, then (``stop_timeline``, ``start_timeline`` with a
    ``profiler_dir``) one over the rest, and the ``torch.profiler`` trace
    ``stop_timeline`` wrote beside it holding CUDA kernels; an autotune
    window and its log row.  Then ResNet-101 and ViT-B/16 (as phases 9-10) under the
    hook-driven ``torch_frontend.DistributedOptimizer`` and the synchronous
    one: from the same weights the parameters after one step are equal
    bit for bit (cuDNN held to deterministic algorithms, a second
    synchronous step as the control); then off, sync, hook, hook, sync,
    off runs of 2 warm-up, 8 timed and 1 profiled steps (images/s,
    kernels, busy ms, idle share, the engine's buckets a step; ``off`` is
    the synchronous route with the engine shut down, ``sync`` with it
    alive), ViT's launching each D = 64 kernel 12 times a step; last, each
    route's host time split into forward, backward (with the hooks),
    synchronize, step and the wait for the card, with the hooks', the
    engine enqueue's and the cycle thread's flushes' own time.
    ``train elastic`` (right after ``train eager``): ViT-B/16 as phase
    10 under the hook-driven ``DistributedOptimizer`` inside
    ``elastic.run`` with a ``TorchState``, 8 steps committing every 2:
    once uninterrupted (in-memory commits), once with durable commits
    under ``$TMPDIR`` and the live engine's shutdown flag set before step
    5, so that the step's first gradient hook raises
    ``HorovodInternalError``; ``run`` reinitialises NCCL at a world of
    one, restores the step-4 commit and replays.  The parameters and the
    optimizer state end bit-equal to the uninterrupted run's (cuDNN held
    to deterministic algorithms), and a fresh ``TorchState`` over fresh
    objects restores the durable commit after a full ``shutdown()`` and
    ``init()``; commit bytes and seconds, restore and reinit seconds.
    ``train hierarchical``: ``HOROVOD_HIERARCHICAL_ALLREDUCE=1`` at a
    world of one warns and reduces exactly as the flat route (the
    two-level route needs two ranks, and NCCL refuses two on one card).
14. ``fit mnist`` (BASELINE config 1): ``MnistConvNet`` through ``fit``,
    ``ShardedLoader`` over ``synthetic_mnist`` and the broadcast,
    metric-average, warm-up and checkpoint callbacks, two epochs; the loss
    must fall, a checkpoint lands per epoch under ``$TMPDIR``,
    ``latest_checkpoint`` finds the last, ``restore_checkpoint`` into fresh
    objects equals the trained state bit for bit, and ``load_model``
    returns a ``DistributedOptimizer`` around the optimizer it was given,
    which holds the trained momentum bit for bit.  ``examples train``
    (after it): the twins ``pytorch_imagenet_resnet50 --smoke
    --fp16-allreduce`` and ``word2vec --sparse`` (20 steps), each in a
    world of one it starts and shuts down (NCCL).  ResNet-50 runs only:
    two epochs and their checkpoints, finite metrics.  word2vec trains
    from seeded numpy tables on the card and again on the CPU (gloo): the
    card's losses within ``W2V_CPU_RTOL`` of the CPU's.
15. ``serve tp`` (after ``serve chaos``, with the serving weights freed):
    tensor-parallel serving of Llama-3-8B at full width and depth, bf16, in
    a world of two processes on the one card over gloo (NCCL refuses two
    ranks on one GPU; the tensors stay on the card, gloo stages each
    collective through the host), each rank building the weights from the
    seed and keeping its Megatron shard: first gloo's ``all_reduce`` and
    ``all_gather_into_tensor`` of card tensors against known results,
    then ``measure_tp_throughput(tp_sizes=(1, 2), keep_tokens=True)`` on 8
    requests of 128 tokens, budgets 16 (4 slots × 512, 128-token windows
    and blocks), a tp = 2 engine behind a ``LocalReplica`` (its probe's
    ``tp_size`` 2, its tokens equal to the sweep's), one argument signature
    a program, ``kv.shard_*`` × 2 = ``kv.*`` for every gauge; the tp = 2
    tokens against tp = 1's (equal, or a first split at a near-tie and
    greedy-consistent after it) and every tp = 2 token greedy-consistent
    in one target pass (the flash prefill: 32 launches a request); tokens/s
    of both (two processes time-sharing one card: not a scaling figure),
    the shard bytes, the leader's peak memory and the phase's seconds.
16. ``train keras`` (last): the Keras 3 frontend on its torch backend, when
    ``import keras`` works here (the device phase reports it on a line of
    its own): ``examples/keras_mnist_advanced.py``'s twin for 2 epochs on
    the card with the four callbacks, the weights card tensors that moved,
    a ``load_model`` round trip; else the phase prints its skip.

The training phases share one process group, shut down after the last.
Then a ``{"kernels": [...]}`` line (each flash kernel at head dims 128 and
64, and the fused batch-norm kernels) and, last, the result line ``{"ok": true, "device": {...}}``.  A failed
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
START = time.perf_counter()

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
# Where an engine's greedy tokens and a baseline's first part, the target's
# logits for the two competing tokens must lie this close (a share of the
# largest |logit|): a near-tie that two batch shapes rounded apart.  The
# largest such gap seen on the card was 1.47 %.
DIVERGE_RTOL = 2e-2


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
    """One JSON line, stamped with the seconds since the script started."""
    print(json.dumps({"phase": phase, **fields,
                      "at_s": time.perf_counter() - START}), flush=True)


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
    info["keras"] = _keras_probe()
    emit("keras", **info["keras"])
    return info


def phase_build() -> None:
    from horovod_tpu_torch import _build

    t0 = time.perf_counter()
    controller = _build.start_controller_build()    # g++ beside the nvccs
    _build.build_all()
    controller = _build.build_controller(controller)
    seconds = time.perf_counter() - t0
    ptxas = [ln.strip() for log in _build.build_logs.values()
             for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "entry function" in ln
             or _ptxas_warning(ln)]
    emit("build", ok=True, seconds=seconds, sources=_build.sources(),
         controller=controller.name, ptxas=ptxas)
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
# The draft model's prefill in serve speculative: Llama-3.2-1B's 32 query
# heads over 8 KV heads of 64, causal, generate's four prompts padded to
# 1024.
DRAFT_HEADS = (32, 8, 64)
DRAFT_PREFILL_SHAPE = ("causal_b4_l1024_gqa32x8", 4, 1024, True)


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

    names = {torch.bfloat16: "bf16", torch.float16: "f16",
             torch.float32: "f32"}
    cases = [(*VIT_SHAPE, torch.bfloat16), (*VIT_SHAPE, torch.float16),
             (*VIT_SHAPE, torch.float32),
             ("causal_b2_l333", 2, 333, True, torch.bfloat16),
             ("noncausal_b2_l1", 2, 1, False, torch.bfloat16),
             ("noncausal_b2_l63", 2, 63, False, torch.bfloat16),
             ("causal_b2_l65", 2, 65, True, torch.float16),
             ("noncausal_b1_l1000", 1, 1000, False, torch.bfloat16),
             (*DRAFT_PREFILL_SHAPE, torch.bfloat16)]
    gen = torch.Generator(device=DEV).manual_seed(seed + 4)
    fwd_rows, bwd_rows = [], []
    for name, b, l, causal, dtype in cases:
        H, KVH, D = (DRAFT_HEADS if name == DRAFT_PREFILL_SHAPE[0]
                     else VIT_HEADS)
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
        if frow["ok"] and name == DRAFT_PREFILL_SHAPE[0]:
            frow["times"] = _time_forward(q, k, v, b, l, causal, 64, tname,
                                          heads=DRAFT_HEADS)
        fwd_rows.append(frow)
        bwd_rows.append(brow)
        emit("kernel flash_fwd d64", **frow)
        emit("kernel flash_bwd d64", **brow)
        del q, k, v, do, o, lse, delta, dq, dk_h, dv_h, o_ref, lse_ref, refs
        if not (frow["ok"] and brow["ok"]):
            raise PhaseError(f"the D = 64 kernels disagree with their plain "
                             f"versions on {name} {tname}")
    return {"fwd": fwd_rows, "bwd": bwd_rows}


# The batch-norm kernels against their plain arithmetic in bf16, as the
# card tests hold them (tests/test_torch_batch_norm_act.py): y and dx one
# bf16 rounding apart (rtol 2^-7; dx's atol scaled by its largest
# magnitude), the statistics and running statistics to f32 sums' last
# bits, dγ and dβ to 1e-4 of their largest.
BN_Y_ATOL, BN_Y_RTOL = 1e-3, 2 ** -7
BN_STATS_ATOL, BN_STATS_RTOL = 1e-6, 2e-5
BN_DPARAM_ATOL, BN_DPARAM_RTOL = 1e-4, 1e-4
BN_COUNTERS = ("stats_launches", "apply_launches", "bwd_reduce_launches",
               "bwd_elemt_launches")


def _max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def _excess(got, want, rtol: float) -> float:
    """The largest |got − want| − rtol·|want|: at most the atol where the
    two agree."""
    want = want.float()
    return float(((got.float() - want).abs() - rtol * want.abs()).max())


def _bn_launches_reset() -> None:
    from horovod_tpu_torch.ops import batch_norm as bn

    for k in BN_COUNTERS:
        setattr(bn, k, 0)


def _bn_launches(model, steps: int) -> dict:
    """The fused batch-norm kernels' launches since
    :func:`_bn_launches_reset`, and whether each of ``model``'s norms
    launched each kernel once a step (every norm of the vision models runs
    in train mode with local statistics)."""
    from horovod_tpu_torch.models.layers import BatchNorm
    from horovod_tpu_torch.ops import batch_norm as bn

    norms = sum(isinstance(m, BatchNorm) for m in model.modules())
    got = {k: getattr(bn, k) for k in BN_COUNTERS}
    return {"bn_norms": norms, "bn_launches": got,
            "checks": {"bn_kernels_every_norm": all(
                v == norms * steps for v in got.values())}}


def resnet50_norms(batch: int = 256) -> list[tuple]:
    """ResNet-50's 53 train-mode batch norms at ``batch`` (224² input) as
    (N, C, H, W, relu, residual, count): the stem, each block's three
    (the first at the block's input size; the last with the residual add)
    and the downsample path's, equal shapes merged."""
    seen: dict[tuple, int] = {}

    def add(c, h, relu, residual):
        key = (batch, c, h, h, relu, residual)
        seen[key] = seen.get(key, 0) + 1

    add(64, 112, True, False)
    size = 56
    for i, blocks in enumerate((3, 4, 6, 3)):
        f = 64 * 2 ** i
        for j in range(blocks):
            first = j == 0
            h_in, h = (size, size // 2) if first and i > 0 else (size, size)
            add(f, h_in, True, False)
            add(f, h, True, False)
            add(4 * f, h, True, True)
            if first:
                add(4 * f, h, False, False)
            size = h
    return [(*key, n) for key, n in seen.items()]


def phase_kernel_batch_norm(seed: int) -> dict:
    """The fused batch-norm kernels (``csrc/batch_norm.cu``) at ResNet-50's
    batch-256 shapes in bf16: each case's largest error against the plain
    arithmetic (``_forward_reference``, ``_backward_reference``), and, summed
    over the 53 norms of a step, device ms of the kernels (forward: the
    statistics and apply kernels; backward: reduce and element-wise), of the
    plain arithmetic, of ATen's ``F.batch_norm`` forward and backward
    (``library_ms``: the yardstick; the port never calls it on this path)
    and of the chain the model ran before (``F.batch_norm`` with the
    running-variance fold, the add and the ReLU, forward and backward);
    the bytes bound (each input read once, each output written once), the
    bytes the kernels move (x read twice forward; dy, x and the mask's y
    twice backward), and the wrapper's host µs a call."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import batch_norm as bn

    gen = torch.Generator(device=DEV).manual_seed(seed + 20)
    cl = torch.channels_last
    total = {k: 0.0 for k in ("kernel_fwd_ms", "kernel_bwd_ms",
                              "plain_fwd_ms", "plain_bwd_ms", "library_ms",
                              "chain_ms", "bound_ms", "moved_gb",
                              "host_fwd_us", "host_bwd_us")}
    rows = []
    for n, c, h, w, relu, res, count in resnet50_norms():
        shape = (n, c, h, w)
        x = (1 + torch.randn(shape, generator=gen, device=DEV)).to(
            torch.bfloat16).contiguous(memory_format=cl)
        r = (torch.randn(shape, generator=gen, device=DEV).to(
            torch.bfloat16).contiguous(memory_format=cl) if res else None)
        dy = torch.randn(shape, generator=gen, device=DEV).to(
            torch.bfloat16).contiguous(memory_format=cl)
        wt = 1 + 0.1 * torch.randn(c, generator=gen, device=DEV)
        bs = 0.1 * torch.randn(c, generator=gen, device=DEV)
        rm, rv = torch.zeros(c, device=DEV), torch.ones(c, device=DEV)
        args = (wt, bs, r, rm, rv, 0.9, 1e-5, relu)
        got_rm, got_rv, want_rm, want_rv = rm.clone(), rv.clone(), \
            rm.clone(), rv.clone()
        y, stats = bn._forward_cuda(x, wt, bs, r, got_rm, got_rv, 0.9, 1e-5,
                                    relu)
        y_ref, stats_ref = bn._forward_reference(x, wt, bs, r, want_rm,
                                                 want_rv, 0.9, 1e-5, relu)
        got = bn._backward_cuda(dy, x, y_ref, wt, stats_ref, relu, res)
        want = bn._backward_reference(dy, x, y_ref, wt, stats_ref, relu, res)
        sync()
        row = {"shape": list(shape), "relu": relu, "residual": res,
               "count": count,
               "y_max_abs_err": _max_err(y, y_ref),
               "y_excess": _excess(y, y_ref, BN_Y_RTOL),
               "stats_excess": _excess(stats, stats_ref, BN_STATS_RTOL),
               "running_excess": max(
                   _excess(got_rm, want_rm, BN_STATS_RTOL),
                   _excess(got_rv, want_rv, BN_STATS_RTOL)),
               "dx_max_abs_err": _max_err(got[0], want[0]),
               "dx_excess": _excess(got[0], want[0], BN_Y_RTOL),
               "dx_max_abs": float(want[0].float().abs().max()),
               "dparam_excess": max(_excess(g, w, BN_DPARAM_RTOL)
                                    - BN_DPARAM_RTOL * float(w.abs().max())
                                    for g, w in zip(got[1:3], want[1:3])),
               "dres_equal": (torch.equal(got[3], want[3]) if res
                              else got[3] is None)}
        row["ok"] = (bool(torch.isfinite(y.float()).all())
                     and row["y_excess"] <= BN_Y_ATOL
                     and row["stats_excess"] <= BN_STATS_ATOL
                     and row["running_excess"] <= BN_STATS_ATOL
                     and row["dx_excess"] <= BN_Y_ATOL * row["dx_max_abs"]
                     and row["dparam_excess"] <= BN_DPARAM_ATOL
                     and row["dres_equal"])
        if not row["ok"]:
            emit("kernel batch_norm", **row)
            raise PhaseError(f"the batch-norm kernels disagree with their "
                             f"plain arithmetic at {shape}")
        xg = x.detach().requires_grad_()
        wg, bg = wt.clone().requires_grad_(), bs.clone().requires_grad_()

        def library():
            out = F.batch_norm(xg, rm, rv, wg, bg, True, 0.1, 1e-5)
            torch.autograd.grad(out, (xg, wg, bg), dy)

        rg = None if r is None else r.detach().requires_grad_()

        def chain():
            out = bn.batch_norm_act_plain(xg, wg, bg, rm, rv, momentum=0.9,
                                          eps=1e-5, relu=relu, residual=rg)
            torch.autograd.grad(out, [t for t in (xg, wg, bg, rg)
                                      if t is not None], dy)

        elem = x.numel()
        reads = 1 + (1 if res else 0)
        bound = 2 * elem * (reads + 1)                       # forward
        bound += 2 * elem * (2 + (1 if relu else 0) + 1
                             + (1 if res and relu else 0))   # backward
        moved = 2 * elem * (reads + 2)
        moved += 2 * elem * (2 * (2 + (1 if relu else 0)) + 1
                             + (1 if res and relu else 0))
        times = {
            "kernel_fwd_ms": device_ms(lambda: bn._forward_cuda(x, *args))[0],
            "kernel_bwd_ms": device_ms(lambda: bn._backward_cuda(
                dy, x, y, wt, stats, relu, res))[0],
            "plain_fwd_ms": device_ms(
                lambda: bn._forward_reference(x, *args), n=5)[0],
            "plain_bwd_ms": device_ms(lambda: bn._backward_reference(
                dy, x, y, wt, stats, relu, res), n=5)[0],
            "library_ms": device_ms(library)[0],
            "chain_ms": device_ms(chain)[0],
            "host_fwd_us": host_us(lambda: bn._forward_cuda(x, *args)),
            "host_bwd_us": host_us(lambda: bn._backward_cuda(
                dy, x, y, wt, stats, relu, res))}
        row.update(times, bound_ms=bound / PEAK_BYTES * 1e3,
                   moved_gb=moved / 1e9)
        row["kernel_tb_per_s"] = moved / 1e9 / (
            times["kernel_fwd_ms"] + times["kernel_bwd_ms"])
        for k in total:
            total[k] += row[k] * count
        rows.append(row)
        emit("kernel batch_norm", **row)
        del x, r, dy, y, y_ref, got, want, xg, rg
    total["kernel_ms"] = total["kernel_fwd_ms"] + total["kernel_bwd_ms"]
    total["kernel_tb_per_s"] = total["moved_gb"] / total["kernel_ms"]
    total["bound_pct"] = 100 * total["bound_ms"] / total["kernel_ms"]
    out = {"norms": sum(r["count"] for r in rows), "per_step": total}
    emit("kernel batch_norm step", **out)
    return {**out, "cases": rows}


def _model(n_layers: int, seed: int):
    import torch

    from horovod_tpu_torch.models import llama

    cfg = llama.llama3_8b(attn_impl="flash", n_layers=n_layers,
                          param_dtype=torch.bfloat16)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    params = llama.init_params(cfg, gen, device=DEV)
    return cfg, params


# serve generate's (and serve speculative's) four ragged prompts, padded
# to 1024
GEN_LENGTHS = [300, 517, 777, 1024]


def _generate_prompt(cfg, seed: int):
    """serve generate's prompts from ``seed``: ([4, 1024] tokens, lengths)
    on the card."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    prompt = np.zeros((len(GEN_LENGTHS), 1024), np.int64)
    for r, n in enumerate(GEN_LENGTHS):
        prompt[r, :n] = rng.randint(0, cfg.vocab_size, n)
    return (torch.as_tensor(prompt, device=DEV),
            torch.as_tensor(GEN_LENGTHS, device=DEV))


def phase_generate(cfg, params, seed: int) -> dict:
    import torch

    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.parallel import flash_attention as fa

    b, width, n_new = 4, 1024, 16
    lengths = GEN_LENGTHS
    prompt_t, lengths_t = _generate_prompt(cfg, seed)

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


# The example twins' runs in ``examples``: llama_generate's JAX-script
# defaults, and the sampled run's filter.
EXAMPLE_GEN = {"batch": 2, "prompt_len": 8, "max_new_tokens": 32}
EXAMPLE_SAMPLE = {"temperature": 0.8, "top_k": 40, "top_p": 0.9}
EXAMPLE_W2V_STEPS = 20
# word2vec's losses on the card against the CPU's from the same tables and
# batches: f32 both, apart only in summation order (the 128-wide dot
# products, the loss's mean) and in any near-tie at the sparse top-k's cut.
W2V_CPU_RTOL = 1e-4


def _captured_check(call: dict) -> dict:
    """The captured forward call against the plain version on the same
    tensors, at the kernel's tiles; then timed (``_time_forward``)."""
    import torch

    from horovod_tpu_torch.parallel import flash_attention as fa

    q, k, v, kw = call["q"], call["k"], call["v"], call["kw"]
    tname = {torch.bfloat16: "bf16", torch.float16: "f16",
             torch.float32: "f32"}[q.dtype]
    blk = 64 if q.dtype == torch.float32 else 128
    o_ref, lse_ref = fa._flash_forward_reference(q, k, v, block_q=blk,
                                                 block_k=blk, **kw)
    diff = (call["o"].float() - o_ref.float()).abs()
    atol, rtol = O_TOL[tname]
    excess = float((diff - rtol * o_ref.float().abs()).max())
    lse_err = float((call["lse"] - lse_ref).abs().max())
    bh, l, d = q.shape
    h, kvh = kw["n_heads"], kw["n_kv_heads"]
    out = {"shape": [bh // h, l, h, kvh, d], "dtype": tname,
           "causal": kw["causal"], "entry": fa._FWD_ENTRY[q.dtype, d],
           "o_max_abs_err": float(diff.max()), "o_tol": f"{atol} + {rtol}*|o|",
           "o_excess_over_tol": excess, "lse_max_abs_err": lse_err,
           "ok": excess <= atol and lse_err <= LSE_TOL}
    if out["ok"]:
        out["times"] = _time_forward(q, k, v, bh // h, l, kw["causal"], blk,
                                     tname, heads=(h, kvh, d))
    return out


def phase_examples(cfg, params, card: str) -> dict:
    """The ``llama_generate`` twin on the card (see the module's
    docstring)."""
    import torch

    from horovod_tpu_torch.examples import llama_generate
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.parallel import flash_attention as fa

    t_phase = time.perf_counter()
    out: dict = {"card": card, "n_layers": cfg.n_layers, **EXAMPLE_GEN}

    # llama_generate, greedy: two generate calls (warm-up, timed), one
    # prefill each; the first kernel call captured.
    captured: list = []
    real = fa._flash_forward_cuda

    def spy(q, k, v, **kw):
        o, lse = real(q, k, v, **kw)
        if not captured:
            captured.append({"q": q.clone(), "k": k.clone(), "v": v.clone(),
                             "kw": kw, "o": o.clone(), "lse": lse.clone()})
        return o, lse

    _flash_zero()
    fa._flash_forward_cuda = spy
    try:
        greedy = llama_generate.run(params, cfg, verbose=False,
                                    **EXAMPLE_GEN)
    finally:
        fa._flash_forward_cuda = real
    launches = fa.fwd_launches_by_dim[128]
    out["greedy"] = {"seconds": greedy["seconds"],
                     "decode_tokens_per_s": greedy["tokens_per_s"],
                     "flash_fwd_d128_launches": launches,
                     "prefills": 2,
                     "launches_per_prefill": launches / 2}
    out["greedy"]["in_vocab"] = bool(
        ((greedy["tokens"] >= 0) & (greedy["tokens"] < cfg.vocab_size))
        .all())
    out["kernel_call"] = _captured_check(captured[0]) if captured else {
        "ok": False}

    # llama_generate, sampled: every draw checked against its logits.
    draws: list = []
    real_sample = llama.sample_logits

    def record(logits, generator, **kw):
        tok = real_sample(logits, generator, **kw)
        draws.append((logits, tok))
        return tok

    _flash_zero()
    llama.sample_logits = record
    try:
        sampled = llama_generate.run(params, cfg, verbose=False,
                                     **EXAMPLE_GEN, **EXAMPLE_SAMPLE)
    finally:
        llama.sample_logits = real_sample
    timed = draws[len(draws) // 2:]
    in_topk = 0
    for logits, tok in timed:
        top = torch.topk(logits, EXAMPLE_SAMPLE["top_k"], dim=-1).indices
        in_topk += int((top == tok[:, None]).any(-1).sum())
    n_drawn = sum(int(t.numel()) for _, t in timed)
    out["sampled"] = {**EXAMPLE_SAMPLE, "seconds": sampled["seconds"],
                      "decode_tokens_per_s": sampled["tokens_per_s"],
                      "tokens_checked": n_drawn, "in_top_k": in_topk,
                      "flash_fwd_d128_launches": fa.fwd_launches_by_dim[128],
                      "steps": len(timed)}
    del draws, timed, captured

    out["launches"] = (out["greedy"]["flash_fwd_d128_launches"]
                       + out["sampled"]["flash_fwd_d128_launches"])
    out["phase_s"] = time.perf_counter() - t_phase
    g, smp = out["greedy"], out["sampled"]
    checks = {
        "launches_one_per_layer_a_prefill": (
            g["flash_fwd_d128_launches"] == 2 * cfg.n_layers
            and smp["flash_fwd_d128_launches"] == 2 * cfg.n_layers),
        "tokens_in_vocab": g["in_vocab"],
        "kernel_call_vs_plain": out["kernel_call"]["ok"],
        "sampled_in_top_k": (n_drawn == EXAMPLE_GEN["batch"]
                             * EXAMPLE_GEN["max_new_tokens"]
                             and in_topk == n_drawn),
    }
    out["checks"] = checks
    out["ok"] = all(checks.values())
    emit("examples", **out)
    if not out["ok"]:
        raise PhaseError("examples failed its checks: " + ", ".join(
            k for k, v in checks.items() if not v))
    return out


def phase_examples_train(card: str, seed: int) -> dict:
    """The ResNet-50 twin (``--smoke --fp16-allreduce``) and word2vec
    (``--sparse``), each a world of one on NCCL that it starts and shuts
    down: after the train phases, so that every serving phase runs, as
    before, in a process that has not yet started NCCL.  ResNet-50 runs
    only; word2vec runs again on the CPU from the same tables."""
    import tempfile

    import numpy as np

    from horovod_tpu_torch import basics
    from horovod_tpu_torch.examples import pytorch_imagenet_resnet50
    from horovod_tpu_torch.examples import word2vec

    t_phase = time.perf_counter()
    out: dict = {"card": card}
    with tempfile.TemporaryDirectory(prefix="hvd-examples-") as d:
        t0 = time.perf_counter()
        hist = pytorch_imagenet_resnet50.main(
            ["--smoke", "--fp16-allreduce", "--checkpoint-dir", d])
        out["resnet50"] = {
            "seconds": time.perf_counter() - t0, "history": hist,
            "checkpoints": sorted(os.listdir(d)),
            "finite": all(np.isfinite(list(r.values())).all()
                          for r in hist)}
    # The tables from numpy (the twin's own draw takes the device's
    # generator, which differs between the card and the CPU).
    argv = ["--steps", str(EXAMPLE_W2V_STEPS), "--sparse"]
    dims = word2vec.parse(argv)
    rng = np.random.default_rng(seed)
    tables = (rng.standard_normal((dims.vocab, dims.dim), np.float32)
              * np.float32(0.05), np.zeros((dims.vocab, dims.dim),
                                           np.float32))
    runs = {}
    for where, extra in (("card", []), ("cpu", ["--device", "cpu"])):
        t0 = time.perf_counter()
        try:
            runs[where] = word2vec.run(word2vec.parse(argv + extra), tables)
        finally:
            basics.shutdown()
        runs[where + "_s"] = time.perf_counter() - t0
    losses, cpu = np.asarray(runs["card"]), np.asarray(runs["cpu"])
    out["word2vec"] = {"seconds": runs["card_s"], "cpu_seconds": runs["cpu_s"],
                       "steps": len(losses), "first_loss": losses[0],
                       "last_loss": losses[-1],
                       "max_rel_diff_vs_cpu": float(
                           np.max(np.abs(losses - cpu) / np.abs(cpu))),
                       "rtol": W2V_CPU_RTOL}
    out["phase_s"] = time.perf_counter() - t_phase
    checks = {
        "resnet50_two_epochs_finite": (
            out["resnet50"]["finite"] and len(hist) == 2
            and out["resnet50"]["checkpoints"] == ["checkpoint-1.pt",
                                                   "checkpoint-2.pt"]),
        "word2vec_card_equals_cpu": (
            len(losses) == len(cpu) == EXAMPLE_W2V_STEPS
            and out["word2vec"]["max_rel_diff_vs_cpu"] <= W2V_CPU_RTOL),
    }
    out["checks"] = checks
    out["ok"] = all(checks.values())
    emit("examples train", **out)
    if not out["ok"]:
        raise PhaseError("examples train failed its checks: " + ", ".join(
            k for k, v in checks.items() if not v))
    return out


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


# serve speculative: generate's prompts, 32 new tokens, four drafts a round,
# a cache deep enough for the verify overshoot (1024 + 32 + 4 + 1).
SPEC_NEW, SPEC_K = 32, 4
SPEC_MAX_LEN = 1024 + SPEC_NEW + SPEC_K + 1


def _draft_1b(seed: int):
    """A random bf16 draft with Llama-3.2-1B's published widths (dim 2048,
    16 layers, 32 query heads over 8 KV heads of 64, FFN 8192, the Llama-3
    vocabulary and RoPE base); its RoPE scaling and tied embeddings are
    left out, as ``LlamaConfig`` expresses neither."""
    import torch

    from horovod_tpu_torch.models import llama

    cfg = llama.llama3_8b(dim=2048, n_layers=16, n_heads=32, n_kv_heads=8,
                          ffn_dim=8192, attn_impl="flash",
                          param_dtype=torch.bfloat16)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    return cfg, llama.init_params(cfg, gen, device=DEV)


def _greedy_consistency(params, cfg, prompts, outputs) -> dict:
    """Each emitted token against one target pass over prompt +
    output[:-1] (``forward``, the flash prefill path): its logit must be
    within ``MARGIN_RTOL`` · max|logit| of that position's largest logit,
    the target's greedy choice up to a bf16 near-tie, without asking two
    batch shapes to round alike.  ``worst`` is the largest gap seen, as a
    share of its position's max|logit|."""
    import torch

    from horovod_tpu_torch.models import llama

    checked = passed = 0
    worst = 0.0
    seen = set()
    for prompt, out in zip(prompts, outputs):
        key = (tuple(prompt), tuple(out))
        if key in seen:
            continue
        seen.add(key)
        toks = torch.as_tensor([list(prompt) + list(out[:-1])], device=DEV)
        with torch.no_grad():
            hidden = llama.forward(params, toks, cfg, return_hidden=True)
            logits = (hidden[0, len(prompt) - 1:]
                      @ params["lm_head"].to(cfg.dtype)).float()
        picked = logits[torch.arange(len(out), device=DEV),
                        torch.as_tensor(list(out), device=DEV)]
        gap = (logits.max(dim=-1).values - picked) / logits.abs().amax(-1)
        checked += len(out)
        passed += int((gap <= MARGIN_RTOL).sum())
        worst = max(worst, float(gap.max()))
    return {"tokens_checked": checked, "tokens_passed": passed,
            "worst_gap_share": worst, "margin_rtol": MARGIN_RTOL,
            "ok": checked > 0 and passed == checked}


def phase_speculative(cfg, params, seed: int) -> dict:
    """``speculative_generate`` on generate's four ragged prompts, 32 new
    tokens, four drafts a round: with (i) a random draft of Llama-3.2-1B's
    widths, whose prefill runs the D = 64 forward at 32/8 heads, causal,
    and (ii) the target as its own draft (the accept-all path).  Held
    against ``generate`` at the same budget in the same process."""
    import numpy as np
    import torch

    from horovod_tpu_torch import serving
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.parallel import flash_attention as fa

    prompt_t, lengths_t = _generate_prompt(cfg, seed)
    prompts = [prompt_t[r, :n].tolist() for r, n in enumerate(GEN_LENGTHS)]
    b = len(prompts)
    sync()
    t0 = time.perf_counter()
    want = llama.generate(params, prompt_t, cfg, max_new_tokens=SPEC_NEW,
                          prompt_lengths=lengths_t)
    sync()
    t_gen = time.perf_counter() - t0
    want = want.cpu().numpy()

    dcfg, dparams = _draft_1b(seed + 7)
    dense = dataclasses.replace(dcfg, attn_impl="dense")
    logits_f, _ = llama.prefill(dparams, prompt_t, dcfg,
                                llama.init_cache(dcfg, b, 1024, device=DEV),
                                lengths=lengths_t)
    logits_d, _ = llama.prefill(dparams, prompt_t, dense,
                                llama.init_cache(dense, b, 1024, device=DEV),
                                lengths=lengths_t)
    scale = float(logits_d.abs().max())
    err = float((logits_f - logits_d).abs().max())
    del logits_f, logits_d

    out = {"B": b, "prompt_lengths": GEN_LENGTHS, "new_tokens": SPEC_NEW,
           "draft_k": SPEC_K, "max_len": SPEC_MAX_LEN,
           "n_layers": cfg.n_layers, "generate_s": t_gen,
           "generate_tokens_per_s": b * SPEC_NEW / t_gen,
           "draft_prefill_logits_max_abs_diff_flash_vs_dense": err,
           "draft_prefill_logits_max_abs": scale, "logits_rtol": LOGIT_RTOL,
           "drafts": {}}
    ok = err <= LOGIT_RTOL * scale
    launches = {64: 0, 128: 0}
    for name, dc, dp, want_launches in (
            ("llama3.2-1b widths, random", dcfg, dparams,
             {128: cfg.n_layers, 64: dcfg.n_layers}),
            ("the target itself", cfg, params, {128: 2 * cfg.n_layers,
                                                64: 0})):
        stats: dict = {}
        fa.launches = 0
        fa.fwd_launches_by_dim.update({64: 0, 128: 0})
        t0 = time.perf_counter()
        got = serving.speculative_generate(
            params, cfg, dp, dc, prompt_t, max_new_tokens=SPEC_NEW,
            draft_k=SPEC_K, max_len=SPEC_MAX_LEN, prompt_lengths=lengths_t,
            stats=stats)
        sync()
        seconds = time.perf_counter() - t0
        by_dim = dict(fa.fwd_launches_by_dim)
        for d in launches:
            launches[d] += by_dim[d]
        got = got.cpu().numpy()
        acc = np.stack(stats["accepted_per_round"])        # [rounds, B]
        greedy = _greedy_consistency(params, cfg, prompts, got.tolist())
        row = {
            "draft": {"dim": dc.dim, "n_layers": dc.n_layers,
                      "heads": [dc.n_heads, dc.n_kv_heads, dc.head_dim],
                      "ffn_dim": dc.ffn_dim},
            "seconds": seconds, "tokens_per_s": b * SPEC_NEW / seconds,
            "vs_generate": t_gen / seconds, "rounds": stats["rounds"],
            "mean_accepted_per_row_round": float(acc.mean()),
            "rounds_accepting_all_on_every_row": int(
                (acc == SPEC_K).all(axis=1).sum()),
            "max_length_seen": stats["max_length_seen"],
            "flash_launches_by_head_dim": by_dim,
            "expected_launches_by_head_dim": want_launches,
            "first_tokens_equal_generate": bool(
                (got[:, 0] == want[:, 0]).all()),
            "token_agreement_with_generate": float((got == want).mean()),
            "greedy_consistency": greedy,
        }
        row["ok"] = (by_dim == want_launches and greedy["ok"]
                     and row["first_tokens_equal_generate"])
        if dc is cfg:
            row["ok"] = row["ok"] and row[
                "rounds_accepting_all_on_every_row"] >= 1
        out["drafts"][name] = row
        ok = ok and row["ok"]
    out["ok"] = ok
    emit("serve speculative", **out)
    del dparams
    torch.cuda.empty_cache()
    if not ok:
        raise PhaseError("serve speculative failed its checks")
    return {"launches": launches}


# serve engine: the reference's engine defaults at Llama-3-8B width, eight
# slots of 2048 positions, 256-token prefill windows and blocks (65 blocks
# of 32 MiB: 2 × 2 B × 32 layers × 256 × 8 × 128, trash included).
ENGINE = {"n_slots": 8, "max_len": 2048, "chunk": 256}
ENGINE_SUFFIXES = (1, 37, 100, 255, 256, 300, 513, 700)
ENGINE_BUDGETS = (8, 32, 64)


def _engine_requests(cfg, seed: int, *, phrase: bool = False):
    """16 requests: one random 512-token system prefix plus a suffix of
    each length in ``ENGINE_SUFFIXES`` twice (other tokens each time),
    budgets cycling through ``ENGINE_BUDGETS``.  ``phrase``: each suffix
    is a random 64-token phrase and then as much of it again, repeated, so
    the prompt-lookup drafter finds earlier occurrences."""
    import numpy as np

    from horovod_tpu_torch.serving import Request

    rng = np.random.RandomState(seed + 2)
    system = rng.randint(0, cfg.vocab_size, 512).tolist()
    reqs = []
    for i in range(2 * len(ENGINE_SUFFIXES)):
        n = ENGINE_SUFFIXES[i % len(ENGINE_SUFFIXES)]
        if phrase:
            p = rng.randint(0, cfg.vocab_size, 64).tolist()
            suffix = p + (p * (n // 64 + 1))[:n]
        else:
            suffix = rng.randint(0, cfg.vocab_size, n).tolist()
        reqs.append(Request(prompt=system + suffix,
                            max_new_tokens=ENGINE_BUDGETS[i % 3]))
    return reqs


def _profile_call(fn) -> dict:
    """``fn`` once under ``torch.profiler``: kernels, busy and wall ms,
    the device's idle share and the top kernels by device time."""
    import torch

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    bd = _device_breakdown(prof, wall)
    return {k: bd[k] for k in ("kernels", "wall_ms", "device_busy_ms",
                               "device_idle_share", "ms_by_kind",
                               "top_kernels")}


ENGINE_SAMPLE_S = 0.05        # the "on" runs' time-series cadence
PLANES_OFF = {"device_telemetry": False, "sampler": False, "alerts": False,
              "monitor": False}


def _decode_flops_per_token(cfg, positions: int) -> int:
    """One token through Llama at 2 FLOP a multiply-add: q/k/v/o, the
    SwiGLU MLP and the LM head, and attention over ``positions`` keys in
    every layer (the paged programs attend over all ``max_len``)."""
    d, qd = cfg.dim, cfg.n_heads * cfg.head_dim
    kvd = cfg.n_kv_heads * cfg.head_dim
    per_layer = (2 * d * qd + 2 * d * kvd + 3 * d * cfg.ffn_dim
                 + 2 * qd * positions)
    return 2 * (cfg.n_layers * per_layer + d * cfg.vocab_size)


def _live_model_flops(cfg, reqs, results) -> int:
    """The model FLOPs of the tokens a run fed through the model: each
    prompt token and each emitted token but the last, at 2 FLOP a
    multiply-add, attending only to the keys up to its own position.  The
    device plane counts what the programs execute instead: every tick over
    all slots, attention over all ``max_len`` positions, a prompt's last
    chunk at its full width."""
    total = 0
    for q, r in zip(reqs, results):
        for keys in range(1, len(q.prompt) + max(len(r), 1)):
            total += _decode_flops_per_token(cfg, keys)
    return total


def _planes_on(reg) -> dict:
    """Every measurement plane of the engine on: device telemetry, a
    sampler at ``ENGINE_SAMPLE_S``, the alert rules, the exporter on a
    free port of 127.0.0.1 (and, set by the caller, every request
    traced)."""
    from horovod_tpu_torch.alerts import AlertManager
    from horovod_tpu_torch.timeseries import MetricsSampler

    sampler = MetricsSampler(reg, sample_s=ENGINE_SAMPLE_S)
    return {"device_telemetry": True, "sampler": sampler,
            "alerts": AlertManager(sampler, registry=reg), "monitor": 0}


def _scrape(eng, after_steps: int = 10, timeout_s: float = 120.0) -> dict:
    """Once the engine has run ``after_steps`` steps, GET its exporter's
    ``/metrics``, ``/snapshot`` and ``/device`` once each (the caller runs
    this on a thread while the engine serves)."""
    import urllib.request

    t0 = time.monotonic()
    while (eng.step_index < after_steps
           and time.monotonic() - t0 < timeout_s):
        time.sleep(0.005)
    out = {"at_step": eng.step_index}
    base = f"http://{eng.monitor.host}:{eng.monitor.port}"
    for path in ("metrics", "snapshot", "device"):
        with urllib.request.urlopen(f"{base}/{path}", timeout=30) as r:
            out[path] = (r.status, r.read().decode())
    return out


def _device_checks(eng, cfg, dev_rep: dict, snap: dict, reqs,
                   results) -> dict:
    """The device plane against the analytic count, the allocator and its
    own arithmetic: every program counted without error, the tick and
    chunk FLOPs exactly analytic, ``serve.mfu`` in (0, 1) and equal to the
    window's FLOPs / s / peak, the HBM gauges equal to
    ``torch.cuda.memory_allocated`` / ``max_memory_allocated``, and every
    tick's compute estimate plus host stall equal to its sync wait.
    Recorded beside them: the live tokens' model FLOPs and their share of
    the card over the window, when the window holds the whole run."""
    import torch

    from horovod_tpu_torch.device_telemetry import lookup_peak_flops

    dev = eng.device_telemetry
    per_token = _decode_flops_per_token(cfg, ENGINE["max_len"])
    progs = dev_rep["programs"]
    win = dev_rep["win"]
    mfu = snap["gauges"].get("serve.mfu")
    mem = dev.poll_memory() or {"available": False}
    allocated = torch.cuda.memory_allocated()
    peak_alloc = torch.cuda.max_memory_allocated()
    split = max(abs(r["compute_est_s"] + r["host_stall_s"] - r["sync_s"])
                for r in dev._ring)
    out = {
        "peak_flops": dev_rep["peak_flops"],
        "flops": {k: v["flops"] for k, v in progs.items()},
        "bytes_accessed": {k: v["bytes_accessed"] for k, v in progs.items()},
        "analytic_flops": {"tick": ENGINE["n_slots"] * per_token,
                           "chunk": ENGINE["chunk"] * per_token},
        "serve_mfu": mfu, "win": {k: win[k] for k in (
            "n", "elapsed_s", "flops", "flops_per_s", "mfu", "sync_s",
            "compute_est_s", "host_stall_s", "overlap_headroom_pct",
            "arithmetic_intensity", "h2d_bytes", "d2h_bytes",
            "dispatches")},
        "hbm": {**mem, "param_bytes": dev.param_bytes,
                "kv_total_bytes": dev.kv_total_bytes,
                "overhead_bytes": mem.get("bytes_in_use", 0)
                - dev.param_bytes - dev.kv_total_bytes,
                "torch_memory_allocated": allocated,
                "torch_max_memory_allocated": peak_alloc},
        "split_max_abs_err_s": split,
    }
    live = _live_model_flops(cfg, reqs, results)
    whole = win["n"] == dev_rep["ticks"] and win["elapsed_s"] > 0.0
    out["live_model"] = {
        "flops": live, "window_holds_run": whole,
        "executed_over_live": win["flops"] / live if whole else None,
        "model_flops_share": (live / win["elapsed_s"]
                              / dev_rep["peak_flops"]) if whole else None,
        "first_step": ({k: dev._ring[0][k] for k in ("dt_s", "flops")}
                       if whole else None),
    }
    out["checks"] = {
        "captures_without_error": all("error" not in v
                                      for v in progs.values()),
        "tick_flops_analytic": progs["tick"]["flops"]
        == out["analytic_flops"]["tick"],
        "chunk_flops_analytic": progs["chunk"]["flops"]
        == out["analytic_flops"]["chunk"],
        "peak_known": snap["gauges"].get("device.peak_flops_known") == 1
        and dev_rep["peak_flops"] == lookup_peak_flops(
            torch.cuda.get_device_name(0)),
        "mfu_in_0_1": mfu is not None and 0.0 < mfu < 1.0,
        "mfu_is_window_flops_over_peak": mfu is not None and math.isclose(
            mfu, win["flops"] / win["elapsed_s"] / dev_rep["peak_flops"],
            rel_tol=1e-9),
        "hbm_gauges_equal_allocator": mem.get("bytes_in_use") == allocated
        and mem.get("peak_bytes_in_use") == peak_alloc
        and snap["gauges"].get("device.bytes_in_use") is not None,
        "hbm_covers_model": mem.get("bytes_in_use", 0)
        >= dev.param_bytes + dev.kv_total_bytes,
        "sync_split_sums": split <= 1e-9,
    }
    return out


def _engine_run(params, cfg, reqs, *, profile_tick: bool = False,
                planes: str | None = None, timeline_path: str | None = None,
                **kw) -> tuple[dict, list]:
    """Serve ``reqs`` through a fresh ``ServeEngine`` (a registry of its
    own) and return its report and the tokens of each request;
    ``profile_tick`` adds the profiler's phase shares and the memory
    report, then submits eight more requests and profiles one tick with
    all eight slots decoding.  ``planes``: ``"off"`` turns every
    measurement plane off, ``"on"`` turns them all on (``_planes_on``,
    every request traced) and scrapes the exporter once while the engine
    serves; ``None`` keeps the engine's defaults.  ``timeline_path``: a
    port ``Timeline`` written there and parsed back."""
    import gc
    import threading

    import torch

    from horovod_tpu_torch import metrics, tracing
    from horovod_tpu_torch.serving import Request
    from horovod_tpu_torch.serving_scheduler import DECODE, PREFILL, ServeEngine
    from horovod_tpu_torch.timeline import Timeline

    torch.cuda.reset_peak_memory_stats()     # the HBM peak is this run's
    reg = metrics.MetricsRegistry(event_log=None)
    if planes == "on":
        kw.update(_planes_on(reg))
    elif planes == "off":
        kw.update(PLANES_OFF)
    tl = Timeline(timeline_path) if timeline_path else None
    with _env({"HVD_TORCH_TRACE_SAMPLE": "1" if planes == "on" else "0"}):
        eng = ServeEngine(params, cfg, **ENGINE, metrics=reg,
                          profile=profile_tick, timeline=tl, **kw)
    scraped: dict = {}
    scraper = None
    if planes == "on":
        scraper = threading.Thread(
            target=lambda: scraped.update(_scrape(eng)), daemon=True)
        scraper.start()
    sync()
    t0 = time.perf_counter()
    try:
        results = eng.run(reqs)
        sync()
        wall = time.perf_counter() - t0
    finally:
        if scraper is not None:
            scraper.join(timeout=150)
        if eng.monitor is not None:
            eng.monitor.stop()
    dev_rep = (eng.device_telemetry.report()
               if eng.device_telemetry is not None else None)
    snap = eng.metrics_snapshot()
    hist = snap["histograms"]
    sizes = eng.compile_cache_sizes()
    want_sizes = ({"tick": 0, "chunk": 1, "set_row": 1, "spec_tick": 1}
                  if eng.spec else {"tick": 1, "chunk": 1, "set_row": 1})
    tokens = sum(len(r) for r in results)
    out = {
        "options": {k: v if isinstance(v, (bool, int, float, str))
                    else type(v).__name__ for k, v in kw.items()},
        "requests": len(reqs), "tokens": tokens, "steps": eng.step_index,
        "wall_s": wall, "served_tokens_per_s": tokens / wall,
        "ttft_s": {q: hist["serve.ttft_s"][q] for q in ("p50", "p99")},
        "tpot_s": {q: hist["serve.tpot_s"][q] for q in ("p50", "p99")},
        "counters": dict(eng.counters),
        "prefix_counters": dict(eng.prefix_counters),
        "spec_counters": dict(eng.spec_counters),
        "compile_cache_sizes": sizes,
        "retrace": snap["counters"]["serve.retrace"],
        "statuses": sorted({r.status for r in results}),
        "budgets_exact": all(r.status == "OK"
                             and len(r) == q.max_new_tokens
                             for r, q in zip(results, reqs)),
    }
    out["signature_ok"] = sizes == want_sizes and out["retrace"] == 0
    if dev_rep is not None:
        out["device"] = _device_checks(eng, cfg, dev_rep, snap, reqs,
                                       results)
    if planes == "on":
        forest = tracing.build_forest(eng.tracer.recent())
        roots = [r for trees in forest.values() for r in trees]
        metrics_text = scraped.get("metrics", (0, ""))[1]
        snap_scraped = json.loads(scraped.get("snapshot", (0, "{}"))[1])
        out["planes"] = {
            "traces": len(forest), "spans": len(eng.tracer.recent()),
            "scraped_at_step": scraped.get("at_step"),
            "scrape_status": {k: scraped[k][0] for k in
                              ("metrics", "snapshot", "device")
                              if k in scraped},
            "series": len(snap["timeseries"]["tiers"]["raw"]["series"]),
            "samples": snap["counters"].get("ts.samples"),
            "alerts_firing": snap["alerts"]["firing"],
            "alert_evals": snap["counters"].get("alert.evals"),
        }
        out["planes"]["checks"] = {
            "one_tree_a_request": len(forest) == len(reqs)
            and len(roots) == len(reqs)
            and all(r["name"] == "serve.request" and not r["orphan"]
                    and not r["unclosed"] for r in roots),
            "scraped_metrics_hold_serve_mfu": any(
                ln.startswith("serve_mfu ")
                for ln in metrics_text.splitlines()),
            "scraped_snapshot_sections": {"device", "timeseries",
                                          "alerts"} <= set(snap_scraped),
            "scraped_device": scraped.get("device", (0,))[0] == 200,
            "monitor_stopped": eng.monitor._thread is None,
        }
    if profile_tick:
        out["profile_phases_pct"] = {
            p: v["pct_of_tick"] for p, v in snap["profile"]["phases"].items()}
        out["profile_tick_mean_ms"] = snap["profile"]["tick"]["mean_s"] * 1e3
        out["memory_report"] = snap["memory"]
        system = reqs[0].prompt[:512]
        for i in range(ENGINE["n_slots"]):
            eng.submit(Request(prompt=system + [i], max_new_tokens=64))
        while not (all(s.state == DECODE for s in eng._slots)
                   and not any(s.state == PREFILL for s in eng._slots)):
            eng.step()
        eng.step()                    # one warm tick at eight slots
        out["profiled_tick"] = _profile_call(eng.step)
        while eng.pending():
            eng.step()
        if eng.device_telemetry is not None:
            out["nested_sync_phases"] = {
                p: snap["profile"]["phases"][p]["count"]
                for p in ("device_sync.compute_est",
                          "device_sync.host_stall")}
    if tl is not None:
        tl.close()
        out["timeline"] = _engine_timeline_check(timeline_path)
    # the exporter and the engine refer to each other: collect the cycle,
    # or the next run starts with this one's pool still allocated
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out, [list(r) for r in results]


def _engine_timeline_check(path: str) -> dict:
    """The engine's Chrome timeline, parsed back: strict JSON, the
    scheduler's counters (``ph: "C"``) and the profiler's ``phase/*``
    async spans, each ``b`` matched by its ``e``."""
    with open(path) as f:
        events = json.load(f)
    counters = sorted({e["name"] for e in events if e["ph"] == "C"})
    spans = [e for e in events if e["ph"] in ("b", "e")
             and e["name"].startswith("phase/")]
    begins = sorted((e["name"], e["id"]) for e in spans if e["ph"] == "b")
    ends = sorted((e["name"], e["id"]) for e in spans if e["ph"] == "e")
    return {"events": len(events), "counters": counters,
            "phase_spans": len(begins),
            "phases": sorted({n for n, _ in begins}),
            "ok": {"SCHED", "LIFECYCLE"} <= set(counters)
            and len(begins) > 0 and begins == ends
            and events[-1]["name"] == "done"}


def _paged_equals_dense(params, cfg, seed: int) -> dict:
    """One tick at the engine's shape (8 rows, 2048 positions, 256-token
    blocks): a pool whose gathered rows hold a dense cache's values gives
    ``decode_chunk``'s logits bit for bit."""
    import torch

    from horovod_tpu_torch.models import llama

    b, m, bs = ENGINE["n_slots"], ENGINE["max_len"], ENGINE["chunk"]
    per = m // bs
    gen = torch.Generator(device=DEV).manual_seed(seed + 3)
    dense = llama.init_cache(cfg, b, m, device=DEV)
    for t in (dense.k, dense.v):
        for layer in range(cfg.n_layers):
            t[layer].copy_(torch.randn(t[layer].shape, generator=gen,
                                       device=DEV))
    lengths = torch.randint(1, m - 1, (b,), generator=gen, device=DEV)
    paged = llama.init_paged_cache(cfg, b, m, block_size=bs, device=DEV)
    table = (torch.randperm(b * per, generator=gen, device=DEV)
             + 1).view(b, per)
    paged.block_table.copy_(table)
    paged.length.copy_(lengths)
    for r in range(b):
        for j in range(per):
            paged.k[:, table[r, j]] = dense.k[:, r, j * bs:(j + 1) * bs]
            paged.v[:, table[r, j]] = dense.v[:, r, j * bs:(j + 1) * bs]
    dense = dense._replace(length=lengths.clone())
    toks = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen,
                         device=DEV)
    want, _ = llama.decode_chunk(params, toks, cfg, dense)
    got, _ = llama.decode_chunk_paged(params, toks, cfg, paged)
    sync()
    out = {"rows": b, "positions": m, "block_size": bs,
           "logits_bit_equal": bool(torch.equal(got, want)),
           "max_abs_diff": float((got - want).abs().max())}
    del dense, paged
    torch.cuda.empty_cache()
    return out


def phase_engine(cfg, params, seed: int) -> dict:
    """``ServeEngine`` at Llama-3-8B width: four runs of 16 requests in one
    process, (a) FIFO with device telemetry and a port ``Timeline``, (b)
    ``prefix_cache=True``, (c) an overcommitted pool of 25 blocks (three
    full slots and trash) with ``preempt_after=2``, (d) ``spec=True,
    draft_k=4`` on prompts with a repeated phrase; every token held to
    greedy consistency, one argument signature per program, the block walk
    after every step, paged == dense bit for bit, and one profiled tick at
    eight slots beside one profiled ``generate`` decode step at B = 4.
    Then the measurement planes off, on, on, off on (a)'s requests: equal
    tokens and signatures, and the device plane, the spans and the
    exporter checked on each "on" run (``_device_checks``)."""
    import tempfile

    import torch

    from horovod_tpu_torch.models import llama

    tl_path = os.path.join(tempfile.mkdtemp(prefix="hvd_engine_"),
                           "a_fifo_timeline.json")
    os.environ["HVD_TORCH_VERIFY_BLOCKS"] = "1"
    try:
        # warm-up at the tick's shapes on a small pool, outside the runs
        warm = _engine_requests(cfg, seed)[:2]
        for r in warm:
            r.max_new_tokens = 2
        _engine_run(params, cfg, warm, n_blocks=17)
        reqs = _engine_requests(cfg, seed)
        runs = {}
        outputs = {}
        for name, kw in (("a_fifo", {"device_telemetry": True,
                                     "timeline_path": tl_path}),
                         ("b_prefix_cache", {"prefix_cache": True}),
                         ("c_overcommitted", {"n_blocks": 25,
                                              "preempt_after": 2}),
                         ("d_spec", {"spec": True, "draft_k": 4})):
            rq = (_engine_requests(cfg, seed, phrase=True)
                  if name == "d_spec" else reqs)
            runs[name], outputs[name] = _engine_run(
                params, cfg, rq, profile_tick=name == "a_fifo", **kw)
            runs[name]["greedy_consistency"] = _greedy_consistency(
                params, cfg, [r.prompt for r in rq], outputs[name])
            emit("serve engine run", run=name, **runs[name])
    finally:
        os.environ.pop("HVD_TORCH_VERIFY_BLOCKS", None)
    # the measurement planes off and on, in turns, on the FIFO requests
    planes = []
    for turn in ("off", "on", "on", "off"):
        run, toks = _engine_run(params, cfg, reqs, planes=turn)
        planes.append((turn, run, toks))
        emit("serve engine planes", turn=turn, **run)
    paged = _paged_equals_dense(params, cfg, seed)

    prompt_t, lengths_t = _generate_prompt(cfg, seed)
    _, cache = llama.prefill(params, prompt_t, cfg,
                             llama.init_cache(cfg, 4, 1040, device=DEV),
                             lengths=lengths_t)
    tok = torch.zeros(4, dtype=torch.int64, device=DEV)
    llama.decode_step(params, tok, cfg, cache)          # warm
    decode_profile = _profile_call(
        lambda: llama.decode_step(params, tok, cfg, cache))
    del cache
    torch.cuda.empty_cache()

    a, b_, c, d = (runs[k] for k in ("a_fifo", "b_prefix_cache",
                                      "c_overcommitted", "d_spec"))
    checks = {
        "budgets_exact": all(r["budgets_exact"] for r in runs.values()),
        "greedy_consistency": all(r["greedy_consistency"]["ok"]
                                  for r in runs.values()),
        "one_signature_per_program": all(r["signature_ok"]
                                         for r in runs.values()),
        "block_invariants": True,     # the walk raises on a violation
        "prefix_hits": b_["prefix_counters"]["hits"] > 0
        and b_["prefix_counters"]["tokens_skipped"] > 0,
        "preemptions": c["counters"]["preemptions"] >= 1,
        "spec_proposed": d["spec_counters"]["proposed"] > 0,
        "paged_equals_dense": paged["logits_bit_equal"],
        "a_fifo_timeline": a["timeline"]["ok"],
        "a_fifo_nested_sync_phases": all(
            n > 0 for n in a["nested_sync_phases"].values()),
        **{f"a_fifo_device.{k}": v
           for k, v in a["device"]["checks"].items()},
    }
    off_runs = [(r, t) for turn, r, t in planes if turn == "off"]
    on_runs = [(r, t) for turn, r, t in planes if turn == "on"]
    checks["planes_tokens_bit_equal"] = all(
        t == off_runs[0][1] for _, t in off_runs + on_runs)
    checks["planes_signatures_equal"] = all(
        r["compile_cache_sizes"] == off_runs[0][0]["compile_cache_sizes"]
        and r["retrace"] == 0 for r, _ in off_runs + on_runs)
    for i, (r, _) in enumerate(on_runs):
        checks.update({f"on{i}.device.{k}": v
                       for k, v in r["device"]["checks"].items()})
        checks.update({f"on{i}.planes.{k}": v
                       for k, v in r["planes"]["checks"].items()})
    rates = {turn: statistics.median(
        r["served_tokens_per_s"] for t, r, _ in planes if t == turn)
        for turn in ("off", "on")}
    out = {"engine": ENGINE, "n_layers": cfg.n_layers,
           "block_bytes": a["memory_report"]["kv"]["block_bytes"],
           "pool_bytes": a["memory_report"]["kv"]["total_bytes"],
           "served_tokens_per_s": {k: r["served_tokens_per_s"]
                                   for k, r in runs.items()},
           "profiled_tick_8_slots": a["profiled_tick"],
           "profiled_generate_decode_step_b4": decode_profile,
           "paged_vs_dense": paged,
           "device_a_fifo": a["device"],
           "device_on": [r["device"] for r, _ in on_runs],
           "planes_served_tokens_per_s": {
               "runs": [[turn, r["served_tokens_per_s"]]
                        for turn, r, _ in planes],
               "median_off": rates["off"], "median_on": rates["on"],
               "on_over_off": rates["on"] / rates["off"]},
           "a_fifo_equals_planes_off": outputs["a_fifo"] == off_runs[0][1],
           "checks": checks, "ok": all(checks.values())}
    emit("serve engine", **out)
    if not out["ok"]:
        raise PhaseError("serve engine failed its checks: "
                         f"{[k for k, v in checks.items() if not v]}")
    return out


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


# -- sharded training strategies ---------------------------------------------

# Llama-3-8B width cut to 4 of 32 layers (1.92 B parameters, 7.7 GB in
# f32): the replicated step holds weights, gradients and AdamW's two
# moments (31 GB) beside the source weights every route starts from.
SHARDED_LAYERS = 4
SHARDED_STEPS = 3
# ZeRO and FSDP against the replicated route, per leaf ‖a − b‖ / ‖b‖ after
# each step.  At a world of one the collectives copy and the sharded
# routes' clip is clip_grad_norm_'s arithmetic, so they run the replicated
# route's arithmetic (bit-equality recorded).  A last-bit difference is
# amplified by the bf16 casts and AdamW's normalised update: an
# optax-style clip, whose norm sums in another order, reads 4e-9 after
# the first step and 4e-5 after the third on the H100, so the limit
# passes only the same arithmetic.
PARAM_RTOL = 1e-5
# A bf16 stage and MoE layer: their gradients through the pipeline's and
# the all-to-alls' backward, against the plain ones (bit-equality recorded).
BF16_GRAD_RTOL = 1e-2
# The 1-stage pipeline's stage: a Llama-3-8B-width SwiGLU block (dim,
# ffn_dim), over microbatches (count, tokens each).
PIPELINE_STAGE = (4096, 14336, 4, 1024)


def _sharded_model(seed: int):
    """The sharded phases' weights: f32 masters, bf16 compute, remat, the
    flash kernels; and the training batch of 4,096 tokens."""
    import numpy as np
    import torch

    from horovod_tpu_torch.models import llama

    cfg = llama.llama3_8b(attn_impl="flash", n_layers=SHARDED_LAYERS)
    assert cfg.remat and cfg.param_dtype == torch.float32
    params = llama.init_params(cfg, seed, device=DEV)
    rng = np.random.RandomState(seed + 3)
    tokens = torch.as_tensor(
        rng.randint(0, cfg.vocab_size, (1, TRAIN_TOKENS + 1)), device=DEV)
    return cfg, params, (tokens[:, :-1], tokens[:, 1:])


def _flash_counts() -> dict:
    from horovod_tpu_torch.parallel import flash_attention as fa

    return {"flash_fwd": fa.launches, "flash_bwd_dq": fa.dq_launches,
            "flash_bwd_dkv": fa.dkv_launches}


def _leaves(params) -> list:
    from horovod_tpu_torch.optim.distributed_optimizer import tree_leaves

    return tree_leaves(params)


def phase_sequence_parallel(cfg, params0, batch) -> dict:
    """The Llama's sequence-parallel engines at a world of one on NCCL:
    ``ulysses_flash`` (two all-to-alls around the flash kernels) against
    ``flash``, ``ring`` (einsum block updates) against the blockwise
    engine with one block; then one remat training step of each of
    ``ulysses_flash`` and ``flash`` from the same weights."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.parallel import flash_attention as fa

    world = dist.group.WORLD
    tokens = batch[0]
    impl = {name: dataclasses.replace(cfg, attn_impl=name)
            for name in ("flash", "ulysses_flash", "ring", "blockwise")}
    impl["blockwise"] = dataclasses.replace(impl["blockwise"],
                                            attn_block_size=TRAIN_TOKENS)
    with torch.no_grad():
        logits = {"flash": llama.forward(params0, tokens, impl["flash"])}
        for name in ("ulysses_flash", "ring"):
            logits[name] = llama.forward(params0, tokens, impl[name],
                                         sp_group=world)
        logits["blockwise"] = llama.forward(params0, tokens,
                                            impl["blockwise"])
    ref = logits["blockwise"]
    ring_err = float((logits["ring"] - ref).abs().max() / ref.abs().max())
    out = {"n_layers": cfg.n_layers, "tokens": TRAIN_TOKENS,
           "world_size": dist.get_world_size(),
           "ulysses_flash_logits_bit_equal_flash":
               torch.equal(logits["ulysses_flash"], logits["flash"]),
           "ring_logits_bit_equal_blockwise": torch.equal(logits["ring"], ref),
           "ring_vs_blockwise_rel_err": ring_err, "logit_rtol": LOGIT_RTOL}
    del logits, ref
    leaves = _leaves(params0)
    for t in leaves:
        t.requires_grad_()
    # A warm-up backward (the first at this size pays one-time costs),
    # then one timed step of each route.
    llama.loss_fn(params0, batch, impl["flash"]).backward()
    for t in leaves:
        t.grad = None
    steps, grads_flash = {}, None
    for name in ("flash", "ulysses_flash"):
        kw = {"sp_group": world} if name == "ulysses_flash" else {}
        sync()
        fa.launches = fa.dq_launches = fa.dkv_launches = 0
        t0 = time.perf_counter()
        loss = llama.loss_fn(params0, batch, impl[name], **kw)
        loss.backward()
        sync()
        steps[name] = {"loss": float(loss.detach()), "step_s": time.perf_counter() - t0,
                       "launches": _flash_counts()}
        grads = [t.grad for t in leaves]
        for t in leaves:
            t.grad = None
        if grads_flash is None:
            grads_flash = grads
        else:
            out["grads_bit_equal"] = all(torch.equal(a, b) for a, b in
                                         zip(grads, grads_flash))
    del grads, grads_flash
    for t in leaves:
        t.requires_grad_(False)
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkv": cfg.n_layers}
    out.update(steps=steps, expected_launches_per_step=want)
    checks = {
        "ulysses_flash_logits_bit_equal": out[
            "ulysses_flash_logits_bit_equal_flash"],
        "ring_within_logit_rtol": ring_err <= LOGIT_RTOL,
        "loss_bit_equal": steps["flash"]["loss"]
        == steps["ulysses_flash"]["loss"],
        "grads_bit_equal": out["grads_bit_equal"],
        "launches": all(s["launches"] == want for s in steps.values()),
    }
    out["checks"] = checks
    out["ok"] = all(checks.values())
    emit("train sequence_parallel", **out)
    if not out["ok"]:
        raise PhaseError("train sequence_parallel failed its checks: "
                         f"{[k for k, v in checks.items() if not v]}")
    return {"launches": {k: sum(s["launches"][k] for s in steps.values())
                         for k in want}}


def _adamw(leaves):
    import torch

    return torch.optim.AdamW(leaves, lr=2e-5, betas=(0.9, 0.95),
                             weight_decay=0.1, fused=True)


def _run_route(step, params, batch, n_layers, after_step) -> dict:
    """``SHARDED_STEPS`` steps of one route: losses, seconds, launches a
    step, the allocator's peak; ``after_step(i, params)`` after each."""
    import torch

    from horovod_tpu_torch.parallel import flash_attention as fa

    sync()
    losses, seconds, launches = [], [], []
    for i in range(SHARDED_STEPS):
        fa.launches = fa.dq_launches = fa.dkv_launches = 0
        t0 = time.perf_counter()
        out = step(params, batch)
        losses.append(float(out.loss))
        sync()
        seconds.append(time.perf_counter() - t0)
        launches.append(_flash_counts())
        after_step(i, params)
    want = {"flash_fwd": 2 * n_layers, "flash_bwd_dq": n_layers,
            "flash_bwd_dkv": n_layers}
    return {"losses": losses, "step_s": seconds, "launches_per_step": launches,
            "launches_ok": all(l == want for l in launches),
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}


def phase_sharded_training(cfg, params0, batch) -> dict:
    """``train zero`` and ``train fsdp``: three AdamW steps (clip 1.0) of
    each sharded route from the same weights as the replicated
    ``DistributedOptimizer`` route, each step's parameters held leaf by
    leaf against the replicated route's (kept on the host)."""
    import torch

    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.optim.distributed_optimizer import (
        DistributedOptimizer, make_train_step)
    from horovod_tpu_torch.optim.fsdp import (fsdp_partition_specs,
                                              make_fsdp_train_step,
                                              shard_params)
    from horovod_tpu_torch.optim.zero import make_zero_train_step

    loss_fn = llama.make_loss_fn(cfg)
    names = [n for n in ("embed", "final_norm", "lm_head")] + [
        f"layers.{k}" for k in sorted(params0["layers"])]

    def flat(params):
        return dict(zip(sorted(names), _leaves(params)))

    # The replicated route, its parameters after each step on the host.
    reference = []
    torch.cuda.reset_peak_memory_stats()
    rep = {k: (v.clone() if not isinstance(v, dict) else
               {n: t.clone() for n, t in v.items()})
           for k, v in params0.items()}
    leaves = _leaves(rep)
    for t in leaves:
        t.requires_grad_()
    replicated_step = make_train_step(
        loss_fn, DistributedOptimizer(_adamw(leaves)), max_grad_norm=1.0)
    routes = {"replicated": _run_route(
        lambda p, b: replicated_step(p, b), rep, batch, cfg.n_layers,
        lambda i, p: reference.append({k: t.detach().to("cpu", copy=True)
                                       for k, t in flat(p).items()}))}
    del rep, leaves, replicated_step
    torch.cuda.empty_cache()

    out = {}
    for route in ("zero", "fsdp"):
        torch.cuda.reset_peak_memory_stats()
        if route == "zero":
            params = {k: (v.clone() if not isinstance(v, dict) else
                          {n: t.clone() for n, t in v.items()})
                      for k, v in params0.items()}
            step, init = make_zero_train_step(loss_fn, _adamw,
                                              clip_global_norm=1.0)
        else:
            # A world of one: each shard is the whole leaf.
            params = shard_params(params0, fsdp_partition_specs(params0))
            step, init = make_fsdp_train_step(loss_fn, _adamw,
                                              clip_global_norm=1.0)
        state = init(params)
        errs = []

        def after(i, params):
            errs.append({k: _rel_err(t, reference[i][k])
                         for k, t in flat(params).items()})
        routes[route] = _run_route(lambda p, b: step(p, state, b), params,
                                   batch, cfg.n_layers, after)
        routes[route]["param_rel_err_max_by_step"] = [
            max(e[0] for e in step_errs.values()) for step_errs in errs]
        routes[route]["params_bit_equal_by_step"] = [
            all(e[1] for e in step_errs.values()) for step_errs in errs]
        routes[route]["opt_state_elems"] = sum(
            v.numel() for st in (state.optimizer.state if route == "zero"
                                 else state.state).values()
            for v in st.values() if torch.is_tensor(v) and v.dim() > 0)
        del params, state, step, init
        torch.cuda.empty_cache()
        r = routes[route]
        checks = {
            "launches": r["launches_ok"],
            "losses_within_rtol": all(
                abs(a - b) <= PARAM_RTOL * abs(b) for a, b in
                zip(r["losses"], routes["replicated"]["losses"])),
            "params_within_rtol": max(r["param_rel_err_max_by_step"])
            <= PARAM_RTOL,
            "finite": all(math.isfinite(x) for x in r["losses"]),
        }
        out[route] = {
            "n_layers": cfg.n_layers, "params": llama.num_params(cfg),
            "tokens_per_step": TRAIN_TOKENS, "route": r,
            "replicated": routes["replicated"],
            "losses_bit_equal": r["losses"] == routes["replicated"]["losses"],
            "param_rtol": PARAM_RTOL, "checks": checks,
            "ok": all(checks.values())}
        emit(f"train {route}", **out[route])
        if not out[route]["ok"]:
            raise PhaseError(f"train {route} failed its checks: "
                             f"{[k for k, v in checks.items() if not v]}")
    keys = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    return {"launches": {k: sum(l[k] for r in routes.values()
                                for l in r["launches_per_step"])
                         for k in keys}}


def _rel_err(a, ref_host) -> tuple[float, bool]:
    """‖a − ref‖ / ‖ref‖ on the card, and whether they are equal."""
    import torch

    ref = ref_host.to(a.device)
    a = a.detach()
    return (float((a.float() - ref.float()).norm() / ref.float().norm()),
            bool(torch.equal(a, ref)))


def phase_pipeline_moe(seed: int) -> dict:
    """A 1-stage pipeline of a Llama-3-8B-width SwiGLU block (bf16) against
    the same stage run microbatch by microbatch; ``expert_parallel_mlp``
    at a world of one against ``moe.forward`` at ``MoEConfig``'s own
    widths, 4,096 bf16 tokens, with gradients."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.models import moe
    from horovod_tpu_torch.parallel import pipeline

    gen = torch.Generator(device=DEV).manual_seed(seed + 11)
    d, f, m, mb = PIPELINE_STAGE

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=DEV) * scale).to(
            torch.bfloat16)

    stage = {"w_gate": rand(d, f, scale=d ** -0.5),
             "w_up": rand(d, f, scale=d ** -0.5),
             "w_down": rand(f, d, scale=f ** -0.5)}

    def stage_fn(p, h):
        return h + (F.silu(h @ p["w_gate"]) * (h @ p["w_up"])) @ p["w_down"]

    x, tgt = rand(m, mb, d), rand(m, mb, d)

    def mse(y, t):
        return ((y.float() - t.float()) ** 2).mean()

    out = {"stage": {"dim": d, "ffn_dim": f, "microbatches": m,
                     "microbatch_tokens": mb, "dtype": "bf16"}}
    with torch.no_grad():
        sync()
        t0 = time.perf_counter()
        ys = pipeline.pipeline_forward(stage_fn, stage, x)
        sync()
        out["pipeline_forward_s"] = time.perf_counter() - t0
        seq = torch.stack([stage_fn(stage, x[i]) for i in range(m)])
    out["pipeline_forward_bit_equal"] = torch.equal(ys, seq)
    for t in stage.values():
        t.requires_grad_()
    pipeline.pipeline_loss_fn(stage_fn, mse)(stage, (x, tgt)).backward()
    g_pipe = {k: t.grad for k, t in stage.items()}
    for t in stage.values():
        t.grad = None
    torch.stack([mse(stage_fn(stage, x[i]), tgt[i])
                 for i in range(m)]).mean().backward()
    g_seq = {k: t.grad for k, t in stage.items()}
    out["pipeline_grads_bit_equal"] = all(torch.equal(g_pipe[k], g_seq[k])
                                          for k in stage)
    out["pipeline_grad_rel_err"] = {
        k: float((g_pipe[k].float() - g_seq[k].float()).norm()
                 / g_seq[k].float().norm()) for k in stage}
    del stage, g_pipe, g_seq, ys, seq

    cfg = moe.MoEConfig()
    params = {k: v.requires_grad_() for k, v in
              moe.init_params(cfg, seed, device=DEV).items()}
    tokens = (torch.randn((TRAIN_TOKENS, cfg.dim), generator=gen, device=DEV)
              .to(torch.bfloat16).requires_grad_())
    res = {}
    for name, fn in (("forward", moe.forward),
                     ("expert_parallel_mlp", moe.expert_parallel_mlp)):
        with torch.no_grad():
            fn(params, tokens, cfg)             # warm-up, not timed
        sync()
        t0 = time.perf_counter()
        y, aux = fn(params, tokens, cfg)
        ((y.float() ** 2).mean() + aux).backward()
        sync()
        res[name] = {"s": time.perf_counter() - t0, "y": y.detach(),
                     "aux": float(aux.detach()),
                     "grads": {k: t.grad for k, t in params.items()},
                     "x_grad": tokens.grad}
        for t in list(params.values()) + [tokens]:
            t.grad = None
    a, b = res["expert_parallel_mlp"], res["forward"]
    grads = {**{k: (a["grads"][k], b["grads"][k]) for k in params},
             "x": (a["x_grad"], b["x_grad"])}
    out["moe"] = {
        "config": dataclasses.asdict(cfg) | {"dtype": "bf16",
                                              "param_dtype": "f32"},
        "tokens": TRAIN_TOKENS, "capacity": moe._capacity(TRAIN_TOKENS, cfg),
        "forward_backward_s": {"forward": b["s"],
                               "expert_parallel_mlp": a["s"]},
        "y_bit_equal": torch.equal(a["y"], b["y"]),
        "aux_bit_equal": a["aux"] == b["aux"],
        "grads_bit_equal": all(torch.equal(g, h) for g, h in grads.values()),
        "grad_rel_err": {k: float((g.float() - h.float()).norm()
                                  / h.float().norm())
                         for k, (g, h) in grads.items()}}
    y_err = float((a["y"].float() - b["y"].float()).abs().max()
                  / b["y"].float().abs().max())
    out["moe"]["y_rel_err"] = y_err
    checks = {
        "pipeline_forward_bit_equal": out["pipeline_forward_bit_equal"],
        "pipeline_grads": max(out["pipeline_grad_rel_err"].values())
        <= BF16_GRAD_RTOL,
        "moe_y": y_err <= BF16_GRAD_RTOL,
        "moe_aux": abs(a["aux"] - b["aux"]) <= 1e-6 * abs(b["aux"]),
        "moe_grads": max(out["moe"]["grad_rel_err"].values())
        <= BF16_GRAD_RTOL,
    }
    out["bf16_grad_rtol"] = BF16_GRAD_RTOL
    out["checks"] = checks
    out["ok"] = all(checks.values())
    emit("train pipeline_moe", **out)
    if not out["ok"]:
        raise PhaseError("train pipeline_moe failed its checks: "
                         f"{[k for k, v in checks.items() if not v]}")
    return out


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
    compute with f32 parameters and BN, ``SGD(0.01, momentum=0.9)``; every
    norm through the fused batch-norm kernels, counted."""
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
        late = _bn_launches(model, len(run["losses"]))
        late["checks"]["bn_stats_moved"] = all(
            not torch.equal(a, b) for a, b in zip(stats, moved))
        return late

    _bn_launches_reset()
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
    momentum=0.9)``; every norm through the fused batch-norm kernels,
    counted."""
    import torch

    from horovod_tpu_torch import basics
    from horovod_tpu_torch.models.inception import InceptionV3

    basics.init()
    torch.backends.cudnn.benchmark = True
    model = InceptionV3(dtype=torch.bfloat16, device=DEV, seed=seed)
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    _bn_launches_reset()
    out = _vision_train("train inception_v3", model, opt,
                        _vision_batch(seed + 8, 299), warmup=1, timed=2,
                        profile=False, flops=None, extra={"image_size": 299},
                        after=lambda step, run: _bn_launches(
                            model, len(run["losses"])))
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


# -- train eager: Horovod's engine and its PyTorch API ----------------------

EAGER_ELEMS = 1 << 22          # module API tensors: 16 MiB of f32 each
EAGER_TIMEOUT_S = 30.0


@contextlib.contextmanager
def _env(values: dict):
    """Set environment variables for the ``basics.init`` inside (the engine
    reads its knobs there), and put the old values back after."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _eager_module_api(seed: int, log_path: str, midway) -> dict:
    """Every collective of the module API and the frontend, async, held
    bit for bit against the synchronous API on the same inputs (a world of
    one: the input itself); ``poll`` must turn true before ``synchronize``;
    then grouped allreduces until the autotuner closes a window and logs
    its row.  ``midway()`` runs after the single allreduces."""
    import torch

    from horovod_tpu_torch import torch_frontend as F
    from horovod_tpu_torch.ops import collective_ops as C
    from horovod_tpu_torch.ops import eager as E
    from horovod_tpu_torch.ops.compression import Compression
    from horovod_tpu_torch.optim.distributed_optimizer import (
        allreduce_gradients)

    g = torch.Generator(device=DEV).manual_seed(seed)
    x = torch.randn(EAGER_ELEMS, device=DEV, generator=g)
    ys = [torch.randn(n, device=DEV, generator=g)
          for n in (4096, 1 << 20, 3 * 7 * 11)]
    checks, polls = {}, {}

    def polled(name, h):
        t0 = time.perf_counter()
        while not E.poll(h):
            if time.perf_counter() - t0 > EAGER_TIMEOUT_S:
                raise PhaseError(f"train eager: poll({name}) never turned "
                                 "true")
            time.sleep(1e-4)
        polls[name] = time.perf_counter() - t0
        return E.synchronize(h)

    for op in ("Sum", "Average", "Min", "Max", "Product"):
        got = polled(f"allreduce_{op}", E.allreduce_async(
            x, name=f"api.{op}", op=getattr(C, op)))
        checks[f"allreduce_{op}"] = torch.equal(
            got, C.allreduce(x, op=getattr(C, op)))
    for comp in ("fp16", "bf16"):
        c = getattr(Compression, comp)
        got = polled(f"allreduce_{comp}", E.allreduce_async(
            x, average=True, name=f"api.{comp}", compression=c))
        checks[f"allreduce_{comp}"] = torch.equal(
            got, C.allreduce(x, average=True, compression=c))
    midway()
    grouped = E.grouped_allreduce_eager([x, *ys], average=True)
    sync = C.grouped_allreduce([x, *ys], average=True)
    checks["grouped_allreduce"] = all(map(torch.equal, grouped, sync))
    rows = x.reshape(1024, -1)
    checks["allgather"] = torch.equal(
        polled("allgather", E.allgather_async(rows, "api.gather")),
        C.allgather(rows))
    checks["broadcast"] = torch.equal(
        polled("broadcast", E.broadcast_async(rows, 0, "api.bcast")),
        C.broadcast(rows, 0))
    checks["alltoall"] = torch.equal(
        polled("alltoall", E.alltoall_async(rows, [1024], "api.a2a")),
        C.alltoall(rows))
    checks["reducescatter"] = torch.equal(
        polled("reducescatter", E.reducescatter_async(rows, "api.rs")),
        C.reducescatter(rows, op=C.Average))
    topk = Compression.topk(ratio=0.01)
    checks["sparse_allreduce"] = torch.equal(
        polled("sparse", E.sparse_allreduce_async(x, "api.sparse",
                                                  ratio=0.01)),
        topk.sparse_allreduce(x))
    grads = [y.clone() for y in ys]
    allreduce_gradients(grads)
    inplace = [y.clone() for y in ys]
    hs = [F.allreduce_async_(t, name=f"api.inplace.{i}")
          for i, t in enumerate(inplace)]
    checks["frontend_inplace"] = all(
        F.synchronize(h) is t and torch.equal(t, r)
        for h, t, r in zip(hs, inplace, grads))
    F.barrier()
    checks["join"] = F.join() == 0
    eng = E._engine()
    checks["native_controller_on"] = eng.controller is not None
    checks["poll_turned_true"] = len(polls) == 12
    # Autotune: windows of 2 flushes after 1 warm-up flush; each flush
    # here is one grouped call of 32 MiB.
    rounds = 0
    while (rounds < 200 and eng.autotuner is not None
           and len(open(log_path).read().splitlines()) < 2):
        E.grouped_allreduce_eager([x, x.flip(0)], average=True)
        rounds += 1
    rows_logged = open(log_path).read().splitlines()
    checks["autotune_logged"] = len(rows_logged) >= 2
    return {"checks": checks, "poll_s": polls,
            "autotune": {"rounds": rounds, "log": rows_logged[:4],
                         "threshold": eng.config.fusion_threshold_bytes,
                         "cycle_ms": eng.config.cycle_time_ms},
            "stats": {k: v for k, v in E.engine_stats().items()
                      if k != "recent_negotiate_s"}}


def _timeline_check(path: str, track: str, kind: str) -> dict:
    """A timeline the module API wrote: strict JSON, a track per tensor,
    the engine's phases for a ``kind`` op (``ALLREDUCE``, ``ALLGATHER``)
    on ``track``."""
    with open(path) as f:
        events = json.load(f)
    pids = {e["pid"]: e["args"]["name"] for e in events
            if e.get("name") == "process_name"}
    phases = sorted({(e["name"], e["ph"]) for e in events
                     if pids.get(e["pid"]) == track})
    want = {(f"NEGOTIATE_{kind}", "B"), (f"NEGOTIATE_{kind}", "E"),
            ("NEGOTIATE_TICK_r0", "i"), (kind, "B"), (kind, "E"),
            ("WAIT_FOR_OUTPUT", "b"), ("WAIT_FOR_OUTPUT", "e")}
    if kind == "ALLREDUCE":
        want |= {("DISPATCH", "B"), ("DISPATCH", "E")}
    return {"events": len(events), "tensors": len(pids),
            track: [list(p) for p in phases],
            "ok": want <= set(phases) and events[-1]["name"] == "done"}


def _profiler_trace_check(prof_dir: str) -> dict:
    """The ``torch.profiler`` trace ``stop_timeline`` wrote beside the
    timeline: its file, its events, and CUDA kernels among them."""
    files = sorted(os.listdir(prof_dir)) if os.path.isdir(prof_dir) else []
    kernels = events = 0
    for name in files:
        with open(os.path.join(prof_dir, name)) as f:
            trace = json.load(f)
        for e in trace.get("traceEvents", []):
            events += 1
            kernels += e.get("cat") == "kernel"
    return {"files": files, "events": events, "cuda_kernels": kernels,
            "ok": files == ["trace_rank0.json"] and kernels > 0}


def _host_split(model, batch, opt, steps: int = 4) -> dict:
    """Where one step's host time goes, by ``time.perf_counter`` around its
    parts: forward, ``backward`` (autograd, and on the hook route the
    hooks), ``synchronize``, ``step``, then the wait for the card; and, on
    the hook route, the hooks' own time (``EagerDistributedOptimizer.
    _enqueue``), the engine's enqueue inside it, and the cycle thread's
    flushes.  Medians over ``steps`` steps after one warm-up step."""
    import threading

    from horovod_tpu_torch.ops import eager as E
    from horovod_tpu_torch.optim import eager_optimizer as EO

    spent: dict[str, float] = {}

    def timed(cls, attr, key):
        inner = getattr(cls, attr)

        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return inner(*a, **kw)
            finally:
                k = key(a) if callable(key) else key
                spent[k] = spent.get(k, 0.0) + time.perf_counter() - t0
                spent[k + "_calls"] = spent.get(k + "_calls", 0) + 1
        setattr(cls, attr, wrapper)
        return inner

    def flush_key(a):
        cycle = threading.current_thread().name.endswith("-engine")
        empty = not a[0]._queue
        return ("cycle_flush" if cycle else "caller_flush") + (
            "_empty" if empty else "")

    saved = [(E.EagerEngine, "flush",
              timed(E.EagerEngine, "flush", flush_key)),
             (E.EagerEngine, "enqueue_many",
              timed(E.EagerEngine, "enqueue_many", "engine_enqueue")),
             (EO.EagerDistributedOptimizer, "_enqueue",
              timed(EO.EagerDistributedOptimizer, "_enqueue", "hook"))]
    rows = []
    try:
        for i in range(steps + 1):
            spent.clear()
            t0 = time.perf_counter()
            loss = _cross_entropy(model, batch)
            t1 = time.perf_counter()
            loss.backward()
            t2 = time.perf_counter()
            opt.synchronize()
            t3 = time.perf_counter()
            opt.step()
            opt.zero_grad(set_to_none=True)
            t4 = time.perf_counter()
            sync()
            t5 = time.perf_counter()
            if i:
                rows.append({"forward_ms": (t1 - t0) * 1e3,
                             "backward_ms": (t2 - t1) * 1e3,
                             "synchronize_ms": (t3 - t2) * 1e3,
                             "step_ms": (t4 - t3) * 1e3,
                             "card_wait_ms": (t5 - t4) * 1e3,
                             **{k: (v if k.endswith("_calls") else v * 1e3)
                                for k, v in spent.items()}})
    finally:
        for cls, attr, inner in saved:
            setattr(cls, attr, inner)
    keys = sorted({k for r in rows for k in r})
    return {k: statistics.median(r.get(k, 0.0) for r in rows) for k in keys}


def _eager_route(name, make_model, make_opt, batch, routes, want=None):
    """One model under both gradient routes from the same weights: the
    parameters after one step must be equal bit for bit (cuDNN restricted
    to deterministic algorithms for those steps, and a second synchronous
    step as the control), then the timed runs in turns, each 2 warm-up, 8
    timed and 1 profiled steps (``_run_steps``).  Route ``off`` is the
    synchronous one with the engine shut down (``sync`` runs with it
    alive).  Last, each route's host time split by part (``_host_split``)."""
    import torch

    from horovod_tpu_torch import basics
    from horovod_tpu_torch import torch_frontend as F
    from horovod_tpu_torch.ops import eager as E
    from horovod_tpu_torch.optim.distributed_optimizer import (
        DistributedOptimizer, make_train_step)

    model = make_model()
    start = {k: v.clone() for k, v in model.state_dict().items()}

    def wrap(route, opt):
        if route == "hook":
            return F.DistributedOptimizer(opt, model.named_parameters())
        return DistributedOptimizer(opt)

    def one_step(route):
        model.load_state_dict(start)
        opt = wrap(route, make_opt(model))
        make_train_step(_cross_entropy, opt)(model, batch)
        if route == "hook":
            opt.remove_hooks()
        sync()
        return {k: v.clone() for k, v in model.state_dict().items()}

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        after = {"sync": one_step("sync"), "hook": one_step("hook"),
                 "control": one_step("sync")}
    finally:
        torch.backends.cudnn.deterministic = det

    def equal(a, b):
        return all(torch.equal(a[k], b[k]) for k in a)

    checks = {"hook_equals_sync_bit_for_bit": equal(after["hook"],
                                                    after["sync"]),
              "sync_step_deterministic": equal(after["control"],
                                               after["sync"])}
    del after
    runs = []
    for route in routes:
        if route == "off":
            basics.shutdown()
            basics.init()
        else:
            E._engine()         # alive, as after any eager call
        opt = wrap(route, make_opt(model))
        step = make_train_step(_cross_entropy, opt)
        before = dict(E.engine_stats())
        run = _run_steps(step, model, batch, 2, 8, True)
        if route == "hook":
            opt.remove_hooks()
            stats = E.engine_stats()
            n = len(run["losses"])
            run["engine_per_step"] = {
                k: (stats[k] - before.get(k, 0)) / n
                for k in ("batches_dispatched", "tensors_fused",
                          "allreduce_bytes")}
        if want is not None and not all(p == want for p in run["launches"]):
            raise PhaseError(f"train eager {name} ({route}): launches per "
                             f"step {run['launches']}, want {want}")
        run["launches"] = {k: sum(p[k] for p in run["launches"])
                           for k in run["launches"][0]}
        prof = run.pop("profiled_step")
        runs.append({"route": route, **run,
                     "kernels": prof["kernels"],
                     "device_busy_ms": prof["device_busy_ms"],
                     "wall_ms": prof["wall_ms"],
                     "device_idle_share": prof["device_idle_share"],
                     "ms_by_kind": prof["ms_by_kind"]})
    host = {}
    E._engine()
    for route in ("sync", "hook"):
        opt = wrap(route, make_opt(model))
        host[route] = _host_split(model, batch, opt)
        if route == "hook":
            opt.remove_hooks()
    by_route = {}
    for route in ("off", "sync", "hook"):
        rs = [r for r in runs if r["route"] == route]
        by_route[route] = {}
        for key in ("images_per_s", "kernels", "device_busy_ms",
                    "device_idle_share"):
            got = [r[key] for r in rs if r[key] is not None]
            by_route[route][key] = statistics.median(got) if got else None
    checks["finite"] = all(math.isfinite(v) for r in runs
                           for v in r["losses"])
    for r in runs:
        r.pop("step_seconds")
    return {"checks": checks, "runs": runs, "by_route": by_route,
            "host_split": host,
            "params": sum(p.numel() for p in model.parameters()),
            "param_tensors": sum(1 for _ in model.parameters())}


def phase_train_eager(seed: int) -> dict:
    """Horovod's engine and PyTorch API (``ops/eager.py``,
    ``torch_frontend.py``) on NCCL at a world of one: the module API with
    the native controller on (``local:`` transport), a timeline written
    and parsed back, an autotune window and its log row; then ResNet-101
    (SGD, momentum 0.9) and ViT-B/16 (AdamW, flash) at batch 64 under the
    hook-driven ``DistributedOptimizer`` and the synchronous one in turns
    (off, sync, hook, hook, sync, off; ``off``: the synchronous route with
    the engine shut down), from the same weights first, where the
    parameters after one step must be equal bit for bit."""
    import tempfile

    import torch

    from horovod_tpu_torch import basics
    from horovod_tpu_torch.models.resnet import ResNet101
    from horovod_tpu_torch.models.vit import ViT_B16

    from horovod_tpu_torch.timeline import start_timeline, stop_timeline

    tmp = tempfile.mkdtemp(prefix="hvd_eager_")
    env_timeline = os.path.join(tmp, "env_timeline.json")
    timeline = os.path.join(tmp, "timeline.json")
    prof_dir = os.path.join(tmp, "profile")
    tune_log = os.path.join(tmp, "autotune.csv")
    basics.shutdown()
    with _env({"HVD_TORCH_NATIVE_CONTROLLER": "on",
               "HVD_TORCH_CONTROLLER_TRANSPORT": "local:chip_smoke",
               "HOROVOD_TIMELINE": env_timeline,
               "HOROVOD_AUTOTUNE": "1",
               "HOROVOD_AUTOTUNE_LOG": tune_log,
               "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "1",
               "HOROVOD_AUTOTUNE_STEADY_STATE_SAMPLES": "2"}):
        basics.init()
    def midway():
        # the env timeline ends; a timeline and a torch.profiler trace
        # over the same window take over
        stop_timeline()
        start_timeline(timeline, profiler_dir=prof_dir)

    try:
        try:
            api = _eager_module_api(seed, tune_log, midway)
        finally:
            stop_timeline()
    finally:
        basics.shutdown()
    api["env_timeline"] = _timeline_check(env_timeline, "api.Sum",
                                          "ALLREDUCE")
    api["timeline"] = _timeline_check(timeline, "api.gather", "ALLGATHER")
    api["timeline"]["profiler_trace"] = _profiler_trace_check(prof_dir)
    basics.init()                   # the user's default: no controller at 1
    torch.backends.cudnn.benchmark = True
    routes = ("off", "sync", "hook", "hook", "sync", "off")
    resnet = _eager_route(
        "resnet101",
        lambda: ResNet101(dtype=torch.bfloat16, device=DEV, seed=seed),
        lambda m: torch.optim.SGD(m.parameters(), lr=0.01, momentum=0.9),
        _vision_batch(seed + 5, 224), routes)
    torch.cuda.empty_cache()
    vit_want = {"flash_fwd": 12, "flash_bwd_dq": 12, "flash_bwd_dkv": 12}
    vit = _eager_route(
        "vit_b16",
        lambda: ViT_B16(dtype=torch.bfloat16, attn_impl="flash", device=DEV,
                        seed=seed),
        lambda m: torch.optim.AdamW(m.parameters(), lr=1e-3,
                                    weight_decay=1e-4, fused=True),
        _vision_batch(seed + 6, 224), routes, want=vit_want)
    basics.shutdown()               # later phases start without the engine
    basics.init()
    torch.cuda.empty_cache()
    out = {"world_size": basics.size(), "batch": VISION_BATCH,
           "module_api": api, "resnet101": resnet, "vit_b16": vit,
           "vit_launches_total": {
               k: sum(r["launches"][k] for r in vit["runs"])
               for k in vit_want},
           "checks": {**{f"api.{k}": v for k, v in api["checks"].items()},
                      "env_timeline": api["env_timeline"]["ok"],
                      "timeline": api["timeline"]["ok"],
                      "timeline_profiler_cuda_kernels":
                          api["timeline"]["profiler_trace"]["ok"],
                      **{f"resnet101.{k}": v
                         for k, v in resnet["checks"].items()},
                      **{f"vit_b16.{k}": v
                         for k, v in vit["checks"].items()}}}
    out["ok"] = all(out["checks"].values())
    emit("train eager", **out)
    if not out["ok"]:
        raise PhaseError("train eager failed its checks: "
                         f"{[k for k, v in out['checks'].items() if not v]}")
    return out


# ---------------------------------------------------------------- the fleet

ROUTER_SUFFIXES = (1, 100, 255, 300)
ROUTER_BUDGET = 16
ROUTER_FAIL_ON_STEP = 4        # replica0 dies at its 4th step of the wave


def _router_requests(cfg, seed: int, n: int = 16, budget: int = ROUTER_BUDGET):
    """``n`` requests in four shared-prefix families: a random prefix of two
    blocks each (512 tokens), then a suffix of each length in
    ``ROUTER_SUFFIXES``, all with ``budget`` new tokens."""
    import numpy as np

    from horovod_tpu_torch.serving import Request

    rng = np.random.RandomState(seed + 7)
    fams = [rng.randint(0, cfg.vocab_size, 2 * ENGINE["chunk"]).tolist()
            for _ in range(4)]
    return [Request(prompt=fams[i % 4] + rng.randint(
        0, cfg.vocab_size, ROUTER_SUFFIXES[(i // 4) % 4]).tolist(),
        max_new_tokens=budget) for i in range(n)]


def _fresh(reqs):
    """New ``Request`` objects with the same prompts and budgets (a router
    writes its trace context into the object it routes)."""
    from horovod_tpu_torch.serving import Request

    return [Request(prompt=list(r.prompt), max_new_tokens=r.max_new_tokens)
            for r in reqs]


def _post_all(base: str, reqs, keys=None) -> tuple[list, float]:
    """POST every request to ``base``'s ``/v1/generate`` at once, one client
    thread each; returns the reply bodies in order and the wall seconds."""
    import threading
    import urllib.request

    out: list = [None] * len(reqs)
    errors: list = []

    def one(i, r):
        payload = {"prompt": list(r.prompt),
                   "max_new_tokens": r.max_new_tokens}
        if keys is not None:
            payload["idempotency_key"] = keys[i]
        try:
            req = urllib.request.Request(
                base + "/v1/generate", data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as resp:
                out[i] = json.loads(resp.read())
        except Exception as e:      # reported below, with the request
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=one, args=(i, r), daemon=True)
               for i, r in enumerate(reqs)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    if errors or any(o is None for o in out):
        raise PhaseError(f"front door: {errors or 'a client never returned'}")
    return out, wall


def _tokens_of(bodies) -> list:
    return [list(b["tokens"]) for b in bodies]


def _solo_run(eng, reqs) -> tuple[list, float]:
    sync()
    t0 = time.perf_counter()
    res = eng.run(_fresh(reqs))
    sync()
    return [[int(t) for t in r] for r in res], time.perf_counter() - t0


def _hist(reg, name: str) -> dict:
    h = reg.snapshot()["histograms"][name]
    return {k: h[k] for k in ("count", "p50", "p99", "max")}


def phase_router(cfg, params, seed: int) -> dict:
    """The fleet's front door at Llama-3-8B width on the serving phases'
    weights (``router.py``, ``supervisor.py``): two ``LocalReplica``
    engines (8 slots × 2048, prefix cache; the first with device telemetry)
    share one ``params`` behind a ``RouterServer`` on 127.0.0.1 with
    ``prefix_affinity``, against one solo ``ServeEngine`` of the same
    configuration, in turns (solo, fleet on wave A; fleet, solo on wave B;
    16 requests in four shared-prefix families each, posted at once through
    the HTTP front door).  Then (C) the ``serve.router`` fault armed on
    replica 0 mid-wave, (D) ``ReplicaSupervisor`` respawning it with
    ``clone_engine`` (the same weight tensors; one more KV pool of device
    memory) and the clone serving a further wave, (E) a journaled router
    (``HVD_TORCH_ROUTER_JOURNAL`` under ``$TMPDIR``) stopped mid-flight and
    replayed by a new one, a repeated idempotency key answered from the
    journal, and (F) ``measure_router_fleet`` (affinity against round
    robin).  Every wave's tokens equal the solo engine's bit for bit."""
    import tempfile

    import torch

    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.faults import FaultRegistry
    from horovod_tpu_torch.parallel import flash_attention as fa
    from horovod_tpu_torch.router import RouterServer, measure_router_fleet
    from horovod_tpu_torch.serving_scheduler import ServeEngine
    from horovod_tpu_torch.supervisor import ReplicaSupervisor

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opts = dict(ENGINE, prefix_cache=True, sampler=False)

    def engine(**kw):
        return ServeEngine(params, cfg, metrics=metrics.MetricsRegistry(
            event_log=None), **opts, **kw)

    solo = engine()
    replicas = [engine(device_telemetry=True), engine()]
    reg = metrics.MetricsRegistry(event_log=None)
    faults = FaultRegistry()
    router = RouterServer(replicas, policy="prefix_affinity", registry=reg,
                          faults=faults).start()
    base = f"http://{router.host}:{router.port}"
    checks: dict = {}
    out: dict = {"engine": ENGINE, "n_layers": cfg.n_layers,
                 "policy": "prefix_affinity", "replicas": 2}
    sup = None
    # The flash kernels' launches of the fleet's own waves: the counts are
    # set to 0 just before each wave goes through the front door and read
    # just after it, so no solo, oracle or journal run is counted.
    fleet_launches = {64: 0, 128: 0}

    def fleet_wave(reqs):
        fa.launches = 0
        fa.fwd_launches_by_dim.update({64: 0, 128: 0})
        fa.dq_launches = fa.dkv_launches = 0
        bodies, wall = _post_all(base, reqs)
        for d in fleet_launches:
            fleet_launches[d] += fa.fwd_launches_by_dim[d]
        return bodies, wall
    try:
        # A and B: the fleet against one engine, in turns
        waves = {w: _router_requests(cfg, seed + i)
                 for i, w in enumerate("ABCD")}
        turns = []
        solo_tokens = {}
        fleet_tokens = {}
        for who, w in (("solo", "A"), ("fleet", "A"), ("fleet", "B"),
                       ("solo", "B")):
            if who == "solo":
                toks, wall = _solo_run(solo, waves[w])
                solo_tokens[w] = toks
            else:
                bodies, wall = fleet_wave(waves[w])
                toks = _tokens_of(bodies)
                fleet_tokens[w] = toks
                checks[f"wave_{w}_all_ok"] = all(b["status"] == "OK"
                                                 for b in bodies)
            turns.append({"who": who, "wave": w, "wall_s": wall,
                          "tokens_per_s": sum(map(len, toks)) / wall})
        for w in "AB":
            checks[f"wave_{w}_tokens_equal_solo"] = (fleet_tokens[w]
                                                     == solo_tokens[w])
        out["turns"] = turns
        out["fleet_tokens_per_s"] = statistics.median(
            t["tokens_per_s"] for t in turns if t["who"] == "fleet")
        out["solo_tokens_per_s"] = statistics.median(
            t["tokens_per_s"] for t in turns if t["who"] == "solo")
        out["greedy_consistency_A"] = _greedy_consistency(
            params, cfg, [r.prompt for r in waves["A"]], fleet_tokens["A"])
        checks["greedy_consistency_A"] = out["greedy_consistency_A"]["ok"]
        out["routed_after_AB"] = {r["name"]: r["routed"]
                                  for r in router.replicas_report()}
        checks["both_replicas_served"] = all(
            v > 0 for v in out["routed_after_AB"].values())
        dev = router.device_report()
        out["device_report_summary"] = dev["summary"]
        checks["fleet_device_view"] = (
            dev["summary"]["n_reporting"] == 1
            and dev["without_telemetry"] == ["replica1"])

        # C: replica 0 dies mid-wave; its requests replay on replica 1
        faults.inject("serve.router", key="replica0",
                      on_hit=ROUTER_FAIL_ON_STEP, permanent=True)
        bodies, wall = fleet_wave(waves["C"])
        solo_tokens["C"], _ = _solo_run(solo, waves["C"])
        counters = reg.snapshot()["counters"]
        out["failover"] = {"wall_s": wall,
                           "failovers": counters["router.failovers"],
                           "replica_deaths": counters["router.replica_deaths"],
                           "hops": sum(b["failovers"] for b in bodies)}
        checks["wave_C_all_ok"] = all(b["status"] == "OK" for b in bodies)
        checks["wave_C_tokens_equal_solo"] = (_tokens_of(bodies)
                                              == solo_tokens["C"])
        checks["failovers"] = counters["router.failovers"] >= 1
        checks["one_replica_death"] = counters["router.replica_deaths"] == 1
        faults.clear()

        # D: the supervisor respawns replica 0 through clone_engine
        dead = router.replicas[0].engine
        pool = dead.memory_report()["kv"]["total_bytes"]
        sync()
        before = torch.cuda.memory_allocated()
        sup = ReplicaSupervisor(router, backoff_s=600.0, warm_prefixes=4)
        deadline = time.monotonic() + 300
        while router.health()[1]["healthy"] < 2:
            router.poll_now()
            if time.monotonic() > deadline:
                raise PhaseError("serve router: replica0 never respawned")
            time.sleep(0.05)
        sync()
        delta = torch.cuda.memory_allocated() - before
        clone = router.replicas[0].engine
        emb = params["embed"]
        out["respawn"] = {
            "memory_delta_bytes": delta, "pool_bytes": pool,
            "delta_over_pool": delta / pool,
            "warm_prefixes": reg.snapshot()["counters"][
                "supervisor.warm_prefixes"],
            "state": sup.state()["replica0"]}
        checks["clone_is_new_engine"] = clone is not dead
        checks["clone_shares_weights"] = (
            clone.params is dead.params
            and clone.params["embed"].data_ptr() == emb.data_ptr())
        checks["clone_same_pool_geometry"] = (clone.pcache.k.shape
                                              == dead.pcache.k.shape)
        checks["respawn_costs_one_pool"] = 0.9 * pool <= delta <= 1.1 * pool
        del dead
        routed0 = {r["name"]: r["routed"] for r in router.replicas_report()}
        steps0 = clone.step_index
        bodies, wall = fleet_wave(waves["D"])
        solo_tokens["D"], _ = _solo_run(solo, waves["D"])
        routed1 = {r["name"]: r["routed"] for r in router.replicas_report()}
        checks["wave_D_all_ok"] = all(b["status"] == "OK" for b in bodies)
        checks["wave_D_tokens_equal_solo"] = (_tokens_of(bodies)
                                              == solo_tokens["D"])
        checks["clone_served"] = (routed1["replica0"] > routed0["replica0"]
                                  and clone.step_index > steps0)
        # the clone keeps replica 0's device plane: the fleet's /device
        # view still has one reporting replica after the respawn
        dev = router.device_report()
        out["device_report_summary_after_respawn"] = dev["summary"]
        checks["fleet_device_view_after_respawn"] = (
            clone.device_telemetry is not None
            and dev["summary"]["n_reporting"] == 1
            and dev["without_telemetry"] == ["replica1"])
        out["route_decision_s"] = _hist(reg, "router.route_decision_s")
        out["e2e_s"] = _hist(reg, "router.e2e_s")
        out["health"] = router.health()[1]
    finally:
        router.stop()

    # E: a journaled router stopped mid-flight, replayed by a new one
    jdir = tempfile.mkdtemp(prefix="hvd_router_journal_")
    jpath = os.path.join(jdir, "journal.jsonl")
    jreqs = _router_requests(cfg, seed + 4, n=4)
    jreqs[0].max_new_tokens = 1          # finishes before the stop
    keys = [f"journal-{i}" for i in range(len(jreqs))]
    jsolo, _ = _solo_run(solo, jreqs)
    with _env({"HVD_TORCH_ROUTER_JOURNAL": jpath}):
        j1 = RouterServer([replicas[1]], policy="round_robin",
                          registry=metrics.MetricsRegistry(event_log=None),
                          sampler=False)
    try:
        rids = [j1.route(r, idempotency_key=k)
                for r, k in zip(_fresh(jreqs), keys)]
        first = j1.result(rids[0], timeout=600)
        unfinished = sum(1 for rid in rids[1:]
                         if j1.result(rid, timeout=0) is None)
    finally:
        j1.stop(drain_s=0.0)
    j1_append = _hist(j1.metrics, "router.journal_append_s")
    with _env({"HVD_TORCH_ROUTER_JOURNAL": jpath}):
        j2 = RouterServer([clone], policy="round_robin",
                          registry=metrics.MetricsRegistry(event_log=None),
                          sampler=False).start()
    try:
        again = [j2.route(r, idempotency_key=k)
                 for r, k in zip(_fresh(jreqs), keys)]
        jtoks = [[int(t) for t in j2.result(rid, timeout=600)]
                 for rid in again]
        routed = j2.metrics.snapshot()["counters"][
            "router.routed.round_robin"]
        repeat = j2.result(j2.route(_fresh(jreqs)[1],
                                    idempotency_key=keys[1]), timeout=60)
        c2 = j2.metrics.snapshot()["counters"]
        out["journal"] = {
            "stopped_with_unfinished": unfinished,
            "replays": c2["router.journal_replays"],
            "dedups": c2["router.journal_dedups"],
            "append_s_incarnation_1": j1_append,
            "append_s_incarnation_2": _hist(j2.metrics,
                                            "router.journal_append_s"),
            "bytes": os.path.getsize(jpath)}
        checks["journal_first_finished_before_stop"] = (
            first is not None and first.status == "OK")
        checks["journal_stopped_mid_flight"] = unfinished >= 1
        checks["journal_replayed"] = (c2["router.journal_replays"]
                                      == unfinished)
        checks["journal_tokens_equal_solo"] = jtoks == jsolo
        checks["journal_repeat_from_journal"] = (
            [int(t) for t in repeat] == jsolo[1]
            and c2["router.routed.round_robin"] == routed
            and c2["router.journal_dedups"] == len(keys) + 1)
    finally:
        j2.stop()
    del replicas, clone, solo
    torch.cuda.empty_cache()

    # F: affinity against round robin at full width, small pools
    bench = measure_router_fleet(params, cfg, n_replicas=2, n_groups=3,
                                 waves=4, prefix_blocks=2, suffix_len=4,
                                 max_new_tokens=8, n_slots=4, chunk=64)
    out["measure_router_fleet"] = bench
    checks["affinity_hit_rate_above_round_robin"] = (
        bench["serve_router_hit_rate_prefix_affinity"]
        > bench["serve_router_hit_rate_round_robin"])
    # The replicas' programs (the paged chunk and tick) attend with plain
    # einsums over the gathered pool, as the reference's ``_paged_attend``
    # does, so the fleet's waves launch no flash kernel: the check holds
    # the count to that, and a route through a kernel would show here.
    out["launches"] = {"flash_fwd": sum(fleet_launches.values()),
                       "flash_fwd_d128": fleet_launches[128],
                       "flash_fwd_d64": fleet_launches[64],
                       "window": "the fleet's waves A-D through the front "
                                 "door only"}
    checks["fleet_flash_launches_as_the_paged_path_has"] = (
        sum(fleet_launches.values()) == 0)
    out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    out["checks"] = checks
    out["ok"] = all(checks.values())
    emit("serve router", **out)
    if not out["ok"]:
        raise PhaseError("serve router failed its checks: "
                         f"{[k for k, v in checks.items() if not v]}")
    return out


# ------------------------------------------- the fleet's control plane

THROUGHPUT = {"n_slots": 8, "max_len": 512, "chunk": 256, "block_size": 128}
THROUGHPUT_SUFFIXES = (8, 40, 72, 104)
THROUGHPUT_BUDGETS = (4, 8)


def _flash_zero() -> None:
    """Set every flash kernel's launch count to 0."""
    from horovod_tpu_torch.parallel import flash_attention as fa

    fa.launches = 0
    fa.fwd_launches_by_dim.update({64: 0, 128: 0})
    fa.dq_launches = fa.dkv_launches = 0


def _throughput_requests(cfg, seed: int):
    """16 requests in four families: a random 128-token prefix each (one
    full block, so the prefix cache can reuse it), then a random 8-token
    phrase repeated to each length in ``THROUGHPUT_SUFFIXES`` (n-grams the
    prompt-lookup drafter can find): one 256-token window a prompt.
    Budgets alternate 4 and 8, so each fixed batch of eight decodes to 8."""
    import numpy as np

    from horovod_tpu_torch.serving import Request

    rng = np.random.RandomState(seed + 13)
    fams = [rng.randint(0, cfg.vocab_size, THROUGHPUT["block_size"])
            .tolist() for _ in range(4)]
    reqs = []
    for i in range(16):
        phrase = rng.randint(0, cfg.vocab_size, 8).tolist()
        n = THROUGHPUT_SUFFIXES[i // 4]
        reqs.append(Request(prompt=fams[i % 4] + (phrase * 13)[:n],
                            max_new_tokens=THROUGHPUT_BUDGETS[i % 2]))
    return reqs


def _divergence(params, cfg, prompt, a, b) -> dict:
    """Where two greedy token lists of one request first differ: the
    tokens before are equal by construction, and one target ``forward``
    over the prompt and that common prefix gives the logits of the two
    competing tokens; their gap, as a share of max|logit|, must be at most
    ``DIVERGE_RTOL``."""
    import torch

    from horovod_tpu_torch.models import llama

    p = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if p is None:                            # one is a prefix of the other
        return {"position": min(len(a), len(b)), "gap_share": None,
                "ok": False}
    toks = torch.as_tensor([list(prompt) + list(a[:p])], device=DEV)
    with torch.no_grad():
        hidden = llama.forward(params, toks, cfg, return_hidden=True)
        logits = (hidden[0, -1] @ params["lm_head"].to(cfg.dtype)).float()
    gap = float((logits[a[p]] - logits[b[p]]).abs() / logits.abs().max())
    return {"position": p, "tokens": [a[p], b[p]], "gap_share": gap,
            "ok": gap <= DIVERGE_RTOL}


def _same_or_consistent(params, cfg, reqs, a, b) -> dict:
    """Two token lists a request: how many are equal bit for bit.  Where
    they differ, the first differing position must be a near-tie of the
    target (``_divergence``, within ``DIVERGE_RTOL``), and after it each
    side, now in a context of its own, must be greedy-consistent
    (``_greedy_consistency`` over its whole output, within the looser
    ``MARGIN_RTOL``)."""
    differ = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
    splits = [_divergence(params, cfg, reqs[i].prompt, a[i], b[i])
              for i in differ]
    prompts = [reqs[i].prompt for i in differ]
    consistency = {
        side: _greedy_consistency(params, cfg, prompts,
                                  [toks[i] for i in differ])
        for side, toks in (("a", a), ("b", b))} if differ else {}
    return {"requests": len(a), "bit_equal": len(a) - len(differ),
            "differ": differ, "divergence": splits,
            "diverge_rtol": DIVERGE_RTOL, "consistency": consistency,
            "ok": len(a) == len(b) == len(reqs)
            and all(d["ok"] for d in splits)
            and all(c["ok"] for c in consistency.values())}


def phase_throughput(cfg, params, seed: int) -> dict:
    """The engine's bench arms at Llama-3-8B width on the serving phases'
    weights: ``measure_throughput`` (the engine against fixed batches of
    plain ``generate``, and the min-of-2 overhead of each measurement
    plane), ``measure_prefix_throughput`` and ``measure_spec_throughput``,
    each on the same 16 requests (``_throughput_requests``), 8 slots of
    512 positions, 256-token windows, 128-token blocks.  Checks: every
    overhead finite, ``serve_mfu`` in (0, 1), budgets exact, prefix hits
    and cache-on tokens equal cache-off's (the function asserts it); serve
    against static and speculative against plain tokens are compared
    request for request: equal, or first split at a near-tie of the target
    and greedy-consistent after it (``_same_or_consistent``; the bit-equal
    count is recorded).  The flash forward's launches are
    counted from 0 around each function: the static baseline's prefills
    launch it once a layer, for the warm-up and the timed pass of each
    fixed batch; the engines' paged programs launch none.  The overhead
    percentages are recorded but unresolved: a pass decodes 96 tokens
    behind 16 prefills of 256, and two runs of this phase on one card
    differed by up to 23 points."""
    import torch

    from horovod_tpu_torch.parallel import flash_attention as fa
    from horovod_tpu_torch.serving_scheduler import (
        measure_prefix_throughput, measure_spec_throughput,
        measure_throughput)

    reqs = _throughput_requests(cfg, seed)
    emit("depth cut", path="serve throughput", requests=len(reqs),
         budgets=list(THROUGHPUT_BUDGETS), widths="full")
    seconds = {}
    _flash_zero()
    t0 = time.perf_counter()
    thr = measure_throughput(params, cfg, reqs, keep_tokens=True,
                             **THROUGHPUT)
    seconds["measure_throughput"] = time.perf_counter() - t0
    static_launches = fa.fwd_launches_by_dim[128]
    other_launches = fa.launches - static_launches
    serve_tokens = thr.pop("serve_tokens")
    static_tokens = thr.pop("static_tokens")
    _flash_zero()
    t0 = time.perf_counter()
    prefix = measure_prefix_throughput(params, cfg, reqs, **THROUGHPUT)
    seconds["measure_prefix_throughput"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    spec = measure_spec_throughput(params, cfg, reqs, draft_k=4,
                                   keep_tokens=True, **THROUGHPUT)
    seconds["measure_spec_throughput"] = time.perf_counter() - t0
    engine_launches = fa.launches
    spec_tokens = spec.pop("serve_spec_tokens")
    plain_tokens = spec.pop("serve_spec_plain_tokens")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    static_cmp = _same_or_consistent(params, cfg, reqs, serve_tokens,
                                     static_tokens)
    spec_cmp = _same_or_consistent(params, cfg, reqs, spec_tokens,
                                   plain_tokens)
    seconds["oracles"] = time.perf_counter() - t0
    want = cfg.n_layers * thr["static_batches"] * 2
    overheads = {k: thr[k] for k in (
        "serve_metrics_overhead_pct", "monitor_overhead_pct",
        "serve_profiler_overhead_pct", "serve_health_overhead_pct",
        "serve_trace_overhead_pct", "device_telemetry_overhead_pct")}
    mfu = thr["serve_mfu"]
    checks = {
        "serve_tokens_equal_static_or_split_at_near_tie": static_cmp["ok"],
        "spec_tokens_equal_plain_or_split_at_near_tie": spec_cmp["ok"],
        "budgets_exact": [len(t) for t in serve_tokens]
        == [r.max_new_tokens for r in reqs]
        and [len(t) for t in spec_tokens]
        == [r.max_new_tokens for r in reqs],
        "overheads_finite": all(math.isfinite(v)
                                for v in overheads.values()),
        "serve_mfu_in_0_1": mfu is not None and 0.0 < mfu < 1.0,
        "static_launches_exact": static_launches == want
        and other_launches == 0,
        "engines_launch_no_flash": engine_launches == 0,
        "prefix_hits": prefix["serve_prefix_hit_rate"] > 0,
    }
    out = {"engine": THROUGHPUT, "n_layers": cfg.n_layers,
           "n_requests": len(reqs), "seconds": seconds,
           "serve_vs_static_ratio": thr["serve_vs_static_ratio"],
           "serve_tokens_per_sec": thr["serve_tokens_per_sec"],
           "static_tokens_per_sec": thr["static_tokens_per_sec"],
           "serve_prefix_speedup": prefix["serve_prefix_speedup"],
           "serve_prefix_hit_rate": prefix["serve_prefix_hit_rate"],
           "serve_spec_vs_plain_ratio": spec["serve_spec_vs_plain_ratio"],
           "overheads_pct": overheads, "overheads_resolved": False,
           "serve_mfu": mfu,
           "serve_vs_static_tokens": static_cmp,
           "spec_vs_plain_tokens": spec_cmp,
           "launches": {"flash_fwd_d128": static_launches,
                        "expected": want,
                        "static_batches": thr["static_batches"],
                        "passes": 2, "engines": engine_launches,
                        "window": "measure_throughput (its static "
                                  "baseline) alone"},
           "measure_throughput": thr, "measure_prefix_throughput": prefix,
           "measure_spec_throughput": spec,
           "checks": checks, "ok": all(checks.values())}
    emit("serve throughput", **out)
    if not out["ok"]:
        raise PhaseError("serve throughput failed its checks: "
                         f"{[k for k, v in checks.items() if not v]}")
    return out


LOAD_ENGINE = {"n_slots": 16, "max_len": 128, "chunk": 64}
LOAD_PROBE_RPS = 64.0
LOAD_PROBE_S = 1.0
LOAD_LADDER = (0.5, 1.0, 2.0, 4.0)   # × the probe rung's served rate
LOAD_MIN_N = 20                      # arrivals every rung must hold
LOAD_MAX_S = 60.0


def _rung_schedule(mix, seed: int, i: int, rate: float, duration: float):
    """Rung ``i``'s Poisson schedule, rebuilt as ``measure_saturation``
    builds it: a pure function of the seed, rung index, rate and
    duration."""
    from horovod_tpu_torch.loadgen import build_schedule, resolve_process

    rs = seed * 8191 + 1000003 * (i + 1)
    return rs, build_schedule(resolve_process("poisson", rate, rs), mix,
                              duration, rs)


def _load_duration(mix, seed: int, ladder) -> float:
    """The shortest rung length, in steps of 0.5 s, at which every rung's
    schedule holds ``LOAD_MIN_N`` arrivals (known before a request is
    sent, the schedules being pure)."""
    d = 0.5
    while d <= LOAD_MAX_S:
        if all(len(_rung_schedule(mix, seed, i, rate, d)[1]) >= LOAD_MIN_N
               for i, rate in enumerate(ladder)):
            return d
        d += 0.5
    raise PhaseError(f"no rung length up to {LOAD_MAX_S} s gives "
                     f"{LOAD_MIN_N} arrivals at {ladder} rps")


def phase_load(cfg, params, seed: int) -> dict:
    """``measure_saturation(http=True)`` at Llama-3-8B width: two
    replicas (16 slots × 128 positions, 64-token windows, prefix cache) on
    the serving phases' weights behind the HTTP front door,
    ``DEFAULT_TENANTS`` arriving as Poisson.  A probe rung of
    ``LOAD_PROBE_RPS`` for ``LOAD_PROBE_S`` measures what the fleet serves
    (OK requests over the rung's makespan); the reported ladder is that
    rate times ``LOAD_LADDER``, past capacity, and each rung lasts as long
    as it takes every rung to hold ``LOAD_MIN_N`` arrivals.  Checks: each
    rung's ``schedule_digest`` equals the schedule rebuilt from the seed,
    rung index, rate and duration; every rung holds ``LOAD_MIN_N``
    requests and each is answered; the knee's attribution tiles its e2e
    (coverage 1 to float rounding); the knee lies below the top rung (the
    ladder passed it); the top rung's p99 TTFT exceeds the bottom's (the
    queue past capacity shows); and a ``CapacityAdvisor`` built without a
    ``load_report=`` reads the knee from ``serve_load_report.json`` under
    ``HVD_TORCH_BENCH_CACHE``.  The report's own p99-TTFT monotone flag is
    recorded."""
    import tempfile

    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.alerts import CapacityAdvisor
    from horovod_tpu_torch.loadgen import (
        DEFAULT_TENANTS, RequestMix, measure_saturation, schedule_digest)
    from horovod_tpu_torch.serving_scheduler import ServeEngine
    from horovod_tpu_torch.timeseries import MetricsSampler

    engines = [ServeEngine(params, cfg, prefix_cache=True, sampler=False,
                           metrics=metrics.MetricsRegistry(event_log=None),
                           **LOAD_ENGINE) for _ in range(2)]
    kw = dict(engines=engines, seed=seed, process="poisson",
              timeout_s=300.0, http=True)
    probe = measure_saturation(ladder=(LOAD_PROBE_RPS,), keep_records=True,
                               duration_s=LOAD_PROBE_S, **kw)
    oks = [r for r in probe["records"][0] if r["status"] == "OK"]
    makespan = max(r["sched_t"] + r["e2e_s"] for r in oks)
    capacity = len(oks) / makespan
    ladder = tuple(round(capacity * f, 3) for f in LOAD_LADDER)
    mix = RequestMix(DEFAULT_TENANTS, seed)
    duration = _load_duration(mix, seed, ladder)
    print(f"serve load: probe {LOAD_PROBE_RPS} rps served "
          f"{capacity:.3f} rps; ladder {ladder} rps, {duration} s a rung",
          flush=True)
    emit("depth cut", path="serve load", rungs=len(LOAD_LADDER),
         of="4 (the harness's default ladder)", duration_s=duration,
         min_requests_a_rung=LOAD_MIN_N, widths="full")
    rep = measure_saturation(ladder=ladder, duration_s=duration, **kw)
    digests = []
    for i, (rate, rung) in enumerate(zip(ladder, rep["rungs"])):
        rs, sched = _rung_schedule(mix, seed, i, rate, duration)
        digest = schedule_digest(sched)
        digests.append({"rate": rate, "rung_seed": rs, "n": len(sched),
                        "digest": digest,
                        "equal": (digest == rung["schedule_digest"]
                                  and len(sched) == rung["n"])})
    cache = tempfile.mkdtemp(prefix="hvd_load_")
    with open(os.path.join(cache, "serve_load_report.json"), "w") as f:
        json.dump(rep, f)
    with _env({"HVD_TORCH_BENCH_CACHE": cache}):
        reg = metrics.MetricsRegistry(event_log=None)
        advisor = CapacityAdvisor(MetricsSampler(reg, sample_s=1.0),
                                  registry=reg)
        knee = advisor.load_knee()
    rungs = rep["rungs"]
    cov = rep["serve_load_attr_coverage_knee"]
    checks = {
        "digests_equal_rebuilt": all(d["equal"] for d in digests),
        "every_rung_holds_min_n": all(r["n"] >= LOAD_MIN_N for r in rungs),
        "all_requests_answered": all(r["timeout_rate"] == 0.0
                                     for r in rungs),
        "attr_coverage_1": abs(cov - 1.0) <= 1e-6,
        "knee_below_top_rung": 0 <= rep["knee_index"] < len(ladder) - 1,
        "overload_raises_p99_ttft":
            rungs[-1]["p99_ttft_s"] > rungs[0]["p99_ttft_s"],
        "advisor_reads_knee": knee is not None
        and knee.get("serve_load_knee_goodput_rps")
        == rep["serve_load_knee_goodput_rps"],
    }
    out = {"engine": LOAD_ENGINE, "replicas": 2, "n_layers": cfg.n_layers,
           "probe_rps": LOAD_PROBE_RPS, "probe_s": LOAD_PROBE_S,
           "probe_requests": len(probe["records"][0]),
           "probe_served_rps": capacity, "ladder": list(ladder),
           "duration_s": duration, "digests": digests,
           "report": {k: v for k, v in rep.items() if k != "rungs"},
           "rungs": [{k: r[k] for k in (
               "offered_rps", "n", "statuses", "ok_rate", "goodput",
               "goodput_rps", "p50_ttft_s", "p99_ttft_s", "p50_tpot_s",
               "p99_tpot_s", "p50_e2e_s", "p99_e2e_s", "schedule_digest")}
               | {"attribution": r["attribution"]} for r in rungs],
           "checks": checks, "ok": all(checks.values())}
    emit("serve load", **out)
    if not out["ok"]:
        raise PhaseError("serve load failed its checks: "
                         f"{[k for k, v in checks.items() if not v]}")
    return out


CHAOS_ENGINE = {"n_slots": 2, "max_len": 1024, "chunk": 64}
# Clean waves after heal: a storm's FAILED requests leave each replica's
# goodput window (8 terminals) only as fresh ones displace them, and the
# replicas share one serve.goodput gauge; one wave of four requests over
# three replicas can leave the burn alerts firing past the drain (seen in
# one of two CPU runs), so eight are served, as in the reference's
# alert-oracle test.
CHAOS_RECOVERY_WAVES = 8
POOL_RTOL = 0.01
# The allocator's change across a clone also counts the other replicas'
# activations, allocated and freed while they serve (−7.2 % of a pool at
# worst on the card so far).
ALLOC_RTOL = 0.25


def _allocated() -> int:
    """Allocated bytes on the card once the dropped fleets' reference
    cycles (router ↔ replicas ↔ supervisor) are collected."""
    import gc

    import torch

    gc.collect()
    return torch.cuda.memory_allocated()


def _storages(root, device) -> dict:
    """``data_ptr → bytes`` of every storage on ``device`` reachable from
    ``root``: through lists, tuples, sets, deques and dicts, and through
    the attributes (``__dict__`` and ``__slots__``) of the port's own
    objects, so the paged pool, its tables and whatever the engine's
    planes, sampler, tracer and caches hold are all found."""
    import collections

    import torch

    found: dict = {}
    seen: set = set()
    stack = [root]
    while stack:
        x = stack.pop()
        if id(x) in seen:
            continue
        seen.add(id(x))
        if isinstance(x, torch.Tensor):
            if x.device == device:
                st = x.untyped_storage()
                found[st.data_ptr()] = st.nbytes()
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple, set, frozenset, collections.deque)):
            stack.extend(x)
        elif type(x).__module__.startswith("horovod_tpu_torch"):
            stack.extend(getattr(x, "__dict__", {}).values())
            for cls in type(x).__mro__:
                slots = getattr(cls, "__slots__", ())
                for name in (slots,) if isinstance(slots, str) else slots:
                    if hasattr(x, name):
                        stack.append(getattr(x, name))
    return found


@contextlib.contextmanager
def _clone_costs():
    """Record what each ``clone_engine`` (a respawn or a grow) costs on the
    card: the bytes of the storages reachable from the clone and not from
    the engine it was cloned from (``_storages``; the weights are shared),
    beside its KV pool's bytes, and the allocator's change across the call
    (which also counts what the other replicas allocate and free
    meanwhile: they serve on while the poller respawns)."""
    import torch

    from horovod_tpu_torch import supervisor

    costs: list = []
    original = supervisor.clone_engine

    def measured(eng):
        sync()
        before = torch.cuda.memory_allocated()
        clone = original(eng)
        sync()
        delta = torch.cuda.memory_allocated() - before
        old = _storages(eng, eng.device)
        new = _storages(clone, eng.device)
        costs.append({
            "owned_bytes": sum(n for ptr, n in new.items()
                               if ptr not in old),
            "pool_bytes": clone.memory_report()["kv"]["total_bytes"],
            "allocator_delta_bytes": delta,
            "shares_weights": clone.params is eng.params})
        return clone

    supervisor.clone_engine = measured
    try:
        yield costs
    finally:
        supervisor.clone_engine = original


def _pool_checks(name: str, costs: list) -> dict:
    """Each clone shares the weights, holds one pool's bytes of its own
    within ``POOL_RTOL``, and moved the allocator by one pool within
    ``ALLOC_RTOL`` (a copy of even one layer's weights, 436 MB, is more
    than that)."""
    return {f"{name}_clone_{i}_costs_one_pool":
            c["shares_weights"]
            and abs(c["owned_bytes"] - c["pool_bytes"])
            <= POOL_RTOL * c["pool_bytes"]
            and abs(c["allocator_delta_bytes"] - c["pool_bytes"])
            <= ALLOC_RTOL * c["pool_bytes"] for i, c in enumerate(costs)}


def phase_chaos(cfg, params, seed: int) -> dict:
    """The fleet's chaos campaigns at Llama-3-8B width on the serving
    phases' weights (engines of 2 slots × 1024 positions, 64-token
    windows; the workload is the reference's 20-token prompts):
    ``run_campaign`` on three replicas with the alert oracle and
    ``CHAOS_RECOVERY_WAVES`` clean waves after heal (a seeded storm over
    the engine's fault sites and one replica kill), ``run_autoscale_campaign`` (a faulted grow held, a
    grow that serves, a scale-down under load that fails open and
    retires), then ``measure_autoscale_goodput`` (a Bursty step served
    before and after a grow).  ``memory_allocated`` before and after each
    (after a ``gc.collect()``); every ``clone_engine`` (a respawn or a
    grow) shares the weights, holds one KV pool of its own on the card
    within ``POOL_RTOL`` and moves the allocator by one pool within
    ``ALLOC_RTOL`` (``_clone_costs``)."""
    import torch

    from horovod_tpu_torch.autoscaler import measure_autoscale_goodput
    from horovod_tpu_torch.chaos import run_autoscale_campaign, run_campaign

    out: dict = {"engine": CHAOS_ENGINE, "n_layers": cfg.n_layers,
                 "pool_rtol": POOL_RTOL, "alloc_rtol": ALLOC_RTOL}
    checks: dict = {}
    memory: dict = {}
    torch.cuda.empty_cache()
    memory["before_campaign"] = _allocated()
    with _clone_costs() as costs:
        camp = run_campaign(params, cfg, seed=seed, n_replicas=3,
                            alert_oracle=True,
                            recovery_waves=CHAOS_RECOVERY_WAVES,
                            **CHAOS_ENGINE)
    torch.cuda.empty_cache()
    memory["after_campaign"] = _allocated()
    out["campaign"] = {k: camp[k] for k in (
        "seed", "n_requests", "n_ok", "ok_fraction", "faults_fired",
        "kills_fired", "respawns", "failovers", "sites_fired", "alerts",
        "oracles", "ok")}
    out["campaign_clones"] = costs
    checks["campaign_ok"] = camp["ok"]
    checks["campaign_oracles_all_true"] = all(camp["oracles"].values())
    checks["campaign_respawned"] = camp["respawns"] >= 1
    checks["campaign_clone_per_respawn"] = len(costs) >= camp["respawns"]
    checks.update(_pool_checks("campaign", costs))

    memory["before_autoscale"] = _allocated()
    with _clone_costs() as costs:
        asc = run_autoscale_campaign(params, cfg, **CHAOS_ENGINE)
    torch.cuda.empty_cache()
    memory["after_autoscale"] = _allocated()
    out["autoscale"] = {k: asc[k] for k in (
        "n_requests", "n_ok", "grown_replicas", "routed_to_grown",
        "drain_forced", "dedups", "scale_ups", "scale_downs",
        "hold_faults", "failovers", "oracles", "ok")}
    out["autoscale"]["epoch"] = asc["epoch"]["generation"]
    out["autoscale_clones"] = costs
    checks["autoscale_ok"] = asc["ok"]
    checks["autoscale_grew_and_served"] = asc["oracles"]["grew_and_served"]
    checks["autoscale_retired_back"] = asc["oracles"]["drained_and_retired"]
    checks["autoscale_epoch_advanced_twice"] = \
        asc["epoch"]["generation"] == 2
    checks["autoscale_grow_cloned"] = len(costs) >= 1
    checks.update(_pool_checks("autoscale", costs))

    memory["before_goodput"] = _allocated()
    with _clone_costs() as costs:
        good = measure_autoscale_goodput(params, cfg, seed=seed,
                                         n_slots=4, max_len=1024, chunk=64)
    torch.cuda.empty_cache()
    memory["after_goodput"] = _allocated()
    out["autoscale_goodput"] = good
    out["autoscale_goodput_clones"] = costs
    checks["goodput_scale_ok"] = good["serve_autoscale_scale_ok"]
    checks.update(_pool_checks("goodput", costs))
    out["memory_allocated_bytes"] = memory
    out["retention"] = good["serve_autoscale_goodput_retention"]
    out["checks"] = checks
    out["ok"] = all(checks.values())
    emit("serve chaos", **out)
    if not out["ok"]:
        raise PhaseError("serve chaos failed its checks: "
                         f"{[k for k, v in checks.items() if not v]}")
    return out


def phase_simfleet(seed: int) -> dict:
    """``run_sim_campaign`` at the reference's scale, host only: 200
    simulated replicas and 100,000 virtual requests through the port's
    router, supervisor, autoscaler and alert plane, with a crash storm, a
    partition wave, a straggler epidemic, a KV-exhaustion ramp and two
    scripted epoch bumps.  Every oracle and the reference's counts;
    the wall seconds are recorded, not held to a limit."""
    from horovod_tpu_torch.simfleet import run_sim_campaign

    t0 = time.perf_counter()
    rep = run_sim_campaign(seed=seed, n_replicas=200, n_requests=100000)
    wall = time.perf_counter() - t0
    checks = {
        **{f"oracle.{k}": v for k, v in rep["oracles"].items()},
        "ok": rep["ok"],
        "respawns_ge_10": rep["respawns"] >= 10,
        "failovers_ge_10": rep["failovers"] >= 10,
        "alerts_fired_and_resolved": bool(rep["alerts"]["fired"])
        and not rep["alerts"]["unresolved"],
        "shadow_evictions": rep["shadow_evictions"] > 0,
        "epoch_ge_2": rep["epoch"] >= 2,
        "scale": rep["n_replicas"] >= 200 and rep["n_requests"] >= 100000,
    }
    out = {"wall_s": wall, "report": rep, "checks": checks,
           "ok": all(checks.values())}
    emit("fleet simfleet", **out)
    if not out["ok"]:
        raise PhaseError("fleet simfleet failed its checks: "
                         f"{[k for k, v in checks.items() if not v]}")
    return out


# ------------------------------------------------------- elastic training

TP_WORLD = 2
TP_ENGINE = {"n_slots": 4, "max_len": 512, "chunk": 128, "block_size": 128}
TP_PROMPT = 128
TP_BUDGET = 16
TP_REQUESTS = 8
TP_TIMEOUT_S = 600.0


def _tp_requests(cfg, seed: int):
    """``TP_REQUESTS`` random prompts of ``TP_PROMPT`` tokens (one window
    and one block each), budget ``TP_BUDGET``."""
    import numpy as np

    from horovod_tpu_torch.serving import Request

    rng = np.random.RandomState(seed + 17)
    return [Request(prompt=rng.randint(0, cfg.vocab_size, TP_PROMPT).tolist(),
                    max_new_tokens=TP_BUDGET) for _ in range(TP_REQUESTS)]


def _gloo_cuda_probe(group) -> dict:
    """The two collectives of the sharded forward on card tensors through
    gloo, each against its known result: ``all_reduce`` of bf16 (the psums
    after ``wo`` and ``w_down``), ``all_gather_into_tensor`` of bf16 (the
    embedding's D-slice) and of f32 (the logits).  A refusal raises."""
    import torch
    import torch.distributed as dist

    n, r = dist.get_world_size(group), dist.get_rank(group)
    x = torch.full((4096,), r + 1.0, dtype=torch.bfloat16, device=DEV)
    dist.all_reduce(x, group=group)
    out = {"all_reduce_bf16": bool((x == n * (n + 1) / 2).all())}
    for name, dt in (("all_gather_bf16", torch.bfloat16),
                     ("all_gather_f32", torch.float32)):
        y = torch.full((4096,), float(r), dtype=dt, device=DEV)
        got = torch.empty(n * 4096, dtype=dt, device=DEV)
        dist.all_gather_into_tensor(got, y, group=group)
        want = torch.arange(n, device=DEV).repeat_interleave(4096).to(dt)
        out[name] = bool(torch.equal(got, want))
    return out


def _tp_serve(rank: int, seed: int) -> dict | None:
    """One rank of ``serve tp``: rank 0 leads, rank 1 follows."""
    import threading

    import torch
    from torch.utils import _pytree as pytree

    from horovod_tpu_torch import metrics as metrics_mod
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.parallel import flash_attention as fa
    from horovod_tpu_torch.parallel.mesh import tensor_parallel_mesh
    from horovod_tpu_torch.router import LocalReplica
    from horovod_tpu_torch.serving_scheduler import (ServeEngine,
                                                     measure_tp_throughput)

    t0 = time.perf_counter()
    mesh = tensor_parallel_mesh(TP_WORLD)
    gloo = _gloo_cuda_probe(mesh.group("tp"))
    if not all(gloo.values()):
        raise PhaseError(f"gloo gave wrong results on card tensors: {gloo}")
    cfg, full = _model(32, seed)
    shard = llama.shard_params(full, llama.param_partition_specs(cfg), rank,
                               TP_WORLD)
    if rank != 0:
        del full                # a follower keeps its shard only
        full = None
        torch.cuda.empty_cache()
    shard_bytes = sum(x.numel() * x.element_size()
                      for x in pytree.tree_leaves(shard))
    reqs = _tp_requests(cfg, seed)
    t_setup = time.perf_counter() - t0
    # the leader's tp = 1 engine runs on the full weights, its tp = 2
    # engine slices them; the follower brings its shard
    _flash_zero()
    meas = measure_tp_throughput(full if rank == 0 else shard, cfg, reqs,
                                 tp_sizes=(1, TP_WORLD), keep_tokens=True,
                                 **TP_ENGINE)
    engine_launches = fa.launches
    reg = metrics_mod.MetricsRegistry(event_log=None)
    eng = ServeEngine(shard, cfg, tp_size=TP_WORLD, metrics=reg,
                      monitor=False, sampler=False, **TP_ENGINE)
    if not eng.is_leader:
        eng.follow()
        return None
    rep = LocalReplica(eng, name="tp2")
    try:
        done, box = threading.Event(), {}
        rep.submit(reqs[0], lambda res: (box.update(res=res), done.set()))
        if not done.wait(timeout=300):
            raise PhaseError("the tensor-parallel replica never answered")
        probe = rep.probe()
    finally:
        rep.stop()
    replica_tokens = [int(t) for t in box["res"]]
    snap = eng.metrics_snapshot()
    sizes = eng.compile_cache_sizes()
    eng.close()
    g = snap["gauges"]
    identity = {k: g[f"kv.shard_{k}_bytes"] * TP_WORLD == g[f"kv.{k}_bytes"]
                for k in ("block", "total", "free", "referenced", "cached")}
    # the oracle: tp = 2 against tp = 1 request for request, and every
    # tp = 2 token greedy-consistent in one target pass (the flash prefill)
    a = meas.pop("serve_tp1_tokens")
    b = meas.pop(f"serve_tp{TP_WORLD}_tokens")
    _flash_zero()
    greedy = _greedy_consistency(full, cfg, [r.prompt for r in reqs], b)
    oracle_launches = fa.fwd_launches_by_dim[128]
    split = _same_or_consistent(full, cfg, reqs, a, b)
    return {
        "gloo_cuda": gloo, "setup_s": t_setup, "measure": meas,
        "tokens_split": split, "greedy": greedy,
        "replica_tokens_equal": replica_tokens == b[0],
        "probe_tp_size": probe["tp_size"],
        "signatures": sizes, "shard_gauge_identity": identity,
        "gauges": {k: g[k] for k in ("tp.size", "kv.shard_block_bytes",
                                     "kv.block_bytes", "kv.shard_total_bytes",
                                     "kv.total_bytes")},
        "shard_param_bytes": shard_bytes,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "engine_launches": engine_launches,
        "oracle_launches": oracle_launches,
    }


def _tp_rank(rank: int, port: int, seed: int, out: str) -> None:
    """A spawned rank: a gloo world of ``TP_WORLD`` processes on the one
    card (NCCL refuses two ranks on one GPU), card tensors on both."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=TP_WORLD)
    try:
        res = _tp_serve(rank, seed)
    finally:
        dist.destroy_process_group()
    if res is not None:
        with open(out, "w") as f:
            json.dump(res, f)


def phase_tp(seed: int) -> dict:
    """``serve tp``: Llama-3-8B at full width and depth through a
    tensor-parallel ``ServeEngine`` of two ranks, two processes on the one
    card over gloo; ``measure_tp_throughput`` at tp 1 and 2, a tp = 2
    engine behind a ``LocalReplica``, the tokens against tp = 1's."""
    import socket
    import tempfile

    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = os.path.join(tempfile.mkdtemp(prefix="serve_tp_"), "leader.json")
    ctx = mp.start_processes(_tp_rank, args=(port, seed, out),
                             nprocs=TP_WORLD, join=False,
                             start_method="spawn")
    try:
        deadline = time.monotonic() + TP_TIMEOUT_S
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                raise PhaseError(f"serve tp still running after "
                                 f"{TP_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    with open(out) as f:
        res = json.load(f)
    meas = res["measure"]
    checks = {
        "gloo_cuda": all(res["gloo_cuda"].values()),
        "tokens_equal_or_near_tie": res["tokens_split"]["ok"],
        "greedy_consistent": res["greedy"]["ok"],
        "replica_tokens_equal": res["replica_tokens_equal"],
        "shard_gauge_identity": all(res["shard_gauge_identity"].values()),
        "one_signature_a_program": set(res["signatures"].values()) == {1},
        "probe_tp_size": res["probe_tp_size"] == TP_WORLD,
        "ran_1_and_2": meas["serve_tp_sizes"] == [1, TP_WORLD],
        "engine_launches_zero": res["engine_launches"] == 0,
        "oracle_launches": res["oracle_launches"] == 32 * TP_REQUESTS,
    }
    wall = time.perf_counter() - t0
    emit("serve tp", ok=all(checks.values()), checks=checks,
         world=TP_WORLD, backend="gloo", engine=TP_ENGINE,
         requests=TP_REQUESTS, prompt=TP_PROMPT, budget=TP_BUDGET,
         tokens_per_sec={tp: meas[f"serve_tp{tp}_tokens_per_sec"]
                         for tp in meas["serve_tp_sizes"]},
         scaling_eff=meas[f"serve_tp{TP_WORLD}_scaling_eff"],
         tokens_bit_equal=res["tokens_split"]["bit_equal"],
         divergence=res["tokens_split"]["divergence"],
         worst_gap_share=res["greedy"]["worst_gap_share"],
         gloo_cuda=res["gloo_cuda"], gauges=res["gauges"],
         shard_param_bytes=res["shard_param_bytes"],
         leader_max_memory_allocated=res["max_memory_allocated"],
         setup_s=res["setup_s"], wall_s=wall,
         launches={"flash_fwd_d128": res["oracle_launches"]})
    if not all(checks.values()):
        raise PhaseError(f"serve tp checks failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    return {"launches": {"flash_fwd_d128": res["oracle_launches"]}}


def _keras_probe() -> dict:
    """Whether ``import keras`` works here on its torch backend (in a
    child process, so this one imports no keras before ``train keras``)."""
    env = dict(os.environ, KERAS_BACKEND="torch")
    r = subprocess.run(
        [sys.executable, "-c",
         "import keras; print(keras.__version__, keras.backend.backend())"],
        env=env, capture_output=True, text=True, timeout=300)
    if r.returncode == 0 and r.stdout.strip():
        version, backend = r.stdout.split()[-2:]
        return {"importable": backend == "torch", "version": version,
                "backend": backend}
    tail = (r.stderr.strip().splitlines() or ["no output"])[-1]
    return {"importable": False, "error": tail[-300:]}


KERAS_EPOCHS = 2


def phase_keras(probe: dict) -> dict:
    """``train keras``: the twin of ``examples/keras_mnist_advanced.py``
    (``horovod_tpu_torch.examples.keras_mnist_advanced``) on the card
    through Keras 3's torch backend, 2 epochs of 4,096 samples with the
    broadcast, metric-average, warm-up and schedule callbacks: the loss
    falls, the weights are card tensors and moved from their initial
    values, and ``hvd.load_model`` of the saved model returns the
    optimizer wrapped, its weights and iterations equal.  Where keras does
    not import, the phase is reported skipped (the card part of the Keras
    frontend is then untested)."""
    if not probe["importable"]:
        emit("train keras",
             skipped=f"keras not importable: {probe.get('error')}")
        return {"skipped": True}
    import tempfile

    import numpy as np

    from horovod_tpu_torch.examples import keras_mnist_advanced as example

    os.environ["KERAS_BACKEND"] = "torch"
    import horovod_tpu_torch.keras as hvd

    keras = hvd._keras()
    keras.utils.set_random_seed(0)
    initial = [np.asarray(w) for w in example.build_model(keras)
               .get_weights()]
    path = os.path.join(tempfile.mkdtemp(prefix="keras_"), "mnist.keras")
    t0 = time.perf_counter()
    out = example.main(["--epochs", str(KERAS_EPOCHS), "--samples", "4096",
                        "--warmup-epochs", "1", "--save", path])
    fit_s = time.perf_counter() - t0
    model, hist = out["model"], out["history"]
    loaded = hvd.load_model(path)
    devices = {str(v.value.device) for v in model.trainable_variables}
    checks = {
        "finite": all(math.isfinite(x) for x in hist["loss"]),
        "decreasing": hist["loss"][-1] < hist["loss"][0],
        "weights_on_the_card": all(d.startswith("cuda") for d in devices),
        "weights_moved": any(not np.array_equal(a, b)
                             for a, b in zip(initial, out["weights"])),
        "load_model_wraps": isinstance(loaded.optimizer,
                                       hvd._DistributedApplyMixin),
        "load_model_weights_equal": all(
            np.array_equal(np.asarray(a), b)
            for a, b in zip(loaded.get_weights(), out["weights"])),
        "load_model_iterations": int(loaded.optimizer.iterations.numpy())
        == int(model.optimizer.iterations.numpy()),
    }
    emit("train keras", ok=all(checks.values()), checks=checks,
         keras=probe["version"], epochs=KERAS_EPOCHS, samples=4096,
         history={k: [float(x) for x in v] for k, v in hist.items()},
         devices=sorted(devices), fit_s=fit_s,
         images_per_s=KERAS_EPOCHS * 4096 / fit_s)
    if not all(checks.values()):
        raise PhaseError(f"train keras failed its checks: {checks}")
    return {"skipped": False}


ELASTIC_STEPS = 8
ELASTIC_FAIL_AT = 5            # the engine dies before this step's backward
ELASTIC_COMMIT_EVERY = 2


def _elastic_run(model, opt, batch, ckpt_dir, fail_at: int | None) -> dict:
    """``ELASTIC_STEPS`` steps of the hook route inside ``elastic.run`` with
    a ``TorchState`` committing every ``ELASTIC_COMMIT_EVERY`` steps
    (advance-then-commit).  ``fail_at``: on the first entry, the live
    engine's ``_shutdown`` flag is set before that step, so the step's first
    gradient hook raises ``HorovodInternalError`` at the engine's own site.
    Commits, restores and the reinit are timed."""
    from horovod_tpu_torch import elastic, torch_elastic
    from horovod_tpu_torch import torch_frontend as F
    from horovod_tpu_torch.ops import eager as E

    times = {"commit_s": [], "restore_s": [], "reinit_s": []}

    class _Timed(torch_elastic.TorchState):
        def commit(self):
            sync()
            t0 = time.perf_counter()
            super().commit()
            times["commit_s"].append(time.perf_counter() - t0)

        def restore(self):
            t0 = time.perf_counter()
            super().restore()
            sync()
            times["restore_s"].append(time.perf_counter() - t0)

    real_reinit = elastic._reinit

    def timed_reinit():
        t0 = time.perf_counter()
        real_reinit()
        times["reinit_s"].append(time.perf_counter() - t0)

    dopt = F.DistributedOptimizer(opt, model.named_parameters())
    state = _Timed(model=model, optimizer=opt, ckpt_dir=ckpt_dir, step=0)
    entries: list = []
    losses: list = []

    @elastic.run
    def train(st):
        entries.append(st.step)
        while st.step < ELASTIC_STEPS:
            if fail_at is not None and st.step == fail_at \
                    and len(entries) == 1:
                E._engine()._shutdown.set()
            dopt.zero_grad()
            loss = _cross_entropy(model, batch)
            loss.backward()
            dopt.step()
            losses.append(float(loss.detach()))
            st.step += 1
            if st.step % ELASTIC_COMMIT_EVERY == 0:
                st.commit()

    elastic._reinit = timed_reinit
    try:
        train(state)
    finally:
        elastic._reinit = real_reinit
        dopt.remove_hooks()
    sync()
    return {"entries": entries, "losses": losses, "times": times,
            "commit_step": state.commit_step}


def phase_train_elastic(seed: int) -> dict:
    """Elastic training (``elastic.py``, ``torch_elastic.py``) on ViT-B/16
    at full size (bf16, flash: the D = 64 kernels), batch 64, AdamW, under
    the hook-driven ``torch_frontend.DistributedOptimizer`` at a world of
    one on NCCL.  An uninterrupted run of ``ELASTIC_STEPS`` steps with
    in-memory commits, then the same steps from the same weights with
    durable commits under ``$TMPDIR``, where the engine fails before step
    ``ELASTIC_FAIL_AT``: ``run`` reinitialises NCCL at a world of one,
    restores the step-4 commit and replays.  The final parameters and
    optimizer state must equal the uninterrupted run's bit for bit (cuDNN
    held to deterministic algorithms, as ``train eager``'s hook-versus-sync
    check is).  Then a fresh ``TorchState`` over a fresh model restores
    the durable commit after a full ``shutdown()`` and ``init()``."""
    import tempfile

    import torch

    from horovod_tpu_torch import basics, torch_elastic
    from horovod_tpu_torch.models.vit import ViT_B16
    from horovod_tpu_torch.parallel import flash_attention as fa

    def make(s):
        model = ViT_B16(dtype=torch.bfloat16, attn_impl="flash", device=DEV,
                        seed=s)
        return model, torch.optim.AdamW(model.parameters(), lr=1e-3,
                                        weight_decay=1e-4, fused=True)

    batch = _vision_batch(seed + 6, 224)
    ckpt = tempfile.mkdtemp(prefix="hvd_elastic_")
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        basics.init()
        model, opt = make(seed)
        clean = _elastic_run(model, opt, batch, None, None)
        want_model = {k: v.clone() for k, v in model.state_dict().items()}
        want_opt = opt.state_dict()
        del model, opt
        model, opt = make(seed)
        fa.launches = fa.dq_launches = fa.dkv_launches = 0
        hurt = _elastic_run(model, opt, batch, ckpt, ELASTIC_FAIL_AT)
        launches = {"flash_fwd": fa.launches, "flash_bwd_dq": fa.dq_launches,
                    "flash_bwd_dkv": fa.dkv_launches}
        got_opt = opt.state_dict()
        files = sorted(os.listdir(ckpt))
        newest = os.path.join(ckpt, f"step_{hurt['commit_step']}.pt")
        commit_bytes = os.path.getsize(newest)
        # a gang relaunch in one process: full shutdown, init, fresh objects
        basics.shutdown()
        basics.init()
        fresh_model, fresh_opt = make(seed + 1)
        fresh = torch_elastic.TorchState(model=fresh_model,
                                         optimizer=fresh_opt, ckpt_dir=ckpt,
                                         step=0)
        t0 = time.perf_counter()
        fresh.restore()
        sync()
        relaunch_restore_s = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = det

    def opt_equal(a, b):
        return a["param_groups"] == b["param_groups"] and all(
            torch.equal(a["state"][i][k], b["state"][i][k])
            for i in a["state"] for k in a["state"][i])

    depth = len(model.blocks)
    steps_run = len(hurt["losses"])
    checks = {
        "clean_single_entry": clean["entries"] == [0],
        "replayed_from_step_4": hurt["entries"] == [0, 4],
        "one_reinit": len(hurt["times"]["reinit_s"]) == 1,
        "params_bit_equal_uninterrupted": all(
            torch.equal(v, want_model[k])
            for k, v in model.state_dict().items()),
        "optimizer_bit_equal_uninterrupted": opt_equal(got_opt, want_opt),
        # steps 0-4, then the replay of steps 4-7 from the step-4 commit
        "losses_replay_equal": hurt["losses"]
        == clean["losses"][:ELASTIC_FAIL_AT] + clean["losses"][4:],
        "launches_every_step": all(
            v >= steps_run * depth for v in launches.values()),
        "durable_commits": files == [f"step_{i}.pt" for i in (1, 2, 3, 4)],
        "relaunch_restores_step": (fresh.step, fresh.commit_step)
        == (ELASTIC_STEPS, ELASTIC_STEPS // ELASTIC_COMMIT_EVERY),
        "relaunch_params_bit_equal": all(
            torch.equal(v, want_model[k])
            for k, v in fresh_model.state_dict().items()),
        "relaunch_optimizer_bit_equal": opt_equal(fresh_opt.state_dict(),
                                                  want_opt),
        "world_of_one_on_the_card": basics.size() == 1
        and basics.device().type == "cuda",
    }
    out = {"model": "ViT-B/16", "batch": VISION_BATCH, "steps": ELASTIC_STEPS,
           "fail_at": ELASTIC_FAIL_AT, "commit_every": ELASTIC_COMMIT_EVERY,
           "entries": hurt["entries"], "steps_run": steps_run,
           "commit_bytes": commit_bytes,
           "commit_s": hurt["times"]["commit_s"],
           "commit_s_in_memory": clean["times"]["commit_s"],
           "restore_s": hurt["times"]["restore_s"],
           "reinit_s": hurt["times"]["reinit_s"],
           "relaunch_restore_s": relaunch_restore_s,
           "launches": launches, "launches_total": launches,
           "bit_equality_under": "torch.backends.cudnn.deterministic=True",
           "checks": checks, "ok": all(checks.values())}
    for f in files:
        os.remove(os.path.join(ckpt, f))
    del model, opt, fresh_model, fresh_opt
    torch.cuda.empty_cache()
    emit("train elastic", **out)
    if not out["ok"]:
        raise PhaseError("train elastic failed its checks: "
                         f"{[k for k, v in checks.items() if not v]}")
    return out


def phase_train_hierarchical(seed: int) -> dict:
    """``HOROVOD_HIERARCHICAL_ALLREDUCE=1`` at a world of one: the engine
    warns that the world does not factor into nodes and reduces exactly as
    the flat route does (fused buckets, Sum and Average, f32, bf16, int64).
    The two-level route itself cannot run on one card: NCCL refuses two
    ranks on one GPU; the gloo worlds of ``tests/test_torch_hierarchical.py``
    hold it."""
    import contextlib as ctx
    import io

    import torch

    from horovod_tpu_torch import basics
    from horovod_tpu_torch.ops import collective_ops as C
    from horovod_tpu_torch.ops import eager as E

    g = torch.Generator(device=DEV).manual_seed(seed)
    f32 = [torch.randn(n, device=DEV, generator=g) for n in (5, 4099, 77)]
    buckets = [f32, [t.to(torch.bfloat16) for t in f32],
               [torch.arange(9, device=DEV, dtype=torch.int64)]]

    def reduce_all():
        return [t for op in (C.Sum, C.Average) for b in buckets
                for t in E.grouped_allreduce_eager(b, op=op)]

    basics.shutdown()
    err = io.StringIO()
    with _env({"HOROVOD_HIERARCHICAL_ALLREDUCE": "1"}):
        basics.init()
        with ctx.redirect_stderr(err):
            eng = E._engine()
        hier = reduce_all()
    basics.shutdown()
    basics.init()
    flat = reduce_all()
    checks = {"warned": "HOROVOD_HIERARCHICAL_ALLREDUCE=1 ignored"
              in err.getvalue(),
              "flat_route": eng.local_group is None and eng.hier_local == 1,
              "equal_to_flat": all(torch.equal(a, b)
                                   for a, b in zip(hier, flat))}
    out = {"world_size": basics.size(), "warning": err.getvalue().strip(),
           "two_level_route": "not run: NCCL refuses two ranks on one GPU; "
                              "held on 4-rank gloo worlds by "
                              "tests/test_torch_hierarchical.py",
           "checks": checks, "ok": all(checks.values())}
    emit("train hierarchical", **out)
    if not out["ok"]:
        raise PhaseError("train hierarchical failed its checks: "
                         f"{[k for k, v in checks.items() if not v]}")
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
        phase = "kernel batch_norm"
        kern_bn = phase_kernel_batch_norm(args.seed)
        phase = "serve generate"
        if args.n_layers != 32:
            emit("depth cut", path="serve", n_layers=args.n_layers, of=32)
        cfg, params = _model(args.n_layers, args.seed)
        gen = phase_generate(cfg, params, args.seed)
        phase = "examples"
        examples = phase_examples(cfg, params, info["nvidia_smi"])
        phase = "serve batcher"
        bat = phase_batcher(cfg, params, args.seed)
        phase = "serve speculative"
        spec = phase_speculative(cfg, params, args.seed)
        phase = "serve engine"
        phase_engine(cfg, params, args.seed)
        phase = "serve router"
        router = phase_router(cfg, params, args.seed)
        phase = "serve throughput"
        thr = phase_throughput(cfg, params, args.seed)
        phase = "serve load"
        phase_load(cfg, params, args.seed)
        phase = "serve chaos"
        phase_chaos(cfg, params, args.seed)
        del params
        torch.cuda.empty_cache()
        phase = "serve tp"
        tp = phase_tp(args.seed)
        phase = "fleet simfleet"
        phase_simfleet(args.seed)
        phase = "train"
        emit("depth cut", path="train", n_layers=args.train_layers, of=32)
        train = phase_train(args.train_layers, args.seed)
        torch.cuda.empty_cache()
        phase = "train sequence_parallel"
        emit("depth cut", path="train sharded", n_layers=SHARDED_LAYERS,
             of=32)
        sharded_cfg, sharded_params, sharded_batch = _sharded_model(args.seed)
        seqpar = phase_sequence_parallel(sharded_cfg, sharded_params,
                                         sharded_batch)
        phase = "train zero"       # then "train fsdp", in the same call
        sharded = phase_sharded_training(sharded_cfg, sharded_params,
                                         sharded_batch)
        del sharded_params
        torch.cuda.empty_cache()
        phase = "train pipeline_moe"
        phase_pipeline_moe(args.seed)
        torch.cuda.empty_cache()
        phase = "train resnet101"
        r101 = phase_resnet101(args.seed)
        phase = "train vit_b16"
        vit = phase_vit_b16(args.seed, tuple(args.vit_ab))
        phase = "train eager"
        eager = phase_train_eager(args.seed)
        phase = "train elastic"
        elastic = phase_train_elastic(args.seed)
        phase = "train hierarchical"
        phase_train_hierarchical(args.seed)
        phase = "train vgg16"
        phase_vgg16(args.seed)
        phase = "train inception_v3"
        inception = phase_inception_v3(args.seed)
        phase = "train compressed"
        phase_train_compressed(args.seed)
        phase = "fit mnist"
        phase_fit_mnist(args.seed)
        phase = "examples train"
        phase_examples_train(info["nvidia_smi"], args.seed)
        phase = "train keras"
        phase_keras(info["keras"])
    except Exception as e:  # every failure ends the run without a result
        emit(phase, ok=False, error=f"{type(e).__name__}: {e}")
        print(f"chip_smoke: phase {phase!r} failed", file=sys.stderr)
        traceback.print_exc()
        return 1
    finally:    # the phases share one process group, as a user's run does
        from horovod_tpu_torch import basics

        basics.shutdown()
    print(json.dumps({"kernels": _kernel_rows(build, kern, kern_bwd, gen, bat,
                                              spec, train, kern64, vit,
                                              eager, router, elastic,
                                              thr, (seqpar, sharded), tp,
                                              examples,
                                              (kern_bn, r101, inception))}),
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


def _kernel_rows(build, kern, kern_bwd, gen, bat, spec, train, kern64,
                 vit, eager, router, elastic, thr, sharded, tp,
                 examples, batch_norm) -> list[dict]:
    """One row per kernel and head dim: its launches on the main paths
    (D = 128: serving's generate, the ``llama_generate`` twin's prefills,
    batcher and the router's fleet,
    ``measure_throughput``'s static baseline, ``serve tp``'s oracle, the
    Llama train steps and the sharded phases' steps (sequence-parallel,
    replicated, ZeRO, FSDP); D =
    64: the ViT-B/16 train steps, synchronous, under the
    hook-driven optimizer of ``train eager`` and inside ``elastic.run`` in
    ``train elastic``), its largest error over the bf16 cases
    and its times at its main shape (the generate prefill for the forward,
    the Llama training shape for the backward pair, the ViT-B/16 shape at
    D = 64).  ``ms`` is device time; ``prev_ms`` the earlier mma.sync kernel
    (same run, same inputs); with the build's registers, spills and ptxas
    warnings and the Hopper kernels' shared memory a block.  The forward's
    row adds the same times at the training shape.  The last row is the
    fused batch-norm kernels': their launches in ``train resnet101`` and
    ``train inception_v3``, and their device ms a ResNet-50 batch-256 step
    (``kernel batch_norm``)."""
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
        "launches": (gen["launches"] + examples["launches"]
                     + bat["launches"]
                     + spec["launches"][128]
                     + router["launches"]["flash_fwd_d128"]
                     + thr["launches"]["flash_fwd_d128"]
                     + tp["launches"]["flash_fwd_d128"]
                     + train["launches"]["flash_fwd"]
                     + sum(p["launches"]["flash_fwd"] for p in sharded)),
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
        "example_prefill_shape": {
            "shape": examples["kernel_call"]["shape"],
            "o_max_abs_err": examples["kernel_call"]["o_max_abs_err"],
            **{k: examples["kernel_call"]["times"][k] for k in times}},
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
            "launches": (train["launches"][name]
                         + sum(p["launches"][name] for p in sharded)),
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
            "launches": (vit["launches_total"][name.removesuffix("_d64")]
                         + eager["vit_launches_total"][
                             name.removesuffix("_d64")]
                         + elastic["launches_total"][
                             name.removesuffix("_d64")]
                         + (spec["launches"][64] if grads == ("o",) else 0)),
            "max_abs_err": max(c[f"{g}_max_abs_err"] for c in cases
                               for g in grads if c["dtype"] == "bf16"),
            **{k: t[k] for k in keys}, "library_ms": lib,
            **{k: t[k] for k in prev_keys if k in t},
            **_ptx(build, kernel + instance),
        }
        if design == "cuda wgmma+tma":
            row["smem_bytes"] = fa.smem_bytes(fa._LIBRARY[entry], entry)
        if grads == ("o",):
            draft = next(c for c in kern64["fwd"]
                         if c["case"] == DRAFT_PREFILL_SHAPE[0])["times"]
            row["draft_prefill_shape"] = {
                "shape": DRAFT_PREFILL_SHAPE[0],
                **{k: draft[k] for k in keys + ("library_ms",)}}
        rows.append(row)
    rows.append(_batch_norm_row(build, *batch_norm))
    return rows


def _batch_norm_row(build, kern_bn, *runs) -> dict:
    """The fused batch-norm kernels (statistics, apply, backward reduce and
    element-wise) as one row: launches of each on the main paths, the
    largest errors against their plain arithmetic, and device ms a
    ResNet-50 batch-256 step (forward and backward pairs) against the bytes
    bound, the plain arithmetic, ATen's ``F.batch_norm`` and the chain the
    model ran before; the build's registers and spills of each kernel."""
    t = kern_bn["per_step"]
    return {
        "name": "batch_norm", "route": "cuda",
        "design": "cuda C++ 16-byte vectors, last-block merge",
        "source": "horovod_tpu_torch/csrc/batch_norm.cu",
        "replaces": None,       # XLA fuses flax's BatchNorm: no TPU kernel
        "launches": sum(r["bn_launches"]["stats_launches"] for r in runs),
        "launches_by_kernel": {k: sum(r["bn_launches"][k] for r in runs)
                               for k in BN_COUNTERS},
        "max_abs_err": {k: max(c[k] for c in kern_bn["cases"])
                        for k in ("y_max_abs_err", "dx_max_abs_err")},
        "shape": f"resnet50_b256_{kern_bn['norms']}_norms",
        "ms": t["kernel_ms"], "fwd_ms": t["kernel_fwd_ms"],
        "bwd_ms": t["kernel_bwd_ms"],
        "host_us_per_call": (t["host_fwd_us"] + t["host_bwd_us"])
                            / kern_bn["norms"],
        "plain_ms": t["plain_fwd_ms"] + t["plain_bwd_ms"],
        "library_ms": t["library_ms"], "chain_ms": t["chain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": "bytes",
        "tb_per_s": t["kernel_tb_per_s"],
        "share_of_bound": t["bound_pct"] / 100,
        "ptxas": {k: _ptx(build, k) for k in (
            "bn_stats_kernel", "bn_apply_kernel", "bn_bwd_reduce_kernel",
            "bn_bwd_elemt_kernel")},
    }


if __name__ == "__main__":
    sys.exit(main())
