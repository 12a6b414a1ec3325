"""PyTorch/CUDA port of ``horovod_tpu``, for NVIDIA Hopper cards.

The JAX package ``horovod_tpu`` is the reference; each module here mirrors
its counterpart's path and public names (``basics.py``, ``ops/``,
``optim/distributed_optimizer.py``, ``parallel/attention.py``,
``parallel/flash_attention.py``, ``models/llama.py``, ``serving.py``,
``serving_scheduler.py``) and is tested against it on the same inputs.
This package imports ``torch`` and never ``jax`` nor anything of
``horovod_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card and no explicit CPU request they raise (no silent fallback).
The TPU's three Pallas kernels, the flash-attention forward and its dQ and
dK/dV backward, are hand-written CUDA kernels (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``; at head dim 64 in bf16/fp16
``csrc/flash_fwd_d64.cu``, ``csrc/flash_bwd_d64.cu``) built with ``nvcc``
at first use into
``build/horovod_tpu_torch/``.  Training is data-parallel, one process per
GPU, Horovod style: ``basics.init`` → ``broadcast_parameters`` →
``DistributedOptimizer`` → ``make_train_step``.  Gradients may cross the
wire cast (fp16, bf16), quantized (int8, int4), top-k sparse, compressed
with state (``PowerSGDCompressor``, ``ErrorFeedback``) or combined by
Adasum, over the world or a ``ProcessSet``; ``fit`` checkpoints through
``ModelCheckpointCallback`` and resumes through ``restore_checkpoint``.

Horovod's own engine is here too (``ops/eager.py``): async handles
(``allreduce_async`` ... ``poll``, ``synchronize``), a background fusion
cycle, negotiation through the repo's native controller, the timeline and
autotune; ``EagerDistributedOptimizer`` and
``torch_frontend.DistributedOptimizer`` reduce gradients from backward
hooks; ``HOROVOD_HIERARCHICAL_ALLREDUCE`` reduces in two levels, within
and across nodes.  ``DistributedOptimizer`` here stays the synchronous
one, as ``horovod_tpu.DistributedOptimizer`` is the compiled one.
``elastic`` (and ``torch_frontend.elastic``'s ``TorchState``) commits,
restores and replays training after a ``HorovodInternalError``.  The
serving engine has a multi-replica front door, ``router.RouterServer``,
and ``supervisor.ReplicaSupervisor`` respawns its dead replicas.

Training also shards: ``make_zero_train_step`` (optimizer state at 1/n),
``make_fsdp_train_step`` (parameters too), sequence parallelism (the
Llama's ``ring``, ``ulysses`` and ``ulysses_flash`` engines over
``forward``'s ``sp_group``), ``parallel.pipeline`` and expert-parallel
``models.moe``, all over the differentiable collectives of
``parallel/_collectives.py``.
"""

from horovod_tpu_torch._device import resolve_device
from horovod_tpu_torch.basics import (HorovodInternalError,
                                      NotInitializedError, cross_rank,
                                      cross_size, init, is_initialized,
                                      local_rank, local_size,
                                      mpi_threads_supported, rank, shutdown,
                                      size)
from horovod_tpu_torch.ops.collective_ops import (Adasum, Average, Max, Min,
                                                  ProcessSet, Product, Sum,
                                                  allgather, allreduce,
                                                  alltoall, barrier,
                                                  broadcast, grouped_allreduce,
                                                  reducescatter)
from horovod_tpu_torch.ops.compression import Compression
from horovod_tpu_torch.ops.eager import (allgather_async, allreduce_async,
                                         alltoall_async, broadcast_async,
                                         engine_stats,
                                         grouped_allreduce_eager, join, poll,
                                         reducescatter_async, release,
                                         sparse_allreduce,
                                         sparse_allreduce_async, synchronize)
from horovod_tpu_torch.optim.eager_optimizer import EagerDistributedOptimizer
from horovod_tpu_torch.timeline import start_timeline, stop_timeline
from horovod_tpu_torch.ops.powersgd import ErrorFeedback, PowerSGDCompressor
from horovod_tpu_torch.optim.distributed_optimizer import (
    DistributedOptimizer, TrainStepResult, allgather_object,
    allreduce_gradients, broadcast_object, broadcast_optimizer_state,
    broadcast_parameters, make_train_step)
from horovod_tpu_torch.callbacks import (
    BroadcastGlobalVariablesCallback, Callback, LearningRateScheduleCallback,
    LearningRateWarmupCallback, MetricAverageCallback,
    ModelCheckpointCallback, average_metrics, multiplier_schedule,
    warmup_schedule)
from horovod_tpu_torch.checkpoint import (latest_checkpoint, list_checkpoints,
                                          load_model, restore_checkpoint,
                                          save_checkpoint,
                                          wait_for_checkpoints)
from horovod_tpu_torch.optim.zero import ZeroStepResult, make_zero_train_step
from horovod_tpu_torch.optim.fsdp import (FsdpStepResult,
                                          fsdp_partition_specs,
                                          make_fsdp_train_step, shard_params)
from horovod_tpu_torch.training import fit, make_eval_step
from horovod_tpu_torch.data import (ShardedLoader, prefetch_to_device,
                                    shard_indices)
from horovod_tpu_torch import elastic

__all__ = [
    "resolve_device", "HorovodInternalError", "NotInitializedError", "init",
    "is_initialized", "cross_rank", "cross_size", "mpi_threads_supported",
    "local_rank", "local_size", "rank", "shutdown", "size",
    "Adasum", "Average", "Max", "Min", "ProcessSet", "Product", "Sum",
    "allgather", "allreduce", "alltoall", "barrier", "broadcast",
    "grouped_allreduce", "reducescatter", "Compression", "allgather_async",
    "allreduce_async", "alltoall_async", "broadcast_async", "engine_stats",
    "grouped_allreduce_eager", "join", "poll", "reducescatter_async",
    "release", "sparse_allreduce", "sparse_allreduce_async", "synchronize",
    "EagerDistributedOptimizer", "start_timeline", "stop_timeline",
    "ErrorFeedback",
    "PowerSGDCompressor", "DistributedOptimizer", "TrainStepResult",
    "allgather_object", "allreduce_gradients", "broadcast_object",
    "broadcast_optimizer_state", "broadcast_parameters", "make_train_step",
    "BroadcastGlobalVariablesCallback", "Callback",
    "LearningRateScheduleCallback", "LearningRateWarmupCallback",
    "MetricAverageCallback", "ModelCheckpointCallback", "average_metrics",
    "multiplier_schedule", "warmup_schedule", "latest_checkpoint",
    "list_checkpoints", "load_model", "restore_checkpoint",
    "save_checkpoint", "wait_for_checkpoints", "ZeroStepResult",
    "make_zero_train_step", "FsdpStepResult", "fsdp_partition_specs",
    "make_fsdp_train_step", "shard_params", "fit", "make_eval_step",
    "ShardedLoader", "prefetch_to_device", "shard_indices", "elastic",
]
