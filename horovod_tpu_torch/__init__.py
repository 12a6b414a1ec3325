"""PyTorch/CUDA port of ``horovod_tpu``, for NVIDIA Hopper cards.

The JAX package ``horovod_tpu`` is the reference; each module here mirrors
its counterpart's path and public names (``basics.py``, ``ops/``,
``optim/distributed_optimizer.py``, ``parallel/attention.py``,
``parallel/flash_attention.py``, ``models/llama.py``, ``serving.py``) and
is tested against it on the same inputs.  This package imports ``torch``
and never ``jax`` nor anything of ``horovod_tpu``.

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
"""

from horovod_tpu_torch._device import resolve_device
from horovod_tpu_torch.basics import (NotInitializedError, init,
                                      is_initialized, local_rank, local_size,
                                      rank, shutdown, size)
from horovod_tpu_torch.ops.collective_ops import (Adasum, Average, Max, Min,
                                                  ProcessSet, Product, Sum,
                                                  allgather, allreduce,
                                                  alltoall, barrier,
                                                  broadcast, grouped_allreduce,
                                                  reducescatter)
from horovod_tpu_torch.ops.compression import Compression
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
from horovod_tpu_torch.training import fit, make_eval_step

__all__ = [
    "resolve_device", "NotInitializedError", "init", "is_initialized",
    "local_rank", "local_size", "rank", "shutdown", "size",
    "Adasum", "Average", "Max", "Min", "ProcessSet", "Product", "Sum",
    "allgather", "allreduce", "alltoall", "barrier", "broadcast",
    "grouped_allreduce", "reducescatter", "Compression", "ErrorFeedback",
    "PowerSGDCompressor", "DistributedOptimizer", "TrainStepResult",
    "allgather_object", "allreduce_gradients", "broadcast_object",
    "broadcast_optimizer_state", "broadcast_parameters", "make_train_step",
    "BroadcastGlobalVariablesCallback", "Callback",
    "LearningRateScheduleCallback", "LearningRateWarmupCallback",
    "MetricAverageCallback", "ModelCheckpointCallback", "average_metrics",
    "multiplier_schedule", "warmup_schedule", "latest_checkpoint",
    "list_checkpoints", "load_model", "restore_checkpoint",
    "save_checkpoint", "wait_for_checkpoints", "fit", "make_eval_step",
]
