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
``DistributedOptimizer`` → ``make_train_step``.
"""

from horovod_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
