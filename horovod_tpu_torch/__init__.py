"""PyTorch/CUDA port of ``horovod_tpu``, for one NVIDIA Hopper card.

The JAX package ``horovod_tpu`` is the reference; each module here mirrors
its counterpart's path and public names (``parallel/attention.py``,
``parallel/flash_attention.py``, ``models/llama.py``, ``serving.py``) and is
tested against it on the same inputs.  This package imports ``torch`` and
never ``jax`` nor anything of ``horovod_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card and no explicit CPU request they raise (no silent fallback).
The one TPU kernel on the serving path, the flash-attention forward, is a
hand-written CUDA kernel (``csrc/flash_fwd.cu``) built with ``nvcc`` at
first use into ``build/horovod_tpu_torch/``.
"""

from horovod_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
