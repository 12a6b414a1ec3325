"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the card.  Raises when CUDA is asked for (explicitly
    or by default) and no GPU is present: the CPU is only ever used when
    the caller names it.

    On CUDA this also pins float32 matmuls and convolutions to full
    float32 (TF32 off): the decode attention runs in f32 as the reference
    does, and TF32 would keep only ~3 decimal digits of it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "horovod_tpu_torch: no CUDA device is available; pass "
                "device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
