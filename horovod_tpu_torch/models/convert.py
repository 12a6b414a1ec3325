"""Parameters of the JAX reference → parameters of the port."""

from __future__ import annotations

import numpy as np
import torch

from horovod_tpu_torch._device import resolve_device


def _to_tensor(leaf, device: torch.device) -> torch.Tensor:
    a = np.array(leaf)               # a writable, contiguous copy
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16 has no torch twin
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree: dict, *, device: str | torch.device | None = None
                    ) -> dict:
    """Turn the reference's ``init_params`` pytree (nested dicts of numpy or
    array-like leaves) into the port's parameter dict on ``device``, with
    the same keys, shapes and dtypes, so both compute the same function.

    Orientation: weights stay ``[in, out]`` and are used as ``h @ w``, as
    in the reference (no transpose into ``nn.Linear``'s ``[out, in]``)."""
    dev = resolve_device(device)
    return {k: params_from_jax(v, device=dev) if isinstance(v, dict)
            else _to_tensor(v, dev) for k, v in tree.items()}
