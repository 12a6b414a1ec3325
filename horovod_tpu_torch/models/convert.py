"""Parameters of the JAX reference → parameters of the port.

``params_from_jax`` for the Llama parameter tree; ``vision_state_dict_from_flax``
for the flax variables of the vision models; ``compression_state_from_jax``
for the state of a stateful gradient compressor.
"""

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


def _flat_items(tree: dict, prefix: tuple = ()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat_items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# flax leaf name → torch name, per variable collection.
_PARAM_NAMES = {"kernel": "weight", "scale": "weight"}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def vision_state_dict_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """A flax ``{"params", "batch_stats"}`` tree of the JAX vision models
    (numpy or array-like leaves) as the ``state_dict`` of the port's twin
    module (``models/{mnist,resnet,vgg,inception,vit}.py``), CPU tensors
    for ``load_state_dict``.

    The port's submodules carry flax's names, so the key is the flax path
    joined by dots, with the leaf renamed: a conv ``kernel`` HWIO becomes
    ``weight`` OIHW, a Dense ``kernel`` [in, out] becomes ``weight``
    [out, in], a norm ``scale`` becomes ``weight``, BN statistics ``mean``
    and ``var`` become ``running_mean`` and ``running_var``; ``bias`` and
    the ViT's ``pos_embed`` carry over as they are."""
    out = {}
    for collection, tree in variables.items():
        if collection not in ("params", "batch_stats"):
            raise ValueError(f"unknown flax collection {collection!r}")
        names = _PARAM_NAMES if collection == "params" else _STAT_NAMES
        for path, leaf in _flat_items(tree):
            t = _to_tensor(leaf, torch.device("cpu"))
            if path[-1] == "kernel":
                t = t.permute(3, 2, 0, 1) if t.ndim == 4 else t.t()
            key = ".".join(path[:-1] + (names.get(path[-1], path[-1]),))
            out[key] = t.contiguous()
    return out


def compression_state_from_jax(tree, *, device: str | torch.device | None = None
                               ) -> list:
    """The JAX package's stateful-compressor state (the ``comp`` of its
    optimizer state, numpy or array-like leaves) as the port's: a list in
    ``jax.tree.leaves`` order (dicts by sorted key), the port's
    ``DistributedOptimizer`` order for the Llama tree.  A PowerSGD leaf
    ``(q, residual)`` becomes the port's ``_PowerSGDLeafState``, the dense
    sentinel (an empty array) and an ``ErrorFeedback`` residual a tensor."""
    from horovod_tpu_torch.ops.powersgd import _PowerSGDLeafState

    dev = resolve_device(device)
    out: list = []

    def walk(node):
        if getattr(node, "_fields", None) == ("q", "residual"):
            out.append(_PowerSGDLeafState(q=_to_tensor(node.q, dev),
                                          residual=_to_tensor(node.residual,
                                                              dev)))
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        else:
            out.append(_to_tensor(node, dev))

    walk(tree)
    return out
