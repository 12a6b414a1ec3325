"""Tensor Fusion: bucketed flat collectives.

Port of ``horovod_tpu/ops/fusion.py``.  :func:`plan_buckets` is the same
pure function (its plans equal the JAX package's for the same sizes and
keys).  :func:`fused_apply` flattens each bucket's tensors, concatenates
them into one buffer, runs ONE collective on it and splits the result:
Horovod's fusion buffer, here a ``torch.cat`` on the device.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from horovod_tpu_torch.utils.env import DEFAULT_FUSION_THRESHOLD_BYTES


def _nbytes(x) -> int:
    return int(x.numel()) * x.element_size()


def plan_buckets(
    tensors: Sequence,
    threshold_bytes: int | None,
    *,
    nbytes=_nbytes,
    key=lambda t: t.dtype,
) -> list[list[int]]:
    """Greedy bucketing of *consecutive* same-key items ≤ threshold.

    Tensors join a bucket while they share a fuse key (by default: dtype)
    and the running size stays under the threshold.  A tensor larger than
    the threshold gets its own bucket; a threshold <= 0 disables fusion
    (one tensor per bucket); ``None`` means the 64 MiB default.
    """
    if threshold_bytes is None:
        threshold_bytes = DEFAULT_FUSION_THRESHOLD_BYTES
    buckets: list[list[int]] = []
    cur: list[int] = []
    cur_bytes = 0
    cur_key = None
    for i, t in enumerate(tensors):
        nb = nbytes(t)
        k = key(t)
        if cur and (k != cur_key or cur_bytes + nb > threshold_bytes):
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nb
        cur_key = k
        if threshold_bytes <= 0:  # fusion disabled: one tensor per bucket
            buckets.append(cur)
            cur, cur_bytes = [], 0
    if cur:
        buckets.append(cur)
    return buckets


def fused_apply(
    tensors: list[torch.Tensor],
    collective: Callable[[torch.Tensor], torch.Tensor],
    *,
    threshold_bytes: int | None = None,
    inplace: bool = False,
) -> list[torch.Tensor]:
    """Apply a flat-vector collective to ``tensors`` bucket by bucket.

    ``collective`` receives a 1-D tensor (the fused buffer, which it may
    overwrite) and returns a reduced tensor of the same size.  Returns
    per-tensor results in input order, each of its input's shape.  With
    ``inplace=True`` each bucket's result is copied back into its input
    tensors before the next bucket is fused, so no more than one bucket of
    scratch is alive at a time, and the inputs are returned."""
    out: list[torch.Tensor | None] = [None] * len(tensors)
    for bucket in plan_buckets(tensors, threshold_bytes):
        flat = torch.cat([tensors[i].reshape(-1) for i in bucket])
        reduced = collective(flat)
        for i, piece in zip(bucket, reduced.split(
                [tensors[i].numel() for i in bucket])):
            piece = piece.view(tensors[i].shape)
            if inplace:
                tensors[i].copy_(piece)
                piece = tensors[i]
            out[i] = piece
    return out  # type: ignore[return-value]
