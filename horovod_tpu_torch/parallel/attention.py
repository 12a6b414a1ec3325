"""Attention engines: dense and blockwise (online softmax).

Port of ``horovod_tpu/parallel/attention.py`` (``_repeat_kv`` through
``blockwise_attention``).  All functions take ``[B, L, H, Dh]`` Q and
``[B, L, KVH, Dh]`` K/V (GQA when ``KVH < H``) and accumulate in float32
whatever the input dtype.  Ring, Ulysses and the zigzag helpers need
sequence parallelism and come with a later slice of the port.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """GQA: expand KV heads to match query heads ([B, L, KVH, D] → [B, L, H, D])."""
    if n_rep == 1:
        return k
    b, l, kvh, d = k.shape
    return k[:, :, :, None, :].expand(b, l, kvh, n_rep, d).reshape(
        b, l, kvh * n_rep, d)


def _positions(offset, n: int, device) -> torch.Tensor:
    return offset + torch.arange(n, device=device)


def dense_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    q_offset: int | torch.Tensor = 0, kv_offset: int | torch.Tensor = 0,
) -> torch.Tensor:
    """Reference O(L²)-memory attention (the ground truth for tests).

    ``q_offset``/``kv_offset`` are the global positions of element 0 of the
    q/kv sequence axes.
    """
    b, lq, h, d = q.shape
    kvh = k.shape[2]
    k = _repeat_kv(k, h // kvh)
    v = _repeat_kv(v, h // kvh)
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        qpos = _positions(q_offset, lq, q.device)[:, None]
        kpos = _positions(kv_offset, k.shape[1], q.device)[None, :]
        s = torch.where(qpos >= kpos, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


class _SoftmaxState(NamedTuple):
    """Online-softmax running state (the flash-attention recurrence)."""

    o: torch.Tensor      # [B, Lq, H, D] f32 unnormalized output accumulator
    m: torch.Tensor      # [B, H, Lq]    f32 running row max
    l: torch.Tensor      # [B, H, Lq]    f32 running row sum


def _init_state(q: torch.Tensor) -> _SoftmaxState:
    b, lq, h, d = q.shape
    return _SoftmaxState(
        o=torch.zeros((b, lq, h, d), dtype=torch.float32, device=q.device),
        m=torch.full((b, h, lq), NEG_INF, dtype=torch.float32, device=q.device),
        l=torch.zeros((b, h, lq), dtype=torch.float32, device=q.device),
    )


def _block_update(
    state: _SoftmaxState,
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *, causal: bool, q_offset=0, kv_offset=0,
    kv_valid: torch.Tensor | None = None,
) -> _SoftmaxState:
    """Fold one KV block into the running softmax state.

    ``kv_valid``: optional [Lk] bool mask for padded tail keys.  GQA folds
    the r query heads of a group onto their KV head (query head g ↔ kv head
    g // r, the ``_repeat_kv`` mapping) instead of expanding K/V.
    """
    b, lq, h, d = q.shape
    kvh = k.shape[2]
    r = h // kvh
    lk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, lq, kvh, r, d)
    s = torch.einsum("bqkjd,bmkd->bkjqm", qg.float(),
                     k.float()).reshape(b, h, lq, lk) * scale
    if causal:
        qpos = _positions(q_offset, lq, q.device)[:, None]
        kpos = _positions(kv_offset, lk, q.device)[None, :]
        s = torch.where(qpos >= kpos, s, NEG_INF)
    if kv_valid is not None:
        s = torch.where(kv_valid[None, None, None, :], s, NEG_INF)
    m_new = torch.maximum(state.m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    correction = torch.exp(state.m - m_new)
    l_new = state.l * correction + p.sum(dim=-1)
    o_new = (
        state.o * correction.permute(0, 2, 1)[..., None]
        + torch.einsum("bkjqm,bmkd->bqkjd", p.reshape(b, kvh, r, lq, lk),
                       v.float()).reshape(b, lq, h, d)
    )
    return _SoftmaxState(o_new, m_new, l_new)


def _finalize(state: _SoftmaxState, dtype) -> torch.Tensor:
    l = torch.clamp(state.l, min=1e-30)
    return (state.o / l.permute(0, 2, 1)[..., None]).to(dtype)


def blockwise_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    block_size: int = 512, q_offset=0, kv_offset=0,
) -> torch.Tensor:
    """O(L)-memory attention: a loop over KV chunks with online softmax
    (the reference's ``lax.scan`` becomes a Python loop)."""
    b, lkv, kvh, d = k.shape
    nblocks = max(1, math.ceil(lkv / block_size))
    pad = nblocks * block_size - lkv
    state = _init_state(q)
    for i in range(nblocks):
        lo = i * block_size
        kblk = k[:, lo:lo + block_size]
        vblk = v[:, lo:lo + block_size]
        valid = None
        if pad:
            # The reference pads the tail block with zeros and masks it.
            n = kblk.shape[1]
            if n < block_size:
                fill = (0, 0, 0, 0, 0, block_size - n)
                kblk = torch.nn.functional.pad(kblk, fill)
                vblk = torch.nn.functional.pad(vblk, fill)
            valid = (lo + torch.arange(block_size, device=q.device)) < lkv
        state = _block_update(state, q, kblk, vblk, causal=causal,
                              q_offset=q_offset, kv_offset=kv_offset + lo,
                              kv_valid=valid)
    return _finalize(state, q.dtype)
