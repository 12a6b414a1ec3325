"""Attention engines: dense, blockwise (online softmax), ring, Ulysses.

Port of ``horovod_tpu/parallel/attention.py``.  All functions take
``[B, L, H, Dh]`` Q and ``[B, L, KVH, Dh]`` K/V (GQA when ``KVH < H``) and
accumulate in float32 whatever the input dtype.

The two sequence-parallel engines run in every process of a group, each
holding its slice of the sequence, over the differentiable collectives of
:mod:`._collectives` (the reference runs them inside ``shard_map`` over a
mesh axis): :func:`ring_attention` rotates K/V around the ring with
``ppermute``, :func:`ulysses_attention` re-shards sequence to heads and
back with ``all_to_all``.  :func:`zigzag_shard` lays a sequence out so
that the causal ring's work is the same on every rank.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from horovod_tpu_torch.parallel import _collectives as coll

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
    q_positions: torch.Tensor | None = None,
    kv_positions: torch.Tensor | None = None,
    kv_valid: torch.Tensor | None = None,
) -> _SoftmaxState:
    """Fold one KV block into the running softmax state.

    ``q_positions``/``kv_positions``: optional explicit [Lq]/[Lk] global
    positions for a non-contiguous layout (the zig-zag ring); they
    override ``*_offset + arange``.
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
        qpos = (q_positions if q_positions is not None
                else _positions(q_offset, lq, q.device))[:, None]
        kpos = (kv_positions if kv_positions is not None
                else _positions(kv_offset, lk, q.device))[None, :]
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


def zigzag_positions(rank: int, n: int, local_len: int, *,
                     device=None) -> torch.Tensor:
    """Global positions of rank ``rank``'s local slice under zig-zag
    sharding: the sequence is cut into ``2n`` blocks and rank r holds
    blocks ``r`` (head half) and ``2n-1-r`` (tail half), so every rank's
    causal work is equal."""
    block = local_len // 2
    head = rank * block + torch.arange(block, device=device)
    tail = (2 * n - 1 - rank) * block + torch.arange(block, device=device)
    return torch.cat([head, tail])


def _zigzag_order(n: int) -> list[int]:
    """Block layout of the zig-zag shard: ``0, 2n-1, 1, 2n-2, …, n-1, n``:
    slice r of a contiguous shard over n ranks is blocks ``(r, 2n-1-r)``,
    as :func:`zigzag_positions` says."""
    order: list[int] = []
    for r in range(n):
        order.extend([r, 2 * n - 1 - r])
    return order


def _permute_blocks(x: torch.Tensor, n: int, axis: int,
                    perm: list[int]) -> torch.Tensor:
    l = x.shape[axis]
    if l % (2 * n):
        raise ValueError(f"sequence length {l} not divisible by 2n={2 * n}")
    blocks = x.chunk(2 * n, dim=axis)
    return torch.cat([blocks[i] for i in perm], dim=axis)


def zigzag_shard(x: torch.Tensor, n: int, *, axis: int = 1) -> torch.Tensor:
    """Reorder a global sequence axis so that *contiguous* sharding over
    ``n`` ranks hands each rank its zig-zag block pair (see
    :func:`_zigzag_order`).  Inverse: :func:`zigzag_unshard`."""
    return _permute_blocks(x, n, axis, _zigzag_order(n))


def zigzag_unshard(x: torch.Tensor, n: int, *, axis: int = 1) -> torch.Tensor:
    """Inverse permutation of :func:`zigzag_shard`."""
    order = _zigzag_order(n)
    inverse = [0] * len(order)
    for pos, blk in enumerate(order):
        inverse[blk] = pos
    return _permute_blocks(x, n, axis, inverse)


def ring_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, group=None,
    causal: bool = True, zigzag: bool = False,
) -> torch.Tensor:
    """Sequence-parallel ring attention over ``group`` (None: the world).

    Each rank holds ``[B, L/n, H, D]`` Q/K/V slices, rank r the r-th.  K/V
    rotate around the ring (one :func:`._collectives.ppermute` of the pair
    a hop) while the local queries fold each visiting block into the
    online softmax with einsum block updates: n-1 hops, O(L/n) memory a
    rank.  Contiguous slices leave the causal work skewed (rank r attends
    to r+1 blocks); ``zigzag=True`` takes inputs laid out by
    :func:`zigzag_shard` (rank r holds blocks r and 2n-1-r), which
    balances it, and returns the output in that layout.
    """
    _, n, rank = coll._group(group)
    lc = q.shape[1]
    if zigzag and lc % 2:
        raise ValueError(f"zigzag ring needs an even local length, got {lc}")

    def pos(r: int) -> torch.Tensor:
        if zigzag:
            return zigzag_positions(r, n, lc, device=q.device)
        return _positions(r * lc, lc, q.device)

    qpos = pos(rank)
    perm = [(i, (i + 1) % n) for i in range(n)]
    state = _init_state(q)
    for i in range(n - 1):
        src = (rank - i) % n          # whose slice this rank holds now
        state = _block_update(state, q, k, v, causal=causal,
                              q_positions=qpos, kv_positions=pos(src))
        k, v = coll.ppermute((k, v), perm, group)
    # The last block is folded after the loop: its rotation would be
    # thrown away (one K/V exchange saved a call).
    state = _block_update(state, q, k, v, causal=causal, q_positions=qpos,
                          kv_positions=pos((rank - (n - 1)) % n))
    return _finalize(state, q.dtype)


def ulysses_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, group=None,
    causal: bool = True, impl=None,
) -> torch.Tensor:
    """All-to-all sequence parallelism (the DeepSpeed Ulysses pattern) over
    ``group`` (None: the world).

    Each rank holds ``[B, L/n, H, D]``; an all-to-all re-shards to
    ``[B, L, H/n, D]``, ``impl`` (default :func:`dense_attention`; the
    flash kernel in ``attn_impl="ulysses_flash"``) attends over the whole
    sequence on the rank's n-th of the heads, and an all-to-all brings the
    output back to sequence slices.  Needs ``H % n == 0`` and
    ``KVH % n == 0`` or ``n % KVH == 0``.  With fewer KV heads than ranks
    the KV heads are expanded to n first: rank i's query heads
    ``[i·H/n, (i+1)·H/n)`` all belong to KV head ``i // (n/KVH)``, which
    is what expanded head i holds.
    """
    _, n, _ = coll._group(group)
    h, kvh = q.shape[2], k.shape[2]
    if h % n or (kvh % n if kvh >= n else n % kvh):
        raise ValueError(
            f"ulysses_attention needs H divisible by the axis size and "
            f"KVH % n == 0 or n % KVH == 0: H={h}, KVH={kvh}, n={n}")
    if kvh < n:
        k = _repeat_kv(k, n // kvh)
        v = _repeat_kv(v, n // kvh)
    qh = coll.all_to_all(q, 2, 1, group)
    kh = coll.all_to_all(k, 2, 1, group)
    vh = coll.all_to_all(v, 2, 1, group)
    oh = (impl or dense_attention)(qh, kh, vh, causal=causal)
    return coll.all_to_all(oh, 1, 2, group)
