"""Fused linear + cross-entropy: the vocab-projection loss without the
[N, V] logits tensor.

Port of ``horovod_tpu/ops/fused_xent.py``.  The lm_head is streamed in
vocab chunks with an online logsumexp (the flash-attention recurrence along
the class axis):

    for each chunk c of W[:, off:off+C]:
        logits_c = x @ W_c                       # [N, C], f32
        m, s     = online max / scaled sumexp    # [N]
        tgt      = target logit when target ∈ c  # [N]
    loss = mean(m + log s − tgt)

Each chunk runs under ``torch.utils.checkpoint``, so the backward recomputes
its logits instead of keeping all of them: peak memory O(N·C), not O(N·V).
The reference writes this in XLA (not Pallas), so it is plain PyTorch here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt

NEG_INF = -1e30


def _chunk(x, w, targets, m, s, tgt, off: int, c: int):
    """Fold vocab columns [off, off + c) into the running (m, s, tgt)."""
    v = w.shape[1]
    # The ragged final chunk's window is clamped to end at V; mask to the
    # logical chunk [off, min(off + c, V)), since the clamped window
    # re-reads columns the previous chunk already counted.
    start = min(off, v - c)
    # Storage-dtype operands upcast to f32 (exact for bf16), f32 products
    # and sums: the reference's preferred_element_type=f32.
    logits = torch.matmul(x.float(), w[:, start:start + c].float())   # [N, C]
    cols = start + torch.arange(c, device=x.device)[None, :]
    valid = (cols >= off) & (cols < v)
    logits = torch.where(valid, logits, NEG_INF)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(-1)
    in_chunk = (targets >= off) & (targets < off + c)
    idx = torch.clamp(targets - start, 0, c - 1)
    tl = logits.gather(1, idx[:, None])[:, 0]
    return m_new, s, torch.where(in_chunk, tl, tgt)


def fused_linear_cross_entropy(
    x: torch.Tensor,
    w: torch.Tensor,
    targets: torch.Tensor,
    *,
    chunk_size: int = 8192,
) -> torch.Tensor:
    """Mean cross-entropy of ``softmax(x @ w)`` against ``targets``.

    x: [N, D] final hidden states (any float dtype; products in f32).
    w: [D, V] vocab projection.  targets: [N] int class ids.
    ``chunk_size`` columns of ``w`` per step (clamped to V)."""
    n = x.shape[0]
    v = w.shape[1]
    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    c = min(chunk_size, v)
    targets = targets.long()
    m = torch.full((n,), NEG_INF, dtype=torch.float32, device=x.device)
    s = torch.zeros((n,), dtype=torch.float32, device=x.device)
    tgt = torch.full((n,), NEG_INF, dtype=torch.float32, device=x.device)
    remat = torch.is_grad_enabled()
    for off in range(0, v, c):
        if remat:
            m, s, tgt = ckpt.checkpoint(_chunk, x, w, targets, m, s, tgt,
                                        off, c, use_reentrant=False)
        else:
            m, s, tgt = _chunk(x, w, targets, m, s, tgt, off, c)
    return torch.mean(m + torch.log(s) - tgt)


def reference_cross_entropy(x, w, targets) -> torch.Tensor:
    """The unfused oracle (materializes [N, V]); tests compare against it."""
    logits = (x @ w).float()
    return F.cross_entropy(logits, targets.long())
