"""Plain PyTorch reference of a Llama-block decoder's first training steps.

Mistral-7B's block (arXiv:2310.06825, the published config.json): RMSNorm
(f32, eps from the config), grouped-query attention with rotary position
embeddings in the half-split convention, full causal softmax (the
configuration's 4,096-token window covers every causal pair of the
traffic's sequences), a SwiGLU feed-forward, a final RMSNorm, an untied
head and next-token cross-entropy.  Then global-norm clipping and
``torch.optim.AdamW``, as the configuration states.

Everything is float32 with TF32 off.  It imports nothing of the port and
takes nothing the port made: the weights and the batches are drawn again
from the seed (:mod:`portbench.inputs`).  To fit beside its optimizer
state on one card, it runs one sequence at a time (summing the gradients)
and recomputes each layer in the backward (``torch.utils.checkpoint``),
which changes no number.

``lowp=True`` gives the control: every matrix product's operands rounded
to fp8 (e4m3 forward, e5m2 for the gradients, one scale per tensor), the
precision below the configuration's bf16.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt

from portbench import inputs
from portbench.reference import lowp as lowp_mod


def _rmsnorm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rope(m: dict, seq: int, device):
    half = m["head_dim"] // 2
    inv = m["rope_theta"] ** (-torch.arange(half, dtype=torch.float64) / half)
    ang = torch.arange(seq, dtype=torch.float64)[:, None] * inv[None, :]
    return (torch.cos(ang).float().to(device)[None, :, None, :],
            torch.sin(ang).float().to(device)[None, :, None, :])


def _rotate(x, cos, sin):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _layer(x, lw: dict, m: dict, cos, sin, mask, mm):
    b, l, _ = x.shape
    h, kvh, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    y = _rmsnorm(x, lw["attn_norm"], m["norm_eps"])
    q = _rotate(mm(y, lw["wq"]).view(b, l, h, hd), cos, sin)
    k = _rotate(mm(y, lw["wk"]).view(b, l, kvh, hd), cos, sin)
    v = mm(y, lw["wv"]).view(b, l, kvh, hd)
    group = h // kvh
    q = q.transpose(1, 2)                                   # [B, H, L, D]
    k = k.transpose(1, 2).repeat_interleave(group, dim=1)
    v = v.transpose(1, 2).repeat_interleave(group, dim=1)
    s = mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
    p = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
    o = mm(p, v).transpose(1, 2).reshape(b, l, h * hd)
    x = x + mm(o, lw["wo"])
    y = _rmsnorm(x, lw["mlp_norm"], m["norm_eps"])
    return x + mm(F.silu(mm(y, lw["w_gate"])) * mm(y, lw["w_up"]),
                  lw["w_down"])


def loss(w: dict, rows: torch.Tensor, m: dict, mm=torch.matmul):
    """Mean next-token cross-entropy of ``rows`` [B, L + 1] under weights
    ``w`` (flat names, layers stacked)."""
    tokens, targets = rows[:, :-1], rows[:, 1:]
    seq = tokens.shape[1]
    cos, sin = _rope(m, seq, rows.device)
    mask = torch.ones(seq, seq, dtype=torch.bool,
                      device=rows.device).triu_(1)
    x = w["embed"][tokens]
    names = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
             "w_up", "w_down")
    for i in range(m["n_layers"]):
        lw = {n: w[f"layers.{n}"][i] for n in names}
        x = ckpt.checkpoint(_layer, x, lw, m, cos, sin, mask, mm,
                            use_reentrant=False)
    x = _rmsnorm(x, w["final_norm"], m["norm_eps"])
    logits = mm(x, w["lm_head"])
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1))


def readings(config: dict, traffic: dict, optim: dict, seed: int,
             world: int, steps: int, device, lowp: bool = False) -> dict:
    """The comparison's readings (:mod:`portbench.compare`) of ``steps``
    steps over every rank's rows."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mm = lowp_mod.fp8_matmul if lowp else torch.matmul
    m = inputs.llama_dims(config)
    specs = inputs.llama_leaves(config)
    w = {name: inputs.llama_leaf(seed, name, shape, fan_in, device)
         .requires_grad_() for name, shape, fan_in in specs}
    opt = torch.optim.AdamW(list(w.values()), lr=optim["lr"],
                            betas=tuple(optim["betas"]),
                            weight_decay=optim["weight_decay"],
                            foreach=False)
    b, seq = traffic["sequences_per_card"], traffic["sequence_length"]
    n_rows = world * b
    losses, grad = [], {}
    for step in range(steps):
        total = 0.0
        for r in range(world):
            rows = inputs.lm_batch(seed, r, step, b, seq, m["vocab"], device)
            for i in range(b):
                part = loss(w, rows[i:i + 1], m, mm) / n_rows
                part.backward()
                total += float(part.detach())
        torch.nn.utils.clip_grad_norm_(list(w.values()),
                                       optim["max_grad_norm"],
                                       foreach=False)
        if step == 0:
            grad = {n: float(t.grad.norm()) for n, t in w.items()}
        opt.step()
        opt.zero_grad(set_to_none=True)
        losses.append(total)
    del opt
    change = {}
    with torch.no_grad():
        for name, shape, fan_in in specs:
            start = inputs.llama_leaf(seed, name, shape, fan_in, device)
            change[name] = float((w[name] - start).norm())
            del start
    return {"losses": losses, "grad": grad, "change": change}
