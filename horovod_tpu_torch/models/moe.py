"""Mixture-of-Experts MLP with expert parallelism.

Port of ``horovod_tpu/models/moe.py``: the top-k router with per-expert
capacity and the Switch load-balancing loss (plus the ST-MoE z-loss and
router jitter), the dense one-hot dispatch as einsums over static shapes,
and :func:`expert_parallel_mlp`, where each rank of a group holds E/n of
the experts and its own tokens, and two all-to-alls
(:func:`.._collectives.all_to_all`) move tokens to their experts and back.

Router jitter draws from an explicit ``torch.Generator`` (``noise_key``: a
generator or an int seed) where the reference draws from a ``jax.random``
key: the numbers are the port's own.  In :func:`expert_parallel_mlp` each
rank draws from a generator seeded from the key's seed and its rank, as
the reference folds the rank into its key.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from horovod_tpu_torch._device import resolve_device
from horovod_tpu_torch.models.llama import as_generator
from horovod_tpu_torch.parallel import _collectives as coll


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    dim: int = 512
    ffn_dim: int = 1024
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    # Router z-loss (ST-MoE): mean(log²Σe^logit) a token, which keeps the
    # router's softmax out of its saturated region.  0 disables.
    z_loss_weight: float = 0.0
    # Multiplicative jitter on the router's input in training (the Switch
    # Transformer's x · U[1−ε, 1+ε]).  0 disables.
    router_jitter: float = 0.0
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32


def init_params(cfg: MoEConfig, generator: torch.Generator | int = 0, *,
                device: str | torch.device | None = None) -> dict:
    """``router [D, E]``, ``w_in [E, D, F]``, ``w_out [E, F, D]``, normal /
    sqrt(fan_in) from ``generator`` (the port's own numbers; use
    :func:`.convert.moe_params_from_jax` for the reference's)."""
    dev = resolve_device(device)
    gen = as_generator(generator, dev)
    e, d, f = cfg.n_experts, cfg.dim, cfg.ffn_dim

    def dense(shape, fan_in):
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=dev) / fan_in ** 0.5).to(cfg.param_dtype)

    return {"router": dense((d, e), d), "w_in": dense((e, d, f), d),
            "w_out": dense((e, f, d), f)}


def param_partition_specs() -> dict:
    """The dim of each leaf that shards over the expert group: the experts
    of ``w_in``/``w_out``; the router is replicated (None)."""
    return {"router": None, "w_in": 0, "w_out": 0}


def _capacity(n_tokens: int, cfg: MoEConfig) -> int:
    cap = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    return max(cap, cfg.top_k)


def route(cfg: MoEConfig, logits: torch.Tensor):
    """Top-k routing with per-expert capacity: logits ``[T, E]`` →
    (dispatch ``[T, E, C]`` one-hot, combine ``[T, E, C]`` gated, aux loss).

    A token's slot in its expert's queue is a cumulative count over the
    tokens, first choices before second choices (top-1 has priority);
    tokens past the capacity are dropped."""
    t, e = logits.shape[0], cfg.n_experts
    cap = _capacity(t, cfg)
    probs = torch.softmax(logits.float(), dim=-1)                # [T, E]
    gate_vals, expert_idx = torch.topk(probs, cfg.top_k, dim=-1)  # [T, k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    choice_oh = F.one_hot(expert_idx.T, e).float()               # [k, T, E]
    flat = choice_oh.reshape(cfg.top_k * t, e)
    pos = torch.cumsum(flat, dim=0) - flat
    pos = (pos * flat).sum(-1).reshape(cfg.top_k, t)             # [k, T]
    keep = pos < cap
    # jax.nn.one_hot of an index past the capacity is all zeros; the clamp
    # keeps F.one_hot in range and ``keep`` zeroes those rows.
    pos_oh = (F.one_hot(pos.long().clamp(max=cap - 1), cap).float()
              * keep[..., None])
    dispatch = torch.einsum("kte,ktc->tec", choice_oh, pos_oh)
    combine = torch.einsum("kte,ktc,tk->tec", choice_oh, pos_oh,
                           gate_vals.float())
    # Switch balance loss: E · sum_e(first-choice share_e · mean prob_e).
    frac_tokens = choice_oh[0].mean(0)
    aux = cfg.n_experts * torch.sum(frac_tokens * probs.mean(0))
    return dispatch, combine, aux


def _noise_generator(key, device, rank: int | None = None):
    """``key`` (a generator or an int seed) as a generator on ``device``;
    with ``rank``, a generator seeded from the key's seed and the rank."""
    if rank is None and isinstance(key, torch.Generator):
        return key
    seed = key.initial_seed() if isinstance(key, torch.Generator) else int(key)
    if rank is not None:
        seed = (seed * 1_000_003 + rank + 1) % (1 << 63)
    return torch.Generator(device=device).manual_seed(seed)


def router_logits(params: dict, x: torch.Tensor, cfg: MoEConfig, *,
                  noise_key=None) -> torch.Tensor:
    """Router scores ``[T, E]`` in f32; with ``noise_key`` and
    ``cfg.router_jitter`` > 0, the input is first scaled by
    ``U[1−ε, 1+ε]`` (the Switch Transformer's training-time jitter)."""
    xf = x.float()
    if noise_key is not None and cfg.router_jitter > 0.0:
        eps = cfg.router_jitter
        gen = _noise_generator(noise_key, x.device)
        u = torch.rand(xf.shape, generator=gen, dtype=torch.float32,
                       device=x.device)
        xf = xf * (1.0 - eps + 2.0 * eps * u)
    return xf @ params["router"].float()


def weighted_aux(cfg: MoEConfig, aux: torch.Tensor,
                 logits: torch.Tensor) -> torch.Tensor:
    """The Switch balance loss times its weight, plus the ST-MoE z-loss
    ``mean(log²Σ_e e^logit)`` times its weight."""
    total = cfg.aux_loss_weight * aux
    if cfg.z_loss_weight:
        z = torch.logsumexp(logits.float(), dim=-1)
        total = total + cfg.z_loss_weight * torch.mean(z ** 2)
    return total


def _experts(params: dict, expert_in: torch.Tensor, dt) -> torch.Tensor:
    h = F.silu(torch.einsum("ecd,edf->ecf", expert_in,
                            params["w_in"].to(dt)))
    return torch.einsum("ecf,efd->ecd", h, params["w_out"].to(dt))


def forward(params: dict, x: torch.Tensor, cfg: MoEConfig, *,
            noise_key=None) -> tuple[torch.Tensor, torch.Tensor]:
    """MoE MLP on one process: x ``[T, D]`` → (y ``[T, D]``, aux loss).
    ``noise_key`` turns on the router jitter (:func:`router_logits`)."""
    dt = cfg.dtype
    logits = router_logits(params, x, cfg, noise_key=noise_key)
    dispatch, combine, aux = route(cfg, logits)
    expert_in = torch.einsum("tec,td->ecd", dispatch.to(dt), x.to(dt))
    y = torch.einsum("tec,ecd->td", combine.to(dt),
                     _experts(params, expert_in, dt))
    return y.to(x.dtype), weighted_aux(cfg, aux, logits)


def expert_parallel_mlp(params: dict, x: torch.Tensor, cfg: MoEConfig, *,
                        group=None, noise_key=None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism over ``group`` (None: the world): each rank holds
    E/n experts (``w_in``/``w_out`` of leading dim E/n, the router
    replicated) and its own tokens ``[T_loc, D]``.

    Tokens are dispatched locally to all E experts' buffers ``[E, C, D]``;
    an all-to-all over the expert axis hands rank g the buffers of its
    experts from every rank (expert ``g·E/n + j`` lives on rank g), stacked
    along the slot axis ``[E/n, n·C, D]``; the local experts run; the
    inverse all-to-all brings the results home.  The aux loss is computed
    from the local tokens and averaged over the group (``pmean``)."""
    _, n, rank = coll._group(group)
    e_loc = params["w_in"].shape[0]
    dt = cfg.dtype
    full_cfg = dataclasses.replace(cfg, n_experts=e_loc * n)
    if noise_key is not None:
        # Every rank holds the same key: without the rank, each would draw
        # identical jitter for its tokens.
        noise_key = _noise_generator(noise_key, x.device, rank)
    logits = router_logits(params, x, cfg, noise_key=noise_key)
    dispatch, combine, aux = route(full_cfg, logits)
    expert_in = torch.einsum("tec,td->ecd", dispatch.to(dt), x.to(dt))
    expert_in = coll.all_to_all(expert_in, 0, 1, group)
    out = coll.all_to_all(_experts(params, expert_in, dt), 1, 0, group)
    y = torch.einsum("tec,ecd->td", combine.to(dt), out)
    total = coll.pmean(weighted_aux(full_cfg, aux, logits), group)
    return y.to(x.dtype), total
