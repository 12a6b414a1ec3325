"""Llama-3-family transformer: the inference and training core of the port.

Port of ``horovod_tpu/models/llama.py``: the config, parameter init,
``forward`` with per-layer remat, the loss (``loss_fn``, ``make_loss_fn``,
plain or through the chunked fused cross-entropy) and the KV-cached serving
path (``prefill``, ``decode_step``, ``decode_chunk``, ``prefill_chunked``,
sampling, ``generate``) with the paged cache of the serving engine
(``PagedKVCache``, ``BlockPool``, ``decode_chunk_paged``,
``spec_verify_paged``, ``decode_chunk_paged_row``).  The JAX
layouts are kept at every public function: activations ``[B, L, H, Dh]``,
parameters a plain dict of stacked ``[n_layers, ...]`` tensors used as
``h @ w`` (``[in, out]``), KV cache ``[n_layers, B, max_len, KVH, Dh]``.

PyTorch idiom inside: the layer ``lax.scan`` is a Python loop, the
``jax.checkpoint`` of each layer is ``torch.utils.checkpoint`` (named
policies through selective checkpointing), ``jax.random`` keys are
``torch.Generator``s, and the KV cache is updated in place (the JAX code
donates it, so no caller sees the difference).  Weights are cast
to ``cfg.dtype`` at each use, exactly as the reference; a server may hold
them in ``cfg.dtype`` from load (``param_dtype=cfg.dtype``), which gives
the same values, since the cast at use is then a no-op.

The sequence-parallel engines (ring, Ulysses, Ulysses over the flash
kernel) run over ``forward``'s ``sp_group``.  Tensor-parallel serving
(Megatron's split) takes the reference's layout tables,
:func:`param_partition_specs` and :func:`paged_cache_partition_specs`, as
data: :func:`shard_params` slices a full tree into one rank's shard, and
the paged programs take a ``tp_group`` over which each rank runs its own
heads and MLP columns, with one ``psum`` after the row-parallel ``wo`` and
``w_down`` products and all-gathers of the embedding's D-slice and the
logits' vocabulary slice.  Head counts are read from the weights' shapes
(a shard's ``wq`` has ``n_heads / tp`` heads of ``cfg.head_dim``), so one
config serves both.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt

from horovod_tpu_torch._device import resolve_device
from horovod_tpu_torch.ops.fused_xent import fused_linear_cross_entropy
from horovod_tpu_torch.parallel import _collectives as coll
from horovod_tpu_torch.parallel import attention as attn_mod
from horovod_tpu_torch.parallel.flash_attention import flash_attention

NEG_INF_LOGIT = -1e30


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 8192
    dtype: Any = torch.bfloat16          # activation/compute dtype
    param_dtype: Any = torch.float32     # master weights
    # dense | blockwise | flash | ring | ulysses | ulysses_flash (the last
    # three sequence-parallel: forward's sp_group)
    attn_impl: str = "dense"
    attn_block_size: int = 512
    remat: bool = True                 # checkpoint each layer in training
    # Named remat policy, the reference's jax.checkpoint_policies names:
    # "dots_saveable" keeps every matmul output, "dots_with_no_batch_dims_
    # saveable" only the 2-D weight products (not attention's batched ones),
    # "everything_saveable" all, "nothing_saveable" none.  None = full remat.
    remat_policy: str | None = None
    # Chunked fused linear+cross-entropy (ops/fused_xent.py): the loss
    # without the [B·L, V] logits tensor; None keeps the plain path.
    fused_loss_chunk: int | None = None

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


def llama3_8b(**overrides) -> LlamaConfig:
    return dataclasses.replace(LlamaConfig(), **overrides)


def llama_tiny(**overrides) -> LlamaConfig:
    """Test configuration: same architecture, toy widths."""
    base = LlamaConfig(
        vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
        ffn_dim=128, max_seq_len=128, rope_theta=10000.0, remat=False,
    )
    return dataclasses.replace(base, **overrides)


def as_generator(key: torch.Generator | int | None,
                 device: torch.device) -> torch.Generator:
    """``key`` itself, or a generator on ``device`` seeded with the int
    ``key`` (0 for ``None``): the port's stand-in for a ``jax.random``
    key."""
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator(device=device).manual_seed(
        0 if key is None else int(key))


_LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
               "w_up", "w_down")


def init_params(cfg: LlamaConfig, generator: torch.Generator | int = 0, *,
                device: str | torch.device | None = None) -> dict:
    """Stacked-layer parameter dict, the reference's layout:

      embed      [V, D]
      layers:
        attn_norm [L, D]   wq [L, D, H·Dh]  wk [L, D, K]  wv [L, D, K]
        wo        [L, H·Dh, D]
        mlp_norm  [L, D]   w_gate [L, D, F] w_up [L, D, F] w_down [L, F, D]
      final_norm [D]
      lm_head    [D, V]

    Random weights are normal / sqrt(fan_in), drawn from ``generator`` (a
    ``torch.Generator`` on ``device``, or an int seed); the numbers are the
    port's own, not JAX's.  Use :func:`..convert.params_from_jax` to run
    the reference's weights.
    """
    dev = resolve_device(device)
    generator = as_generator(generator, dev)
    d, f = cfg.dim, cfg.ffn_dim
    kdim = cfg.n_kv_heads * cfg.head_dim
    L = cfg.n_layers
    dt = cfg.param_dtype

    def dense_init(shape, fan_in):
        w = torch.empty(shape, dtype=dt, device=dev)
        # Drawn layer by layer in f32 and cast, so an 8B init in bf16
        # never holds more than one layer's f32 draw.
        for i in range(shape[0] if len(shape) == 3 else 1):
            dst = w[i] if len(shape) == 3 else w
            dst.copy_(torch.randn(dst.shape, generator=generator,
                                  dtype=torch.float32, device=dev)
                      / fan_in ** 0.5)
        return w

    def ones(shape):
        return torch.ones(shape, dtype=dt, device=dev)

    return {
        "embed": dense_init((cfg.vocab_size, d), d),
        "layers": {
            "attn_norm": ones((L, d)),
            "wq": dense_init((L, d, d), d),
            "wk": dense_init((L, d, kdim), d),
            "wv": dense_init((L, d, kdim), d),
            "wo": dense_init((L, d, d), d),
            "mlp_norm": ones((L, d)),
            "w_gate": dense_init((L, d, f), d),
            "w_up": dense_init((L, d, f), d),
            "w_down": dense_init((L, f, d), f),
        },
        "final_norm": ones((d,)),
        "lm_head": dense_init((d, cfg.vocab_size), d),
    }


def num_params(cfg: LlamaConfig) -> int:
    d, f, L, v = cfg.dim, cfg.ffn_dim, cfg.n_layers, cfg.vocab_size
    kdim = cfg.n_kv_heads * cfg.head_dim
    per_layer = 2 * d + d * d * 2 + 2 * d * kdim + 3 * d * f
    return v * d * 2 + L * per_layer + d


def param_partition_specs(cfg: LlamaConfig, *, tp_axis: str = "tp") -> dict:
    """Megatron-style tensor-parallel layout over ``tp_axis``: each leaf's
    spec names, per dimension, the mesh axis it is split over (``None``:
    not split), as the reference's ``PartitionSpec``s do.

    Column-parallel (output dim split): ``wq``/``wk``/``wv``/``w_gate``/
    ``w_up`` and ``lm_head``; row-parallel (input dim split): ``wo``/
    ``w_down``, each followed by a ``psum``; ``embed`` on D; the norms
    replicated."""
    del cfg
    t = tp_axis
    return {
        "embed": (None, t),
        "layers": {
            "attn_norm": (None, None),
            "wq": (None, None, t),
            "wk": (None, None, t),
            "wv": (None, None, t),
            "wo": (None, t, None),
            "mlp_norm": (None, None),
            "w_gate": (None, None, t),
            "w_up": (None, None, t),
            "w_down": (None, t, None),
        },
        "final_norm": (None,),
        "lm_head": (None, t),
    }


def paged_cache_partition_specs(*, tp_axis: str = "tp") -> "PagedKVCache":
    """Head-split layout of the paged KV pool over ``tp_axis``: k/v
    ``[n_layers, n_blocks, block_size, KVH, Dh]`` on the KV-head axis (the
    heads the column-parallel ``wk``/``wv`` make locally, so a rank writes
    its own head slice with no traffic), ``block_table``/``length``
    replicated: one logical block id addresses the same slot of every
    rank's slice, which keeps the block pool, the prefix cache and
    preemption replay shard-blind."""
    kv = (None, None, None, tp_axis, None)
    return PagedKVCache(k=kv, v=kv, block_table=(), length=())


def shard_params(params: dict, specs: dict, rank: int, size: int) -> dict:
    """Rank ``rank``'s shard of a full parameter tree: every leaf whose
    spec names an axis is cut into ``size`` equal slices along that
    dimension and slice ``rank`` kept; the others are kept whole.  Every
    leaf is copied, so the full tree can be freed."""
    def cut(x: torch.Tensor, spec: tuple) -> torch.Tensor:
        dims = [i for i, a in enumerate(spec) if a is not None]
        if not dims:
            return x.clone()
        (dim,) = dims
        if x.shape[dim] % size:
            raise ValueError(
                f"shard_params: dimension {dim} of {tuple(x.shape)} does "
                f"not split over {size} ranks")
        n = x.shape[dim] // size
        return x.narrow(dim, rank * n, n).clone()

    def walk(p, s):
        if isinstance(p, dict):
            return {k: walk(p[k], s[k]) for k in p}
        return cut(p, s)

    return walk(params, specs)


def _is_fake(x: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(x, FakeTensor)


def _tp_psum(x: torch.Tensor, tp_group) -> torch.Tensor:
    """The row-parallel reduction; none without a group.  A fake tensor
    (the device plane's cost capture) crosses no wire."""
    if tp_group is None or _is_fake(x):
        return x
    return coll.psum(x, tp_group)


def _tp_gather(x: torch.Tensor, tp_group) -> torch.Tensor:
    """Every rank's slice of the last dimension, in rank order; none
    without a group.  A fake tensor gets the gathered shape only."""
    if tp_group is None:
        return x
    if _is_fake(x):
        return torch.cat([x] * torch.distributed.get_world_size(tp_group),
                         dim=-1)
    return coll.all_gather(x, x.dim() - 1, tp_group)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalise in f32, cast back to x.dtype, then scale in x.dtype."""
    x32 = x.float()
    scale = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * scale).to(x.dtype) * w.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _rope_freqs(theta: float, half: int, device: torch.device):
    """theta^(-i/half) for i < half, made once per device: building the
    scalar base on a card copies it from the host and waits for the card,
    which a decode tick must not do."""
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=device) / half
    return torch.pow(torch.tensor(theta, dtype=torch.float32, device=device),
                     exponent)


def rope_tables(cfg: LlamaConfig, positions: torch.Tensor):
    """cos/sin tables for ``positions`` [..., L] → [..., L, head_dim//2]."""
    freqs = _rope_freqs(cfg.rope_theta, cfg.head_dim // 2, positions.device)
    angles = positions[..., None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotary rotation, half-split (HF/NeoX) convention: dimension i pairs
    with i + Dh/2.  x: [B, L, H, Dh]; a bf16 x times the f32 tables
    promotes to f32 before the final cast, as in the reference."""
    x1, x2 = x.chunk(2, dim=-1)
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)


def _attention(cfg: LlamaConfig, q, k, v, *, positions_offset,
               sp_group=None):
    impl = cfg.attn_impl
    if impl == "dense":
        return attn_mod.dense_attention(
            q, k, v, causal=True,
            q_offset=positions_offset, kv_offset=positions_offset)
    if impl == "blockwise":
        return attn_mod.blockwise_attention(
            q, k, v, causal=True, block_size=cfg.attn_block_size,
            q_offset=positions_offset, kv_offset=positions_offset)
    if impl == "flash":
        return flash_attention(q, k, v, causal=True)
    if impl in ("ring", "ulysses", "ulysses_flash"):
        if sp_group is None:
            # The reference fails here with "unbound axis name: None".
            raise ValueError(
                f"attn_impl={impl!r} is sequence-parallel: forward needs "
                f"sp_group, the process group the sequence is sharded over "
                f"(got None)")
        if impl == "ring":
            return attn_mod.ring_attention(q, k, v, group=sp_group,
                                           causal=True)
        return attn_mod.ulysses_attention(
            q, k, v, group=sp_group, causal=True,
            impl=flash_attention if impl == "ulysses_flash" else None)
    raise ValueError(f"unknown attn_impl {impl!r}")


def _layer(params: dict, i: int) -> dict:
    return {name: params["layers"][name][i] for name in _LAYER_KEYS}


def _mlp(cfg: LlamaConfig, x, lp, tp_group=None):
    dt = cfg.dtype
    h = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    gate = F.silu(h @ lp["w_gate"].to(dt))
    up = h @ lp["w_up"].to(dt)
    return x + _tp_psum((gate * up) @ lp["w_down"].to(dt), tp_group)


def _qkv(cfg: LlamaConfig, x, lp, cos, sin):
    # heads from the weights' widths: a tensor-parallel shard holds
    # n_heads / tp of them, each of cfg.head_dim
    dt = cfg.dtype
    b, l = x.shape[:2]
    h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
    q = (h @ lp["wq"].to(dt)).reshape(b, l, -1, cfg.head_dim)
    k = (h @ lp["wk"].to(dt)).reshape(b, l, -1, cfg.head_dim)
    v = (h @ lp["wv"].to(dt)).reshape(b, l, -1, cfg.head_dim)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _embed(params: dict, tokens: torch.Tensor, cfg: LlamaConfig,
           tp_group=None):
    # gather first, THEN cast: converts [B, L, D] activations, not the
    # whole [V, D] table.
    return _tp_gather(params["embed"][tokens].to(cfg.dtype), tp_group)


def _logits(params: dict, x: torch.Tensor, cfg: LlamaConfig,
            tp_group=None):
    return _tp_gather((x @ params["lm_head"].to(cfg.dtype)).float(),
                      tp_group)


_REMAT_POLICIES = (
    "dots_saveable",
    "dots_with_no_batch_dims_saveable",
    "everything_saveable",
    "nothing_saveable",
)
# Matrix products as the dispatcher sees them: a [B, L, D] @ [D, F] weight
# product is a 2-D ``mm``/``addmm``; attention's head-batched products are
# ``bmm``/``baddbmm``.
_WEIGHT_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}
_BATCHED_DOTS = {torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default}


def _remat_save(policy: str, op) -> bool:
    if policy == "everything_saveable":
        return True
    if policy == "dots_saveable":
        return op in _WEIGHT_DOTS or op in _BATCHED_DOTS
    if policy == "dots_with_no_batch_dims_saveable":
        return op in _WEIGHT_DOTS
    return False                                    # nothing_saveable


def _resolve_remat_policy(cfg: LlamaConfig) -> Callable | None:
    """The ``context_fn`` of ``torch.utils.checkpoint`` for the named
    policy (None: full remat, nothing saved)."""
    if cfg.remat_policy is None:
        return None
    if cfg.remat_policy not in _REMAT_POLICIES:
        raise ValueError(
            f"unknown remat_policy {cfg.remat_policy!r}; pick one of "
            f"{_REMAT_POLICIES}")
    policy = cfg.remat_policy

    def policy_fn(ctx, op, *args, **kwargs):
        return (ckpt.CheckpointPolicy.MUST_SAVE if _remat_save(policy, op)
                else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(ckpt.create_selective_checkpoint_contexts,
                             policy_fn)


def _block(cfg: LlamaConfig, x, lp, cos, sin, positions_offset, sp_group):
    """One transformer layer: attention and MLP, each with its residual."""
    b, l = x.shape[:2]
    q, k, v = _qkv(cfg, x, lp, cos, sin)
    o = _attention(cfg, q, k, v, positions_offset=positions_offset,
                   sp_group=sp_group)
    x = x + o.reshape(b, l, cfg.dim) @ lp["wo"].to(cfg.dtype)
    return _mlp(cfg, x, lp)


def forward(params: dict, tokens: torch.Tensor, cfg: LlamaConfig, *,
            positions_offset: int = 0, sp_group=None,
            return_hidden: bool = False) -> torch.Tensor:
    """Token ids [B, L] → logits [B, L, V] (f32).

    ``positions_offset``: the global position of tokens[:, 0] (nonzero on
    a sequence slice).  ``sp_group``: the process group the sequence is
    sharded over, for ``attn_impl`` ring, ulysses and ulysses_flash (the
    reference's ``sp_axis``); each rank passes its slice of the tokens.

    With ``cfg.remat`` and autograd recording, each layer runs under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are
    recomputed in the backward, or, with ``cfg.remat_policy``, those the
    policy names are kept.  ``return_hidden=True`` stops after the final
    norm ([B, L, D]) so the fused loss can stream the vocab projection."""
    if cfg.remat_policy is not None and not cfg.remat:
        raise ValueError(
            "remat_policy is set but remat=False — policy-based remat "
            "needs remat=True (remat_policy alone does nothing)")
    context_fn = _resolve_remat_policy(cfg)   # fail fast on a bad name
    b, l = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = positions_offset + torch.arange(l, device=x.device)[None, :]
    cos, sin = rope_tables(cfg, positions.expand(b, l))
    remat = cfg.remat and torch.is_grad_enabled()
    extra = {} if context_fn is None else {"context_fn": context_fn}
    # One unbind per stacked weight, not a select per layer: the backward
    # of a select writes a zero-filled [n_layers, ...] gradient for every
    # layer and adds it into .grad (O(n_layers²) traffic); unbind's backward
    # stacks the per-layer gradients once.
    layers = {name: params["layers"][name].unbind(0) for name in _LAYER_KEYS}
    for i in range(cfg.n_layers):
        lp = {name: layers[name][i] for name in _LAYER_KEYS}
        if remat:
            x = ckpt.checkpoint(_block, cfg, x, lp, cos, sin,
                                positions_offset, sp_group,
                                use_reentrant=False,
                                **extra)
        else:
            x = _block(cfg, x, lp, cos, sin, positions_offset, sp_group)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return x
    return _logits(params, x, cfg)


def loss_fn(params: dict, batch, cfg: LlamaConfig, **fw_kwargs
            ) -> torch.Tensor:
    """Next-token cross-entropy; batch = (tokens [B, L], targets [B, L]).

    With ``cfg.fused_loss_chunk`` the vocab projection and the softmax run
    chunk by chunk (ops/fused_xent.py): the same math without the
    [B·L, V] logits."""
    tokens, targets = batch
    # `is not None`, not truthiness: fused_loss_chunk=0 must reach the
    # op's chunk validation, not select the plain path.
    if cfg.fused_loss_chunk is not None:
        hidden = forward(params, tokens, cfg, return_hidden=True,
                         **fw_kwargs)
        b, l, d = hidden.shape
        return fused_linear_cross_entropy(
            hidden.reshape(b * l, d), params["lm_head"].to(cfg.dtype),
            targets.reshape(-1), chunk_size=cfg.fused_loss_chunk)
    logits = forward(params, tokens, cfg, **fw_kwargs)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1).long())


def make_loss_fn(cfg: LlamaConfig, **fw_kwargs) -> Callable:
    return functools.partial(loss_fn, cfg=cfg, **fw_kwargs)


# ---------------------------------------------------------------------------
# Autoregressive decoding with a KV cache.
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    """Per-layer key/value buffers: k/v [n_layers, B, max_len, KVH, Dh];
    ``length`` is the number of filled positions: a Python int when all
    rows are in lockstep, or a [B] int64 tensor for ragged rows (the
    continuous-batching shape: each row's next write lands at its own
    position).  The buffers are written in place."""

    k: torch.Tensor
    v: torch.Tensor
    length: Any


def init_cache(cfg: LlamaConfig, batch_size: int, max_len: int, *,
               device: str | torch.device | None = None) -> KVCache:
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
        v=torch.zeros(shape, dtype=cfg.dtype, device=dev),
        length=0,
    )


def _is_ragged(length) -> bool:
    return isinstance(length, torch.Tensor) and length.ndim > 0


def _validate_lengths(lengths, b: int, l: int, fn: str) -> None:
    """Precondition check for ragged ``lengths`` [B] in [1, padded width]."""
    if lengths is None:
        return
    ln = np.asarray(lengths.cpu() if isinstance(lengths, torch.Tensor)
                    else lengths)
    if ln.shape != (b,) or ln.min() < 1 or ln.max() > l:
        raise ValueError(
            f"{fn} lengths must be [batch]={b} values in [1, padded "
            f"width {l}], got shape {ln.shape} range "
            f"[{ln.min() if ln.size else '-'}, "
            f"{ln.max() if ln.size else '-'}]")


def prefill(params: dict, tokens: torch.Tensor, cfg: LlamaConfig,
            cache: KVCache, lengths: torch.Tensor | None = None):
    """Run the prompt through the model, filling cache[:, :, :L] in place.

    Returns (last-position logits [B, V] f32, cache).  Attention is the
    configured engine; with ``attn_impl="flash"`` each layer launches the
    flash kernel once.

    ``lengths`` [B]: optional per-row prompt lengths of a RIGHT-padded
    ragged batch, each in [1, L]: the logits come from each row's last
    valid position and the cache length becomes that [B] tensor.
    """
    b, l = tokens.shape
    _validate_lengths(lengths, b, l, "prefill")
    if l > cache.k.shape[2]:
        raise ValueError(f"prompt width {l} > cache max_len {cache.k.shape[2]}")
    dt = cfg.dtype
    x = _embed(params, tokens, cfg)
    positions = torch.arange(l, device=x.device)[None, :].expand(b, l)
    cos, sin = rope_tables(cfg, positions)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        q, k, v = _qkv(cfg, x, lp, cos, sin)
        o = _attention(cfg, q, k, v, positions_offset=0)
        x = x + o.reshape(b, l, cfg.dim) @ lp["wo"].to(dt)
        x = _mlp(cfg, x, lp)
        cache.k[i, :, :l] = k
        cache.v[i, :, :l] = v
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if lengths is None:
        last = x[:, -1]
        new_len = l
    else:
        new_len = torch.as_tensor(lengths, dtype=torch.int64, device=x.device)
        last = x[torch.arange(b, device=x.device), new_len - 1]
    return _logits(params, last, cfg), cache._replace(length=new_len)


def _cached_attention(cfg: LlamaConfig, q, kc, vc, valid):
    """Attention of new queries over cached K/V, in f32 (decode is bound by
    cache traffic, not by the products).  GQA folds the query heads onto
    their KV head (q head h ↔ kv head h // R) instead of expanding the
    cache.  q: [B, T, H, Dh]; kc/vc: [B, M, KVH, Dh] (H and KVH a
    tensor-parallel shard's own, R the same); valid broadcasts over
    [B, KVH, R, T, M]."""
    b, t, n_heads = q.shape[:3]
    n_kv = kc.shape[2]
    scale = 1.0 / (cfg.head_dim ** 0.5)
    qg = q.reshape(b, t, n_kv, n_heads // n_kv, cfg.head_dim)
    s = torch.einsum("bqkrd,bmkd->bkrqm", qg.float(), kc.float()) * scale
    s = torch.where(valid, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkrqm,bmkd->bqkrd", p, vc.float())
    return o.to(cfg.dtype).reshape(b, t, n_heads * cfg.head_dim)


def decode_step(params: dict, token: torch.Tensor, cfg: LlamaConfig,
                cache: KVCache):
    """One autoregressive step: ``token`` [B] → logits [B, V] + cache.

    Attends over the cached keys/values up to ``length``; the new
    position's K/V are written at index ``length``.  A ragged [B]
    ``cache.length`` delegates to :func:`decode_chunk` with T=1."""
    if _is_ragged(cache.length):
        logits, cache = decode_chunk(params, token[:, None], cfg, cache)
        return logits[:, 0], cache
    b = token.shape[0]
    dt = cfg.dtype
    max_len = cache.k.shape[2]
    pos = int(cache.length)
    if pos >= max_len:
        raise ValueError(f"decode_step: cache is full ({pos} >= {max_len})")
    x = _embed(params, token[:, None], cfg)                # [B, 1, D]
    cos, sin = rope_tables(
        cfg, torch.full((b, 1), pos, dtype=torch.int64, device=x.device))
    # attend to [0, pos] inclusive; broadcasts over [B, KVH, R, 1, M]
    valid = (torch.arange(max_len, device=x.device) <= pos)[
        None, None, None, None, :]
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        q, k, v = _qkv(cfg, x, lp, cos, sin)
        kc, vc = cache.k[i], cache.v[i]                   # [B, M, KVH, Dh]
        kc[:, pos] = k[:, 0]
        vc[:, pos] = v[:, 0]
        o = _cached_attention(cfg, q, kc, vc, valid)
        x = x + o @ lp["wo"].to(dt)
        x = _mlp(cfg, x, lp)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x[:, 0], cfg), cache._replace(length=pos + 1)


def decode_chunk(params: dict, tokens: torch.Tensor, cfg: LlamaConfig,
                 cache: KVCache):
    """Consume T tokens per row in one pass: ``tokens`` [B, T] →
    (logits [B, T, V], cache advanced by T).

    Token j of row r lands at cache position ``pos_r + j`` and attends to
    ``[0, pos_r + j]``.  Every write must land inside ``max_len``: the
    reference silently drops out-of-range scatters, the port raises (a
    scalar length) or leaves the bounds to the caller (a [B] length, whose
    check would cost a device sync each step; :func:`prefill_chunked` and
    the serving batcher keep rows in range).
    """
    b, t = tokens.shape
    dt = cfg.dtype
    max_len = cache.k.shape[2]
    pos = cache.length
    x = _embed(params, tokens, cfg)                       # [B, T, D]
    dev = x.device
    if _is_ragged(pos):
        posv = pos
    else:
        if int(pos) + t > max_len:
            raise ValueError(f"decode_chunk: {int(pos)} + {t} tokens > "
                             f"max_len {max_len}")
        posv = torch.full((b,), int(pos), dtype=torch.int64, device=dev)
    qpos = posv[:, None] + torch.arange(t, device=dev)[None, :]     # [B, T]
    cos, sin = rope_tables(cfg, qpos)
    # key m visible to query j of row r iff m <= pos_r + j
    valid = torch.arange(max_len, device=dev)[None, None, :] <= qpos[:, :, None]
    valid = valid[:, None, None, :, :]                    # [B,1,1,T,M]
    rows = torch.arange(b, device=dev)[:, None]
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        q, k, v = _qkv(cfg, x, lp, cos, sin)
        kc, vc = cache.k[i], cache.v[i]
        kc[rows, qpos] = k                                # [B,T,…] scatter
        vc[rows, qpos] = v
        o = _cached_attention(cfg, q, kc, vc, valid)
        x = x + o @ lp["wo"].to(dt)
        x = _mlp(cfg, x, lp)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg), cache._replace(length=pos + t)


def prefill_chunked(params: dict, tokens: torch.Tensor, cfg: LlamaConfig,
                    cache: KVCache, *, window: int,
                    lengths: torch.Tensor | None = None):
    """Prefill a long prompt through fixed-size :func:`decode_chunk`
    windows: activation memory is O(window·L_cache) instead of O(L²).
    Output == :func:`prefill` (each row's last-valid-position logits and
    an equivalent cache).  The padded width must satisfy
    ``L % window == 0``; ragged true lengths go in ``lengths`` [B]."""
    b, l = tokens.shape
    if l % window:
        raise ValueError(f"padded prompt length {l} not a multiple of "
                         f"window {window}")
    _validate_lengths(lengths, b, l, "prefill_chunked")
    base = cache.length
    dev = cache.k.device
    base_max = int(base.max()) if _is_ragged(base) else int(base)
    if base_max + l > cache.k.shape[2]:
        raise ValueError(
            f"prefill_chunked would overflow the cache: base length "
            f"{base_max} + padded width {l} > max_len {cache.k.shape[2]}")
    basev = (base if _is_ragged(base)
             else torch.full((b,), int(base), dtype=torch.int64, device=dev))
    true_len = (torch.as_tensor(lengths, dtype=torch.int64, device=dev)
                if lengths is not None
                else torch.full((b,), l, dtype=torch.int64, device=dev))
    target = basev + true_len - 1     # absolute pos of each last token
    last = torch.zeros((b, cfg.vocab_size), dtype=torch.float32, device=dev)
    rows = torch.arange(b, device=dev)
    for w0 in range(0, l, window):
        start = cache.length
        startv = (start if _is_ragged(start) else
                  torch.full((b,), int(start), dtype=torch.int64, device=dev))
        logits, cache = decode_chunk(params, tokens[:, w0:w0 + window], cfg,
                                     cache)
        # rows whose last valid token falls inside this window pick their
        # logits; others keep what they have
        hit = (target >= startv) & (target < startv + window)
        idx = torch.clamp(target - startv, 0, window - 1)
        last = torch.where(hit[:, None], logits[rows, idx], last)
    if lengths is not None:
        cache = cache._replace(length=basev + true_len)
    return last, cache


# ---------------------------------------------------------------------------
# Block/paged KV cache (vLLM/PagedAttention layout).
#
# K/V live in a pool of fixed-size blocks ([n_layers, n_blocks, block_size,
# KVH, Dh]) and each slot owns a ``block_table`` row mapping its logical
# positions to physical blocks.  Block 0 is the TRASH block: never
# allocated, the target of every unallocated table entry, so free and idle
# rows that tick with the batch scatter their garbage K/V where nothing
# valid reads it.  The pool, the tables and the lengths are written in
# place (the reference donates them): a tick never copies the pool.
# ---------------------------------------------------------------------------


class PagedKVCache(NamedTuple):
    """Paged K/V pool: k/v ``[n_layers, n_blocks, block_size, KVH, Dh]``,
    ``block_table`` [B, blocks_per_slot] int64 (physical block of each
    logical block; 0 = trash), ``length`` [B] int64 filled positions.  All
    four are updated in place."""

    k: torch.Tensor
    v: torch.Tensor
    block_table: torch.Tensor
    length: torch.Tensor

    @property
    def block_size(self) -> int:
        return self.k.shape[2]

    @property
    def logical_len(self) -> int:
        """Dense attention width each row's table spans (== max_len)."""
        return self.block_table.shape[1] * self.k.shape[2]


def init_paged_cache(cfg: LlamaConfig, n_slots: int, max_len: int, *,
                     block_size: int, n_blocks: int | None = None,
                     device: str | torch.device | None = None,
                     tp_size: int = 1) -> PagedKVCache:
    """A paged pool for ``n_slots`` rows of logical depth ``max_len``.

    ``n_blocks`` defaults to full backing (every slot can hold max_len)
    plus the trash block; pass less to overcommit and let the scheduler
    admission-gate on free blocks.  ``tp_size``: one tensor-parallel
    rank's pool, ``n_kv_heads / tp_size`` heads of every block
    (:func:`paged_cache_partition_specs`)."""
    if max_len % block_size:
        raise ValueError(
            f"max_len {max_len} not a multiple of block_size {block_size}")
    dev = resolve_device(device)
    per = max_len // block_size
    if n_blocks is None:
        n_blocks = n_slots * per + 1          # +1: the trash block
    if n_blocks < per + 1:
        raise ValueError(
            f"n_blocks {n_blocks} cannot back even one full slot "
            f"({per} blocks) plus the trash block")
    shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads // tp_size,
             cfg.head_dim)
    return PagedKVCache(
        k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
        v=torch.zeros(shape, dtype=cfg.dtype, device=dev),
        block_table=torch.zeros((n_slots, per), dtype=torch.int64,
                                device=dev),
        length=torch.zeros((n_slots,), dtype=torch.int64, device=dev),
    )


class BlockPool:
    """Host-side reference-counted allocator over the paged pool's
    physical blocks.

    Every physical block (1..n_blocks-1; block 0 is trash and never
    allocated) is in exactly one of three states:

    * **free**: on the free list, content garbage, allocatable;
    * **referenced**: mapped by >= 1 live rows (``refcount(b)`` users),
      never reclaimed while any reference remains;
    * **cached**: zero references but *indexed* by a prefix index
      (:class:`horovod_tpu_torch.prefix_cache.RadixPrefixCache`), a valid
      immutable KV chunk kept for reuse, in LRU order, reclaimed by the
      index's eviction walk before any live row is preempted.

    The pool is policy-free: which cached block to evict is the radix
    index's call.  Device programs never observe any of it (block tables
    change data, never shapes).
    """

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError(
                f"n_blocks {n_blocks} leaves no allocatable block "
                f"beyond trash block 0")
        self.n_blocks = n_blocks
        # pop() takes low ids first, the classic free-list order
        self._free = list(range(n_blocks - 1, 0, -1))
        self._ref: dict[int, int] = {}       # block -> live references
        self._indexed: set[int] = set()      # owned by a prefix index
        self._lru: dict[int, None] = {}      # zero-ref indexed, LRU order

    def free_count(self) -> int:
        return len(self._free)

    def cached_count(self) -> int:
        return len(self._lru)

    def ref_count(self) -> int:
        """Blocks currently mapped by at least one live row."""
        return len(self._ref)

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def alloc(self) -> int:
        """Take a free block (the caller increfs it when a row maps it).
        Raises IndexError when the free list is empty."""
        return self._free.pop()

    def incref(self, block: int) -> int:
        """One more row maps ``block``; a cached block leaves the LRU."""
        self._lru.pop(block, None)
        n = self._ref.get(block, 0) + 1
        self._ref[block] = n
        return n

    def decref(self, block: int) -> int:
        """One row unmapped ``block``.  At zero references an indexed
        block parks in the LRU cache; an unindexed one is freed."""
        n = self._ref[block] - 1
        if n > 0:
            self._ref[block] = n
            return n
        del self._ref[block]
        if block in self._indexed:
            self._lru[block] = None          # MRU end
        else:
            self._free.append(block)
        return 0

    def mark_indexed(self, block: int) -> None:
        """A prefix index now owns ``block``'s content: zero-ref no
        longer means free, it means cached."""
        self._indexed.add(block)

    def drop_indexed(self, block: int) -> None:
        """The index evicted ``block`` (must be zero-ref): back to the
        free list."""
        if block in self._ref:
            raise RuntimeError(
                f"evicting block {block} with {self._ref[block]} live "
                f"references")
        self._indexed.discard(block)
        self._lru.pop(block, None)
        self._free.append(block)

    def lru_blocks(self) -> list[int]:
        """Zero-ref cached blocks, least-recently-used first."""
        return list(self._lru)

    def state_lines(self) -> list[str]:
        """Human-readable pool picture for scheduler state dumps."""
        shared = {b: n for b, n in sorted(self._ref.items()) if n > 1}
        return [
            f"block pool: free={len(self._free)} "
            f"cached_zero_ref={len(self._lru)} "
            f"referenced={len(self._ref)} "
            f"of {self.n_blocks - 1} allocatable",
            f"  lru (old->new)={list(self._lru)} shared_refcounts="
            f"{shared if shared else '{}'}",
        ]


def _paged_attend(params, tokens, cfg: LlamaConfig, kv_k, kv_v, qpos,
                  wflat, gflat, tp_group=None):
    """Shared body of the paged decode paths: scatter the chunk's K/V at
    flat physical positions ``wflat`` [B, T] (in place), gather each row's
    dense [M] view via ``gflat`` [B, M], and run :func:`decode_chunk`'s
    mask and :func:`_cached_attention` on it.  M equals the logical depth,
    so for equal cache values the arithmetic is :func:`decode_chunk`'s on
    tensors of the same shapes: the logits are bit for bit the dense
    path's (gathered garbage past a row's frontier is masked to an exact
    zero softmax term, as dense pad slots are).  Repeated indices in
    ``wflat`` occur only in the trash block, where any winner is fine.

    ``tp_group``: ``params`` and the pool are this rank's Megatron shard
    (:func:`shard_params`, :func:`paged_cache_partition_specs`); the
    embedding's D-slice and the logits' vocabulary slice are all-gathered
    and the ``wo`` and ``w_down`` products summed over the group, so every
    rank returns the same full f32 logits."""
    b, t = tokens.shape
    _, n_blocks, bs, kvh, dh = kv_k.shape
    m = gflat.shape[1]
    x = _embed(params, tokens, cfg, tp_group)             # [B, T, D]
    cos, sin = rope_tables(cfg, qpos)
    valid = torch.arange(m, device=x.device)[None, None, :] <= qpos[:, :, None]
    valid = valid[:, None, None, :, :]                    # [B,1,1,T,M]
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        q, k, v = _qkv(cfg, x, lp, cos, sin)
        kf = kv_k[i].view(n_blocks * bs, kvh, dh)
        vf = kv_v[i].view(n_blocks * bs, kvh, dh)
        kf[wflat] = k
        vf[wflat] = v
        o = _cached_attention(cfg, q, kf[gflat], vf[gflat], valid)
        x = x + _tp_psum(o @ lp["wo"].to(cfg.dtype), tp_group)
        x = _mlp(cfg, x, lp, tp_group)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg, tp_group)


def _gather_index(table: torch.Tensor, bs: int) -> torch.Tensor:
    """Flat pool positions of every logical position of each row:
    [B, per] table → [B, per·bs]."""
    b, per = table.shape
    offs = torch.arange(bs, device=table.device)
    return (table[:, :, None] * bs + offs[None, None, :]).reshape(b, per * bs)


def decode_chunk_paged(params: dict, tokens: torch.Tensor, cfg: LlamaConfig,
                       pcache: PagedKVCache, *,
                       advance: torch.Tensor | None = None, tp_group=None):
    """Paged :func:`decode_chunk`: T tokens per row against the block pool;
    token j of row r lands in the physical block its table maps position
    ``length_r + j`` to.  Returns (logits [B, T, V] f32, pcache) with the
    pool and ``length`` updated in place.

    ``advance`` [B]: optional per-row length increments (0 or T), so a
    fixed-shape serving tick holds idle rows in place: they still compute,
    their writes land in their own blocks (trash for free rows) and their
    length stays put.  ``None`` advances every row by T.  ``tp_group``: a
    tensor-parallel shard's pass (:func:`_paged_attend`)."""
    b, t = tokens.shape
    bs = pcache.block_size
    per = pcache.block_table.shape[1]
    qpos = pcache.length[:, None] + torch.arange(t, device=tokens.device)
    # writes past the table (an overflowing row) clamp into its last
    # logical block: in-bounds garbage, never validly read
    wblk = torch.gather(pcache.block_table, 1,
                        torch.clamp(qpos // bs, 0, per - 1))
    wflat = wblk * bs + qpos % bs                         # [B, T]
    logits = _paged_attend(params, tokens, cfg, pcache.k, pcache.v, qpos,
                           wflat, _gather_index(pcache.block_table, bs),
                           tp_group)
    pcache.length.add_(t if advance is None else advance)
    return logits, pcache


def spec_verify_paged(params: dict, cfg: LlamaConfig, pcache: PagedKVCache,
                      last_logits: torch.Tensor, drafts: torch.Tensor,
                      active: torch.Tensor, *, tp_group=None):
    """One batched self-speculation verify round over the paged pool: every
    row argmaxes its last logits into ``tok`` and decodes the
    ``(K + 1)``-wide chunk ``[tok, d_1..d_K]`` in one
    :func:`decode_chunk_paged` pass; greedy longest-matching-prefix
    acceptance is computed on the device (a cumprod of per-position
    matches).  ``drafts`` [B, K] pads with ``-1``, which argmax
    predictions never equal (the pad embeds the table's last row, as JAX's
    negative index does); ``active`` [B] gates the length advance as the
    plain tick's does.  Rejected positions roll back by the row's length
    alone (write-before-read).  Every emitted token is the target's own
    argmax, so outputs equal solo greedy :func:`generate` whatever the
    drafter proposed.  Returns ``(tok [B], accept [B], next_logits [B, V],
    pcache)``.  ``tp_group``: a tensor-parallel shard's round (every rank
    gets the same full logits, so the same acceptances)."""
    b, k = drafts.shape
    tok = torch.argmax(last_logits, dim=-1)
    chunk = torch.cat([tok[:, None], drafts], dim=1)      # [B, K+1]
    logits, pcache = decode_chunk_paged(params, chunk, cfg, pcache,
                                        advance=0, tp_group=tp_group)
    preds = torch.argmax(logits, dim=-1)                  # [B, K+1]
    match = (drafts == preds[:, :k]).to(torch.int64)
    accept = torch.cumprod(match, dim=1).sum(dim=1)       # [B]
    pcache.length.add_(active * (1 + accept))
    next_logits = logits[torch.arange(b, device=logits.device), accept]
    return tok, accept, next_logits, pcache


def decode_chunk_paged_row(params: dict, tokens: torch.Tensor,
                           cfg: LlamaConfig, pcache: PagedKVCache,
                           slot: int, *, new_length: int, tp_group=None):
    """One row's T-token chunk against the pool: the chunked-prefill
    admission program.  ``tokens`` [1, T] continue slot ``slot`` from its
    current length; the row's length becomes ``new_length`` (the true
    frontier: for a padded final window less than ``length + T``).  Only
    this slot's blocks (and trash, for pad overflow) are written.
    ``tp_group``: a tensor-parallel shard's window."""
    b, t = tokens.shape
    if b != 1:
        raise ValueError(f"decode_chunk_paged_row is a B=1 program, "
                         f"got batch {b}")
    bs = pcache.block_size
    per = pcache.block_table.shape[1]
    row_table = pcache.block_table[slot:slot + 1]         # [1, per]
    qpos = (pcache.length[slot]
            + torch.arange(t, device=tokens.device))[None, :]   # [1, T]
    wblk = row_table[0][torch.clamp(qpos // bs, 0, per - 1)]
    wflat = wblk * bs + qpos % bs
    logits = _paged_attend(params, tokens, cfg, pcache.k, pcache.v, qpos,
                           wflat, _gather_index(row_table, bs), tp_group)
    pcache.length[slot] = new_length
    return logits, pcache


def filtered_logits(logits: torch.Tensor, temperature, *,
                    top_k: int | None = None,
                    top_p: float | None = None) -> torch.Tensor:
    """Temperature-scaled, top-k/top-p-filtered logits [B, V]: the
    sampling math of :func:`sample_logits`.  ``temperature`` must be
    positive (the greedy short-circuit lives in the caller)."""
    logits = logits / temperature
    v = logits.shape[-1]
    use_k = top_k is not None and top_k < v
    if top_p is not None and top_p < 1.0:
        # One descending sort serves both filters: top-k is a positional
        # mask in sorted space, the nucleus is computed on the (possibly
        # k-masked) sorted logits.
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        if use_k:
            pos = torch.arange(v, device=logits.device)[None, :]
            sorted_desc = torch.where(pos < top_k, sorted_desc, NEG_INF_LOGIT)
        probs = torch.softmax(sorted_desc, dim=-1)
        csum = torch.cumsum(probs, dim=-1)
        # Keep a sorted position while the mass BEFORE it is < p: the
        # first token always qualifies.
        keep = (csum - probs) < top_p
        thresh = torch.where(keep, sorted_desc, torch.inf).amin(
            dim=-1, keepdim=True)
        logits = torch.where(logits >= thresh, logits, NEG_INF_LOGIT)
    elif use_k:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits >= kth, logits, NEG_INF_LOGIT)
    return logits


def sample_logits(logits: torch.Tensor, generator: torch.Generator | None, *,
                  temperature: float = 0.0, top_k: int | None = None,
                  top_p: float | None = None) -> torch.Tensor:
    """One sampling step on [B, V] logits → [B] token ids.

    ``temperature<=0`` is greedy argmax; otherwise one categorical draw
    per row from ``generator`` (draws differ from JAX's: only greedy tokens
    compare across frameworks)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(filtered_logits(logits, temperature, top_k=top_k,
                                          top_p=top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def generate(params: dict, prompt, cfg: LlamaConfig, *, max_new_tokens: int,
             max_len: int | None = None, temperature: float = 0.0,
             top_k: int | None = None, top_p: float | None = None,
             key: torch.Generator | int | None = None,
             prompt_lengths=None) -> torch.Tensor:
    """Greedy (or sampled) generation: prompt [B, L] → [B, max_new_tokens].

    One prefill and a loop of cached decode steps on the parameters'
    device.  ``key``: a ``torch.Generator`` or int seed for sampling
    (default: a generator seeded with 0).  ``prompt_lengths`` [B]: per-row
    lengths of a RIGHT-padded ragged prompt batch.
    """
    dev = params["embed"].device
    prompt = torch.as_tensor(prompt, device=dev)
    b, l = prompt.shape
    max_len = max_len or (l + max_new_tokens)
    if max_len < l + max_new_tokens:
        raise ValueError(
            f"max_len={max_len} < prompt {l} + max_new_tokens {max_new_tokens}")
    cache = init_cache(cfg, b, max_len, device=dev)
    if prompt_lengths is not None:
        prompt_lengths = torch.as_tensor(prompt_lengths, dtype=torch.int64,
                                         device=dev)
    logits, cache = prefill(params, prompt, cfg, cache, lengths=prompt_lengths)
    key = as_generator(key, dev)
    toks = []
    for step in range(max_new_tokens):
        tok = sample_logits(logits, key, temperature=temperature,
                            top_k=top_k, top_p=top_p).to(prompt.dtype)
        toks.append(tok)
        if step + 1 < max_new_tokens:    # the last token needs no decode
            logits, cache = decode_step(params, tok, cfg, cache)
    return torch.stack(toks, dim=1)                       # [B, T]
