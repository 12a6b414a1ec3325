"""Stateful gradient compression: error feedback and PowerSGD.

Port of ``horovod_tpu/ops/powersgd.py``.  The fork's top-k scheme drops
(1−ratio) of every gradient with no correction; **error feedback**
(EF-SGD) remembers what the wire dropped and adds it back before the next
compression.  **PowerSGD** (Vogels et al., 2019) keeps a rank-r
approximation of each gradient matrix by one warm-started power iteration,
two small all-reduces in place of one large one.

Both hold state (residuals, warm-started Q factors), which the stateless
``Compressor`` interface cannot.  They implement the stateful-compressor
protocol over a list of gradients (one entry per parameter, in the
optimizer's order):

    init(grads_template)          -> comp_state   (a list, one entry a leaf)
    reduce(grads, comp_state, *, average) -> (reduced, comp_state)

and :class:`..optim.distributed_optimizer.DistributedOptimizer` keeps the
state and carries it in its ``state_dict()``.  The collectives run on the
default group, one NCCL (CUDA) or gloo (CPU) call each.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Sequence

import torch
import torch.distributed as dist

from horovod_tpu_torch.ops.compression import TopKCompressor


def _world() -> int:
    return dist.get_world_size()


def _reduce_leaves(reduce_leaf, grads, state, average):
    """``reduce_leaf(g, s, average) -> (reduced, new_s)`` over the leaves;
    returns the two lists."""
    outs = [reduce_leaf(g, s, average)
            for g, s in zip(grads, state, strict=True)]
    return [o[0] for o in outs], [o[1] for o in outs]


class ErrorFeedback:
    """Residual-corrected lossy all-reduce (EF-SGD / EF14).

    Wraps a lossy compressor ``inner`` (:class:`TopKCompressor`, or a
    quantized-wire compressor with ``quantized_allreduce`` and
    ``roundtrip``: int8, int4) and keeps one f32 residual per gradient:

        corrected = grad + residual
        reduced   = lossy_allreduce(corrected)
        residual' = corrected − transmitted(corrected)

    where ``transmitted`` is this rank's own contribution to the wire."""

    def __init__(self, inner):
        cls = inner if isinstance(inner, type) else type(inner)
        quantized = callable(getattr(cls, "quantized_allreduce", None)) and (
            callable(getattr(cls, "roundtrip", None)))
        if not (issubclass(cls, TopKCompressor) or quantized):
            raise TypeError(
                "ErrorFeedback supports the lossy wire compressors "
                f"(topk / int8 / int4); got {inner!r}. Dense cast "
                "compressors (fp16/bf16) lose nothing an allreduce can "
                "recover — use them directly.")
        if isinstance(inner, type):
            inner = inner()
        self.inner = inner

    def init(self, grads_template: Sequence[torch.Tensor]) -> list:
        return [torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                for g in grads_template]

    def transmitted(self, corrected: torch.Tensor) -> torch.Tensor:
        """What ONE rank's wire contribution to this tensor looks like
        after the lossy compressor: the single definition of the
        residual's base."""
        if isinstance(self.inner, TopKCompressor):
            flat = corrected.reshape(-1)
            idxs = self.inner.select(flat)
            return (torch.zeros_like(flat).index_copy_(0, idxs, flat[idxs])
                    .reshape(corrected.shape))
        return type(self.inner).roundtrip(corrected)

    def _reduce_leaf(self, g, e, average):
        corrected = g.to(torch.float32) + e
        residual = corrected - self.transmitted(corrected)
        if isinstance(self.inner, TopKCompressor):
            reduced = self.inner.sparse_allreduce(corrected, average=average)
            return reduced.to(g.dtype), residual
        # int8/int4: one-shot is forced, because the residual models the
        # first quantization exactly and two-shot's second rounding would
        # leak past it.
        reduced = type(self.inner).quantized_allreduce(
            corrected, average=average, two_shot=False)
        return reduced.to(g.dtype), residual

    def reduce(self, grads, state, *, average=True):
        return _reduce_leaves(self._reduce_leaf, grads, state, average)


class _PowerSGDLeafState(NamedTuple):
    q: torch.Tensor          # [m, r] warm-started right factor
    residual: torch.Tensor   # [n, m] error-feedback memory


def _dense_sentinel(device=None) -> torch.Tensor:
    """Marks a leaf that stays on the exact dense path (an empty tensor,
    as in the JAX package's state)."""
    return torch.zeros((0,), dtype=torch.float32, device=device)


def _matrix_shape(shape: tuple) -> tuple[int, int]:
    """Squarest 2-D view of a gradient: split the dims where rows and
    columns balance best."""
    best, best_gap = (1, 1), None
    prod = 1
    for d in shape:
        prod *= d
    left = 1
    for i in range(len(shape) + 1):
        n, m = left, prod // left
        gap = abs(n - m)
        if best_gap is None or gap < best_gap:
            best, best_gap = (n, m), gap
        if i < len(shape):
            left *= shape[i]
    return best


def _orthonormalize(p: torch.Tensor) -> torch.Tensor:
    """Gram–Schmidt on the columns of ``p`` [n, r].  A column that is
    (numerically) dependent on the earlier ones is zeroed, not normalized:
    dividing its ~0 norm would blow cancellation noise up into a garbage
    direction."""
    cols: list[torch.Tensor] = []
    scale = torch.clamp(torch.linalg.vector_norm(p, dim=0).max(), min=1e-20)
    for i in range(p.shape[1]):
        c = p[:, i]
        for prev in cols:
            c = c - torch.dot(prev, c) * prev
        norm = torch.linalg.vector_norm(c)
        c = torch.where(norm > 1e-6 * scale, c / torch.clamp(norm, min=1e-20),
                        torch.zeros_like(c))
        cols.append(c)
    return torch.stack(cols, dim=1)


def _pmean(x: torch.Tensor) -> torch.Tensor:
    dist.all_reduce(x)
    return x / _world()


class PowerSGDCompressor:
    """Rank-``r`` PowerSGD all-reduce with warm start and error feedback.

    Per gradient ``M`` [n, m] in its squarest view (others go dense):

        M ← grad + residual
        P = M·Q;  P ← mean over ranks;  P̂ = orthonormalize(P)
        Q = Mᵀ·P̂; Q ← mean over ranks
        M̂ = P̂·Qᵀ;  residual ← M − M̂

    The wire carries r·(n+m) floats in place of n·m.  Leaves under
    ``min_compress_size`` elements, or whose view is [1, N], stay on the
    exact dense path.  Q starts from a ``torch.Generator`` seeded with
    ``seed + i`` for leaf i."""

    def __init__(self, rank: int = 4, min_compress_size: int = 4096,
                 seed: int = 0):
        self.rank = rank
        self.min_compress_size = min_compress_size
        self.seed = seed

    def _compresses(self, g) -> bool:
        if g.numel() < self.min_compress_size:
            return False
        n, m = _matrix_shape(tuple(g.shape))
        return min(n, m) > 1

    def init(self, grads_template: Sequence[torch.Tensor]) -> list:
        states: list = []
        for i, g in enumerate(grads_template):
            if not self._compresses(g):
                states.append(_dense_sentinel(g.device))
                continue
            n, m = _matrix_shape(tuple(g.shape))
            r = min(self.rank, n, m)
            gen = torch.Generator().manual_seed(self.seed + i)
            q = torch.randn((m, r), generator=gen, dtype=torch.float32)
            states.append(_PowerSGDLeafState(
                q=q.to(g.device),
                residual=torch.zeros((n, m), dtype=torch.float32,
                                     device=g.device)))
        return states

    def _reduce_leaf(self, g, st, average):
        if not isinstance(st, _PowerSGDLeafState):      # dense sentinel
            out = g.clone()
            dist.all_reduce(out)
            if average:
                out = out / _world()
            return out, st
        n, m = st.residual.shape
        mat = g.to(torch.float32).reshape(n, m) + st.residual
        p_hat = _orthonormalize(_pmean(mat @ st.q))      # [n, r]
        q = _pmean(mat.T @ p_hat)                        # [m, r]
        approx = p_hat @ q.T                             # ≈ mean over ranks
        residual = mat - approx
        out = approx if average else approx * _world()
        return out.reshape(g.shape).to(g.dtype), _PowerSGDLeafState(
            q=q, residual=residual)

    def reduce(self, grads, state, *, average=True):
        return _reduce_leaves(self._reduce_leaf, grads, state, average)


def state_to_plain(state: list) -> list:
    """A compressor state as plain lists, dicts and tensors (PowerSGD's
    leaf state as ``{"q", "residual"}``), for ``state_dict()``, the
    broadcast and ``torch.load(weights_only=True)``."""
    return [dict(s._asdict()) if isinstance(s, _PowerSGDLeafState) else s
            for s in state]


def state_from_plain(state: list, device=None) -> list:
    """Inverse of :func:`state_to_plain`, tensors moved to ``device``."""
    def to(t):
        return t.to(device) if device is not None else t

    return [_PowerSGDLeafState(q=to(s["q"]), residual=to(s["residual"]))
            if isinstance(s, dict) else to(s) for s in state]


def is_stateful_compressor(obj: Any) -> bool:
    """The protocol check :class:`DistributedOptimizer` dispatches on
    (instances and classes alike)."""
    return callable(getattr(obj, "init", None)) and callable(
        getattr(obj, "reduce", None))


def as_stateful_compressor(obj: Any) -> Any:
    """Normalize a stateful compressor: instantiate if given the class."""
    return obj() if isinstance(obj, type) else obj
