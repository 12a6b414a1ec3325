"""DistributedOptimizer: data-parallel gradient averaging around a torch optimizer.

Port of ``horovod_tpu/optim/distributed_optimizer.py``
(``allreduce_gradients``, ``DistributedOptimizer``, ``TrainStepResult``,
``make_train_step``, ``broadcast_parameters``,
``broadcast_optimizer_state``, ``broadcast_object``,
``allgather_object``).  The JAX package wraps an
optax transformation inside one compiled SPMD program; the port runs one
process per GPU and wraps a ``torch.optim.Optimizer``, Horovod's own torch
idiom: after the backward, :meth:`DistributedOptimizer.synchronize`
all-reduces every ``.grad`` in fusion buckets (one collective per bucket,
compression applied) and ``step()`` then updates.  As in the JAX package
the reduction runs after the whole backward (no hooks, no overlap), and
clipping, where asked for, comes after it:
backward → ``synchronize()`` → ``clip_grad_norm_`` → ``step()``.

The reduction is one of: the fused bucket allreduce (``op``, including
Adasum, ``compression`` none/fp16/bf16/int8/int4, ``process_set``); the
fork's top-k per gradient (``is_sparse``); or a stateful compressor
(PowerSGD, error feedback) whose state the wrapper keeps and carries in
``state_dict()`` under ``"compression"``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch import basics
from horovod_tpu_torch.ops import collective_ops
from horovod_tpu_torch.ops.collective_ops import (Average, ProcessSet, Sum,
                                                  _ReduceOp)
from horovod_tpu_torch.ops.compression import Compression, TopKCompressor
from horovod_tpu_torch.ops.powersgd import (as_stateful_compressor,
                                            is_stateful_compressor,
                                            state_from_plain, state_to_plain)
from horovod_tpu_torch.utils.tree import leaves, tree_map


def tree_leaves(tree: Any) -> list[torch.Tensor]:
    """The tensors of a parameter tree: nested dicts in sorted key order
    (``jax.tree.leaves``' order), lists and tuples in order, or a module's
    parameters."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tree_leaves(x)]
    raise TypeError(f"not a parameter tree leaf: {type(tree).__name__}")


def allreduce_gradients(
    grads: list[torch.Tensor],
    *,
    op: _ReduceOp = Average,
    compression=Compression.none,
    fusion_threshold_bytes: int | None = None,
    sparse: bool = False,
    sparse_ratio: float = 0.01,
    process_set: ProcessSet | None = None,
) -> list[torch.Tensor]:
    """All-reduce a list of gradients in place, fused into buckets of at
    most ``fusion_threshold_bytes`` (one collective per bucket); with
    ``sparse`` the fork's top-k allreduce of each gradient, unfused."""
    if sparse and process_set is not None:
        raise ValueError(
            "process_set does not compose with the top-k sparse path; "
            "members-only sparse reduction needs a set-local allgather")
    if sparse:
        topk = TopKCompressor(ratio=sparse_ratio)
        for g in grads:
            g.copy_(topk.sparse_allreduce(g, average=op is Average))
        return grads
    return collective_ops.grouped_allreduce_(
        grads, op=op, compression=compression,
        fusion_threshold_bytes=fusion_threshold_bytes,
        process_set=process_set)


def _params(optimizer) -> list[torch.Tensor]:
    return [p for g in optimizer.param_groups for p in g["params"]]


def _params_with_grad(optimizer) -> list[torch.Tensor]:
    return [p for p in _params(optimizer) if p.grad is not None]


class DistributedOptimizer:
    """Wrap a ``torch.optim.Optimizer`` so its updates see the gradients
    reduced over the world (averaged by default).

    Keywords as the reference's: ``op`` (Sum, Average, Min, Max,
    Product, Adasum), ``compression`` (none / fp16 / bf16 / int8 / int4,
    or a stateful compressor: ``PowerSGDCompressor``, ``ErrorFeedback``),
    ``fusion_threshold_bytes`` (``None``: ``HOROVOD_FUSION_THRESHOLD``),
    the fork's ``is_sparse`` with ``sparse_ratio`` (top-k of each
    gradient), ``process_set``, ``local`` (no communication at all) and
    ``backward_passes_per_step`` (k: ``.grad`` sums over k backward
    passes, as ``optax.MultiSteps(use_grad_mean=False)`` does, and the
    allreduce and the update run on the k-th; ``step()`` on the others
    only counts, so a stateful compressor's state moves once per k).

    A stateful compressor's state is made at construction from the
    parameters, one entry a parameter in ``param_groups`` order, and
    rides ``state_dict()`` under ``"compression"`` (so
    ``broadcast_optimizer_state`` and checkpoints carry it).  The
    combinations the JAX package rejects raise ``ValueError``.
    """

    def __init__(
        self,
        optimizer: torch.optim.Optimizer,
        *,
        op: _ReduceOp = Average,
        compression=Compression.none,
        fusion_threshold_bytes: int | None = None,
        is_sparse: bool = False,
        sparse_ratio: float = 0.01,
        local: bool = False,
        backward_passes_per_step: int = 1,
        process_set: ProcessSet | None = None,
    ):
        collective_ops._resolve_op(None, op)
        if backward_passes_per_step < 1:
            raise ValueError(f"backward_passes_per_step must be >= 1, got "
                             f"{backward_passes_per_step}")
        # local=True never touches the wire, so residuals and factors would
        # be dead gradient-sized state: no stateful machinery then.
        self.stateful = is_stateful_compressor(compression) and not local
        if self.stateful:
            compression = as_stateful_compressor(compression)
            if is_sparse:
                raise ValueError(
                    "is_sparse picks the top-k collective; a stateful "
                    "compressor already defines its own wire — wrap "
                    "TopKCompressor in ErrorFeedback instead of combining "
                    "the two flags.")
            if process_set is not None:
                raise ValueError(
                    "process_set does not compose with stateful compressors "
                    "(PowerSGD / ErrorFeedback): their collectives run over "
                    "the full axis — silent full-world mixing would corrupt "
                    "member updates")
            if op not in (Sum, Average):
                raise ValueError(
                    f"stateful compressors support op=Sum/Average, not {op}")
        elif is_sparse and process_set is not None and not local:
            raise ValueError(
                "process_set does not compose with the top-k sparse path; "
                "members-only sparse reduction needs a set-local allgather")
        self.optimizer = optimizer
        self.op = op
        self.compression = compression
        self.fusion_threshold_bytes = fusion_threshold_bytes
        self.is_sparse = is_sparse
        self.sparse_ratio = sparse_ratio
        self.process_set = process_set
        self.local = local
        self.backward_passes_per_step = backward_passes_per_step
        self.comp_state = (compression.init(_params(optimizer))
                           if self.stateful else None)
        self._passes = 0            # backward passes since the last update
        self._synchronized = False

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    @property
    def state(self):
        return self.optimizer.state

    @property
    def accumulating(self) -> bool:
        """True while the next ``step()`` only counts a backward pass."""
        return self._passes + 1 < self.backward_passes_per_step

    def synchronize(self) -> None:
        """All-reduce every ``.grad`` now, in place (once per update)."""
        if self._synchronized:
            return
        if self.stateful:
            self._stateful_reduce()
        elif not self.local:
            allreduce_gradients(
                [p.grad for p in _params_with_grad(self)], op=self.op,
                compression=self.compression,
                fusion_threshold_bytes=self.fusion_threshold_bytes,
                sparse=self.is_sparse, sparse_ratio=self.sparse_ratio,
                process_set=self.process_set)
        self._synchronized = True

    @torch.no_grad()
    def _stateful_reduce(self) -> None:
        """The compressor's ``reduce`` over the parameters that have a
        gradient, each with its own entry of the state."""
        params = _params(self.optimizer)
        idx = [i for i, p in enumerate(params) if p.grad is not None]
        grads = [params[i].grad for i in idx]
        reduced, new = self.compression.reduce(
            grads, [self.comp_state[i] for i in idx],
            average=self.op is Average)
        for g, r in zip(grads, reduced):
            g.copy_(r)
        for i, st in zip(idx, new):
            self.comp_state[i] = st

    def step(self, closure: Callable | None = None):
        """Count a backward pass; on the k-th, synchronize (unless that was
        done already) and update."""
        self._passes += 1
        if self._passes < self.backward_passes_per_step:
            return None
        self.synchronize()
        out = self.optimizer.step(closure)
        self._passes = 0
        self._synchronized = False
        return out

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optimizer.zero_grad(set_to_none=set_to_none)

    def state_dict(self) -> dict:
        """The wrapped optimizer's ``state_dict()``, plus the compressor's
        state under ``"compression"`` when the compressor is stateful."""
        sd = self.optimizer.state_dict()
        if self.stateful:
            sd["compression"] = state_to_plain(self.comp_state)
        return sd

    def load_state_dict(self, state_dict: dict) -> None:
        """Load :meth:`state_dict`'s format.  A ``"compression"`` entry must
        be there exactly when this wrapper's compressor is stateful: a
        mismatch raises ``ValueError`` rather than dropping the saved
        compressor state or keeping a fresh one."""
        state_dict = dict(state_dict)
        comp = state_dict.pop("compression", None)
        if (comp is not None) != self.stateful:
            raise ValueError(
                "the state dict "
                f"{'holds' if comp is not None else 'lacks'} a stateful "
                "compressor's state (\"compression\") but this wrapper's "
                f"compressor is {'' if self.stateful else 'not '}stateful")
        if self.stateful:
            params = _params(self.optimizer)
            if len(comp) != len(params):
                raise ValueError(
                    f"compression state has {len(comp)} entries for "
                    f"{len(params)} parameters")
            self.comp_state = [state_from_plain([c], p.device)[0]
                               for c, p in zip(comp, params)]
        self.optimizer.load_state_dict(state_dict)


class TrainStepResult(NamedTuple):
    params: Any
    opt_state: Any
    loss: torch.Tensor


def make_train_step(
    loss_fn: Callable[..., torch.Tensor],
    optimizer: DistributedOptimizer | torch.optim.Optimizer,
    *,
    max_grad_norm: float | None = None,
) -> Callable[..., TrainStepResult]:
    """The canonical data-parallel step: ``step(params, batch)`` runs
    ``loss_fn(params, batch)`` on this process's shard of the batch,
    backward, ``synchronize()``, ``clip_grad_norm_(max_grad_norm)`` when
    given, ``step()`` and ``zero_grad()``, and returns the updated params
    (in place), the optimizer state and the loss averaged over the world.

    Where the JAX step takes a rank-major batch and shards it over the mesh,
    each process here passes its own rows.  Under
    ``backward_passes_per_step=k`` the first k-1 calls only accumulate."""

    def step(params, batch) -> TrainStepResult:
        loss = loss_fn(params, batch)
        loss.backward()
        updating = not getattr(optimizer, "accumulating", False)
        if updating and max_grad_norm is not None:
            if isinstance(optimizer, DistributedOptimizer):
                optimizer.synchronize()
            torch.nn.utils.clip_grad_norm_(_params_with_grad(optimizer),
                                           max_grad_norm)
        optimizer.step()
        if updating:
            optimizer.zero_grad(set_to_none=True)
        mean_loss = collective_ops.allreduce(loss.detach(), op=Average)
        return TrainStepResult(params, optimizer.state, mean_loss)

    return step


@torch.no_grad()
def broadcast_parameters(params: Any, root_rank: int = 0) -> Any:
    """Make every process hold ``root_rank``'s parameters (in place), the
    reference's model-init sync.  ``params``: a tree as for
    :func:`tree_leaves`.  Returns ``params``."""
    for t in tree_leaves(params):
        collective_ops.broadcast_(t, root_rank)
    return params



@dataclasses.dataclass
class _Leaf:
    """A leaf of the root's tree as every rank learns it: tensors and numpy
    arrays by shape and dtype (their values follow by broadcast), anything
    else (Python numbers, numpy scalars, strings, None) by value."""
    kind: str                   # "tensor" | "ndarray" | "value"
    shape: tuple = ()
    dtype: Any = None
    value: Any = None


def _describe(leaf) -> _Leaf:
    if isinstance(leaf, torch.Tensor):
        return _Leaf("tensor", tuple(leaf.shape), leaf.dtype)
    if isinstance(leaf, np.ndarray):
        return _Leaf("ndarray", leaf.shape, leaf.dtype)
    return _Leaf("value", value=leaf)


def _broadcast_tree(tree: Any, root_rank: int) -> Any:
    """Every rank receives ``root_rank``'s tree (nested dicts, lists and
    tuples): its structure and small values in one object broadcast, then
    each tensor or array leaf in one broadcast on this process's device.
    Tensors come back on that device, arrays as numpy arrays."""
    dev = basics.device()
    is_root = basics.rank() == root_rank
    desc = [tree_map(_describe, tree) if is_root else None]
    dist.broadcast_object_list(desc, src=root_rank, device=dev)
    own = iter(leaves(tree)) if is_root else None

    def fill(d: _Leaf):
        mine = next(own) if is_root else None
        if d.kind == "value":
            return d.value
        if d.kind == "tensor":
            buf = (mine.detach().to(dev, copy=True) if is_root else
                   torch.empty(d.shape, dtype=d.dtype, device=dev))
        else:
            buf = torch.from_numpy(np.array(
                mine if is_root else np.zeros(d.shape, d.dtype))).to(dev)
        collective_ops.broadcast_(buf, root_rank)
        return buf if d.kind == "tensor" else buf.cpu().numpy()

    return tree_map(fill, desc[0])


def broadcast_optimizer_state(opt_state: Any, root_rank: int = 0) -> Any:
    """Make every process hold ``root_rank``'s optimizer state.

    ``opt_state``: a ``torch.optim.Optimizer`` or
    :class:`DistributedOptimizer`, whose ``state_dict()`` (every state
    tensor, ``step`` included, the param groups' hyper-parameters and a
    stateful compressor's state) is broadcast and loaded back, in place,
    and which is returned; or a tree of
    tensors, numpy arrays and Python values, returned as the root's tree
    (arrays stay numpy arrays, scalars keep their types).  Ranks whose
    optimizer has no state yet (no step taken) receive the root's."""
    basics._require_init()
    if isinstance(opt_state, (DistributedOptimizer, torch.optim.Optimizer)):
        opt_state.load_state_dict(
            _broadcast_tree(opt_state.state_dict(), root_rank))
        return opt_state
    return _broadcast_tree(opt_state, root_rank)


def broadcast_object(obj: Any, root_rank: int = 0) -> Any:
    """Every rank receives ``root_rank``'s picklable ``obj`` (the
    resume-epoch pattern of reference examples/keras_imagenet_resnet50.py:
    66-73): ``dist.broadcast_object_list`` on the default group, through
    this process's device.  A world of one returns ``obj``."""
    basics._require_init()
    if basics.size() == 1:
        return obj
    box = [obj if basics.rank() == root_rank else None]
    dist.broadcast_object_list(box, src=root_rank, device=basics.device())
    return obj if basics.rank() == root_rank else box[0]


def allgather_object(obj: Any) -> list:
    """One picklable object per rank; every rank receives the list in rank
    order (``dist.all_gather_object`` on the default group).  A world of
    one returns ``[obj]``."""
    basics._require_init()
    if basics.size() == 1:
        return [obj]
    out = [None] * basics.size()
    dist.all_gather_object(out, obj)
    return out
