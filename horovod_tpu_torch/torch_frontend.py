"""``import horovod_tpu_torch.torch_frontend as hvd``: Horovod's PyTorch API.

The port's counterpart of ``horovod_tpu/torch.py`` (the reference's
horovod/torch/__init__.py and mpi_ops.py): one tensor per process, one
process per GPU, every collective through the eager engine
(:mod:`horovod_tpu_torch.ops.eager`): blocking, async and in-place
allreduce, allgather (ragged dim 0), broadcast, alltoall (with
``splits``), reducescatter, the fork's sparse allreduce, the ``grouped_*``
calls, ``join``, ``barrier``, ``poll`` and ``synchronize``;
``broadcast_parameters``, ``broadcast_optimizer_state``,
``broadcast_object`` and ``allgather_object``; and the hook-driven
``DistributedOptimizer`` (post-accumulate-grad hooks enqueue async
allreduces during the backward, ``step()`` drains them).

Not named ``torch.py``: a file of that name in the package would shadow
``torch`` for any script run from that directory.  The JAX frontend's
int64 guard and 64-bit bit-plane wire exist because JAX runs without x64;
NCCL and gloo reduce int64 and float64 natively, so results here are
exact, as the JAX package's ``HOROVOD_TPU_X64=1`` path is.
"""

from __future__ import annotations

import torch

from horovod_tpu_torch.basics import (HorovodInternalError,  # noqa: F401
                                      cross_rank, cross_size, init,
                                      is_initialized, local_rank, local_size,
                                      mpi_threads_supported, rank, shutdown,
                                      size)
from horovod_tpu_torch.ops import eager as _eager
from horovod_tpu_torch.ops.collective_ops import (Adasum, Average,  # noqa: F401
                                                  Max, Min, ProcessSet,
                                                  Product, Sum)
from horovod_tpu_torch.ops.compression import Compression  # noqa: F401
from horovod_tpu_torch.optim.distributed_optimizer import (  # noqa: F401
    allgather_object, broadcast_object, broadcast_optimizer_state)
from horovod_tpu_torch.optim.eager_optimizer import EagerDistributedOptimizer
from horovod_tpu_torch.timeline import start_timeline, stop_timeline  # noqa: F401


def _op(average, op):
    if op is None:
        op = Average if average else Sum
    return op


def allreduce_async(tensor, average=True, name=None, *, op=None,
                    compression=Compression.none, process_set=None) -> int:
    return _eager.allreduce_async(tensor, name=name, op=_op(average, op),
                                  compression=compression,
                                  process_set=process_set)


def allreduce(tensor, average=True, name=None, *, op=None,
              compression=Compression.none, process_set=None):
    return synchronize(allreduce_async(tensor, average, name, op=op,
                                       compression=compression,
                                       process_set=process_set))


def allreduce_(tensor, average=True, name=None, *, op=None,
               compression=Compression.none, process_set=None):
    """In place: the result is copied into ``tensor``."""
    return tensor.copy_(allreduce(tensor, average, name, op=op,
                                  compression=compression,
                                  process_set=process_set))


def allreduce_async_(tensor, average=True, name=None, *, op=None,
                     compression=Compression.none, process_set=None) -> int:
    """Async in place (reference allreduce_async_, torch/mpi_ops.py:156-176):
    ``synchronize(handle)`` copies the result into ``tensor`` and returns
    it; until then ``tensor`` holds its input."""
    h = allreduce_async(tensor, average, name, op=op,
                        compression=compression, process_set=process_set)
    _eager.update_handle_post(h, inplace_dst=tensor)
    return h


def allgather_async(tensor, name=None) -> int:
    """Async allgather along dim 0; ranks may disagree on dim 0 (sizes are
    negotiated through the engine first)."""
    return _eager.allgather_async(tensor, name)


def allgather(tensor, name=None):
    return synchronize(allgather_async(tensor, name))


def grouped_allgather(tensors, name=None):
    """Allgather many tensors (Horovod 0.28's grouped API): every member's
    shape rides one negotiation, then they are enqueued back to back."""
    prefix = name or "grouped_allgather"
    sizes = _eager.negotiate_gather_sizes_many(
        [tuple(t.shape) for t in tensors], [t.dtype for t in tensors],
        name=prefix)
    handles = [_eager.allgather_async(t, f"{prefix}.{i}", sizes=s)
               for i, (t, s) in enumerate(zip(tensors, sizes))]
    return [synchronize(h) for h in handles]


def alltoall_async(tensor, splits=None, name=None) -> int:
    """``splits[j]`` rows of dim 0 go to rank j (equal by default); the
    result is what every rank sent here, in rank order."""
    return _eager.alltoall_async(tensor, splits, name)


def alltoall(tensor, splits=None, name=None):
    return synchronize(alltoall_async(tensor, splits=splits, name=name))


def reducescatter_async(tensor, name=None, *, op=None) -> int:
    """Average (Horovod's default) or Sum over the ranks, this rank keeping
    its shard of dim 0."""
    return _eager.reducescatter_async(tensor, name,
                                      op=Average if op is None else op)


def reducescatter(tensor, name=None, *, op=None):
    return synchronize(reducescatter_async(tensor, name, op=op))


def grouped_reducescatter(tensors, name=None, *, op=None):
    """Reduce-scatter many tensors (Horovod 0.28): every member is checked
    before any is enqueued."""
    n = size()
    for i, t in enumerate(tensors):
        if t.dim() < 1 or t.shape[0] % n:
            raise ValueError(
                f"grouped_reducescatter member {i}: dim 0 must be divisible "
                f"by size={n}; got shape {tuple(t.shape)}")
    prefix = name or "grouped_reducescatter"
    handles = [reducescatter_async(t, name=f"{prefix}.{i}", op=op)
               for i, t in enumerate(tensors)]
    return [synchronize(h) for h in handles]


def grouped_allreduce(tensors, average=True, *, op=None,
                      compression=Compression.none):
    """Allreduce many tensors as one fusion group (Horovod 0.21)."""
    return _eager.grouped_allreduce_eager(tensors, op=_op(average, op),
                                          compression=compression)


def sparse_allreduce_async(tensor, name=None, *, average: bool = False,
                           ratio: float = 0.01, k: int | None = None) -> int:
    """The fork's top-k sparse allreduce (reference
    horovod/torch/__init__.py:46-83)."""
    return _eager.sparse_allreduce_async(tensor, name, average=average,
                                         ratio=ratio, k=k)


def sparse_allreduce(tensor, name=None, *, average: bool = False,
                     ratio: float = 0.01, k: int | None = None):
    return synchronize(sparse_allreduce_async(tensor, name, average=average,
                                              ratio=ratio, k=k))


def broadcast_async(tensor, root_rank, name=None, *,
                    process_set=None) -> int:
    return _eager.broadcast_async(tensor, root_rank, name,
                                  process_set=process_set)


def broadcast(tensor, root_rank, name=None, *, process_set=None):
    return synchronize(broadcast_async(tensor, root_rank, name,
                                       process_set=process_set))


def broadcast_(tensor, root_rank, name=None, *, process_set=None):
    return tensor.copy_(broadcast(tensor, root_rank, name,
                                  process_set=process_set))


def broadcast_async_(tensor, root_rank, name=None, *,
                     process_set=None) -> int:
    """Async in place (reference broadcast_async_): ``synchronize``
    writes the root's values into ``tensor``."""
    h = broadcast_async(tensor, root_rank, name, process_set=process_set)
    _eager.update_handle_post(h, inplace_dst=tensor)
    return h


def join(device: int = -1) -> int:
    """``hvd.join()`` (Horovod ≥ 0.21): block until every rank has joined,
    standing in with zeros for the others' allreduces meanwhile; returns
    the last rank to join.  ``device`` is accepted for the reference's
    signature (this process's card is ``basics.device()``)."""
    del device
    return _eager.join()


def barrier(name=None) -> None:
    _eager.barrier(name)


def poll(handle: int) -> bool:
    return _eager.poll(handle)


def synchronize(handle: int):
    """The op's result; for the in-place variants, the tensor they named,
    now holding it."""
    post = _eager.take_handle_post(handle) or {}
    out = _eager.synchronize(handle)
    dst = post.get("inplace_dst")
    if dst is not None:
        return dst.copy_(out)
    return out


def broadcast_parameters(params, root_rank: int = 0) -> None:
    """In-place copy of ``root_rank``'s ``state_dict()`` or
    ``named_parameters()`` to every rank (reference
    torch/__init__.py:270-299)."""
    items = list(params.items()) if hasattr(params, "items") else list(params)
    handles = [(t, broadcast_async(t.data, root_rank, name=f"bp.{name}"))
               for name, t in items]
    with torch.no_grad():
        for t, h in handles:
            t.data.copy_(synchronize(h))


class _DistributedOptimizer(EagerDistributedOptimizer):
    """The reference's hook-based wrapper (torch/__init__.py:86-267):
    ``step()`` always synchronizes first, reducing any gradient whose
    hooks did not reach ``backward_passes_per_step`` (the reference's
    behaviour), and other attributes reach the wrapped optimizer."""

    def step(self, closure=None):
        return self._step(closure)

    def __getattr__(self, item):
        # Only reached when normal lookup fails; guard "optimizer" itself
        # for copies and unpickling, where __init__ has not run.
        if item == "optimizer":
            raise AttributeError(item)
        return getattr(self.optimizer, item)


def DistributedOptimizer(optimizer, named_parameters=None, *,
                         compression=Compression.none, op=None,
                         backward_passes_per_step: int = 1):
    """Horovod's ``hvd.DistributedOptimizer``: each parameter's
    post-accumulate-grad hook enqueues an async allreduce of its gradient;
    ``step()`` waits for them and updates."""
    return _DistributedOptimizer(
        optimizer, named_parameters, compression=compression, op=op,
        backward_passes_per_step=backward_passes_per_step)


# hvd.elastic.TorchState / hvd.elastic.run: horovod.torch.elastic
# (Horovod 0.20+; the JAX frontend's horovod_tpu/torch.py:891).
from horovod_tpu_torch import torch_elastic as elastic  # noqa: E402,F401
