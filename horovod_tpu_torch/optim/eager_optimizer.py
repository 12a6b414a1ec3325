"""EagerDistributedOptimizer: gradients reduced from backward hooks.

Port of ``horovod_tpu/optim/eager_optimizer.py``, in the reference's own
torch design (horovod/torch/__init__.py:86-267): each parameter's
post-accumulate-grad hook enqueues a named async allreduce of its
gradient the moment autograd has it (:120-165), so the engine's cycle
thread fuses and issues the buckets while the backward still runs;
:meth:`~EagerDistributedOptimizer.synchronize` waits for every handle and
installs the reduced gradients, and ``step()`` then updates (:189-227).

Carried over: ``compression``, the fork's ``is_sparse`` top-k and
``local`` (no communication), ``backward_passes_per_step`` (counted per
parameter, as the reference does), ``op`` (Sum, Average or Adasum) and
``ErrorFeedback``, whose residuals are committed only once every handle
of the step drained (a failed drain keeps the previous ones).  A parameter
whose hook did not fire by ``synchronize`` (a branch this rank did not
take) is reduced then, with a zero gradient if it has none: the other
ranks may have posted it (the reference's ``test_force_allreduce``).

The JAX package's version computes per-rank gradients with ``vmap`` over a
rank-major batch; here each process runs its own backward, and
:meth:`~EagerDistributedOptimizer.backward` is the torch spelling of its
``backward(loss_fn, params, batch)``.
"""

from __future__ import annotations

from typing import Callable

import torch

from horovod_tpu_torch.ops import eager
from horovod_tpu_torch.ops.collective_ops import Adasum, Average, Sum
from horovod_tpu_torch.ops.compression import Compression, TopKCompressor
from horovod_tpu_torch.ops.powersgd import ErrorFeedback
from horovod_tpu_torch.timeline import span


class EagerDistributedOptimizer:
    """Wrap a ``torch.optim.Optimizer``; its parameters' gradients are
    all-reduced from backward hooks through the eager engine."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters=None, *, compression=Compression.none,
                 is_sparse: bool = False, sparse_ratio: float = 0.01,
                 local: bool = False, backward_passes_per_step: int = 1,
                 op=None):
        """``named_parameters`` names the hooks' tensors (``grad.<name>``,
        the same on every rank); by default ``param.<group>.<index>``.
        ``op``: ``Average`` (default), ``Sum`` or ``Adasum``."""
        op = Average if op is None else op
        if op not in (Sum, Average, Adasum):
            raise ValueError(
                f"op= accepts Sum / Average / Adasum, got {op}")
        if op is Adasum and is_sparse:
            raise ValueError("Adasum does not compose with the sparse path")
        if backward_passes_per_step < 1:
            raise ValueError(f"backward_passes_per_step must be >= 1, got "
                             f"{backward_passes_per_step}")
        self.error_feedback: ErrorFeedback | None = None
        if isinstance(compression, ErrorFeedback):
            self.error_feedback = compression
            compression = Compression.none   # the EF path picks the wire
            if is_sparse or local:
                raise ValueError("ErrorFeedback compression already defines "
                                 "the wire; drop is_sparse/local")
            if op is Adasum:
                raise ValueError(
                    "Adasum does not compose with ErrorFeedback compression")
        if op is Adasum and callable(
                getattr(compression, "quantized_allreduce", None)):
            raise ValueError("Adasum does not support wire-format "
                             "compressors (int8); use Compression.fp16/bf16")
        self.optimizer = optimizer
        self.op = op
        self.compression = compression
        self.is_sparse = is_sparse
        self.sparse_ratio = sparse_ratio
        self.local = local
        self.backward_passes_per_step = backward_passes_per_step
        params = [p for g in optimizer.param_groups for p in g["params"]]
        if named_parameters is None:
            named = [(f"param.{gi}.{pi}", p)
                     for gi, g in enumerate(optimizer.param_groups)
                     for pi, p in enumerate(g["params"])]
        else:
            named = list(named_parameters)
            names = [n for n, _ in named]
            if len(set(names)) != len(names):
                raise ValueError("named_parameters holds duplicate names")
            ids = {id(p) for _, p in named}
            named += [(f"param.unnamed.{i}", p) for i, p in enumerate(params)
                      if id(p) not in ids]
            opt_ids = {id(p) for p in params}
            named = [(n, p) for n, p in named if id(p) in opt_ids]
        self._named = named
        self._delay = {n: backward_passes_per_step for n, _ in named}
        self._handles: dict[str, tuple[torch.Tensor, int]] = {}
        self._residuals: dict[str, torch.Tensor] = {}
        # handle -> (name, residual to commit once the whole drain succeeds)
        self._pending_residuals: dict[int, tuple[str, torch.Tensor]] = {}
        self._handle_dtypes: dict[int, torch.dtype] = {}
        self._loss_handle: int | None = None
        self._synchronized = False      # since the last step()
        self._hooks = [p.register_post_accumulate_grad_hook(self._hook(n))
                       for n, p in named if p.requires_grad]

    def _hook(self, name: str):
        def hook(p: torch.Tensor) -> None:
            with span("hvd.hook", tensor=name):
                self._hooked(name, p)
        return hook

    def _hooked(self, name: str, p: torch.Tensor) -> None:
        """The hook's body: count the pass, enqueue on the last one."""
        if self._delay[name] <= 0:
            raise RuntimeError(
                f"Gradients of {name} were computed more than "
                "backward_passes_per_step times before step(); "
                "increase backward_passes_per_step to accumulate them "
                "locally")
        self._delay[name] -= 1
        # A backward after synchronize(): the next synchronize() drains
        # again, so step() never updates on an unreduced gradient.
        self._synchronized = False
        if self._delay[name] == 0 and not self.local:
            try:
                h = self._enqueue(name, p.grad)
            except BaseException:
                # The engine failed mid-backward (HorovodInternalError
                # for elastic.run): drop the update in flight, as a
                # failed synchronize() does, so that a replayed
                # backward starts from a clean count.
                self._discard()
                raise
            self._handles[name] = (p, h)

    def _enqueue(self, name: str, grad: torch.Tensor) -> int:
        tname = "grad." + name
        if self.error_feedback is not None:
            return self._enqueue_with_error_feedback(tname, grad)
        if self.is_sparse:
            return eager.sparse_allreduce_async(
                grad, tname, average=self.op is Average,
                ratio=self.sparse_ratio)
        return eager.allreduce_async(grad, name=tname, op=self.op,
                                     compression=self.compression)

    def _enqueue_with_error_feedback(self, name: str,
                                     g: torch.Tensor) -> int:
        """The residual-corrected lossy allreduce: the wire is the inner
        compressor's (top-k's gather, or int8/int4 one-shot and unfused, so
        that the wire quantizes this tensor's own blocks, which is what
        ``ErrorFeedback.transmitted`` models)."""
        inner = self.error_feedback.inner
        res = self._residuals.get(name)
        if res is None or res.shape != g.shape:
            res = torch.zeros(g.shape, dtype=torch.float32, device=g.device)
        corrected = g.to(torch.float32) + res
        transmitted = self.error_feedback.transmitted(corrected)
        if isinstance(inner, TopKCompressor):
            h = eager.sparse_allreduce_async(
                corrected, name, average=self.op is Average,
                ratio=inner.ratio, k=inner.k)
        else:
            cls = type(inner)
            if callable(getattr(cls, "one_shot", None)):
                cls = cls.one_shot()
            h = eager.allreduce_async(corrected, name=name, op=self.op,
                                      compression=cls, no_fuse=True)
        self._pending_residuals[h] = (name, corrected - transmitted)
        self._handle_dtypes[h] = g.dtype
        return h

    def backward(self, loss_fn: Callable, module: torch.nn.Module,
                 batch) -> torch.Tensor:
        """``loss_fn(module, batch).backward()``: every gradient's hook
        enqueues its allreduce as autograd produces it, and the loss's
        average over the ranks is enqueued after (:meth:`last_loss`).
        Returns this rank's loss, detached."""
        loss = loss_fn(module, batch)
        loss.backward()
        loss = loss.detach()
        if not self.local:
            self._loss_handle = eager.allreduce_async(
                loss.reshape(1), average=True, name="loss")
        return loss

    def last_loss(self) -> torch.Tensor | None:
        """The last :meth:`backward`'s loss averaged over the ranks."""
        if self._loss_handle is None:
            return None
        out = eager.synchronize(self._loss_handle)
        self._loss_handle = None
        return out[0]

    def synchronize(self) -> None:
        """Enqueue the parameters whose hooks have not, wait for every
        handle and copy the reduced gradients into ``.grad``; once per
        update (a second call before ``step()`` does nothing), so that
        ``synchronize()`` → ``clip_grad_norm_`` → ``step()`` reduces once."""
        if self._synchronized:
            return
        self._synchronized = True
        if self.local:
            self._reset()
            return
        with span("hvd.reduce"):
            self._drain()

    def _drain(self) -> None:
        """Enqueue what the hooks did not, wait for every handle and copy
        the outputs in."""
        for name, p in self._named:
            if p.requires_grad and name not in self._handles:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                self._handles[name] = (p, self._enqueue(name, p.grad))
        commits = []
        try:
            for p, h in self._handles.values():
                out = eager.synchronize(h)
                pend = self._pending_residuals.pop(h, None)
                if pend is not None:
                    commits.append(pend)
                want = self._handle_dtypes.pop(h, None)
                if want is not None and out.dtype != want:
                    out = out.to(want)
                p.grad.copy_(out)
            # Only after the whole drain: a failure discards the step, so
            # no residual of it may stick.
            for name, res in commits:
                self._residuals[name] = res
        except BaseException:
            self._discard()
            raise
        finally:
            self._reset()

    def _discard(self) -> None:
        """Drop the update in flight: release its handles and forget their
        residuals, so that none of a failed step sticks."""
        self._synchronized = False
        for _, h in self._handles.values():
            self._pending_residuals.pop(h, None)
            self._handle_dtypes.pop(h, None)
            eager.release(h)
        self._reset()

    def _reset(self) -> None:
        self._handles.clear()
        for n in self._delay:
            self._delay[n] = self.backward_passes_per_step

    @property
    def accumulating(self) -> bool:
        """True while some gradient has had fewer than
        ``backward_passes_per_step`` backward passes since the last update
        (``make_train_step`` then skips ``step()``)."""
        k = self.backward_passes_per_step
        return any(0 < d < k for d in self._delay.values())

    def step(self, closure: Callable | None = None):
        """:meth:`synchronize`, then the wrapped optimizer's ``step``.
        Raises mid-accumulation (some gradient has had fewer than
        ``backward_passes_per_step`` backward passes)."""
        k = self.backward_passes_per_step
        if self.accumulating:
            raise RuntimeError(
                "step() called mid-accumulation: some gradients have had "
                f"fewer than backward_passes_per_step={k} backward passes")
        return self._step(closure)

    def _step(self, closure):
        self.synchronize()
        with span("hvd.update"):
            out = self.optimizer.step(closure)
        self._synchronized = False
        return out

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optimizer.zero_grad(set_to_none=set_to_none)

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    @property
    def state(self):
        return self.optimizer.state

    def state_dict(self) -> dict:
        return self.optimizer.state_dict()

    def load_state_dict(self, state_dict: dict) -> None:
        self.optimizer.load_state_dict(state_dict)

    def remove_hooks(self) -> None:
        """Detach the gradient hooks (the parameters then train without
        this wrapper)."""
        for h in self._hooks:
            h.remove()
        self._hooks = []
