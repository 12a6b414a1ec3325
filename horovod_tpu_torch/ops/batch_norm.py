"""Train-mode batch norm with the residual add and ReLU fused in.

``batch_norm_act(x, weight, bias, running_mean, running_var, momentum=,
eps=, relu=, residual=)`` computes ``act(BN(x) [+ residual])`` over the
channel axis of an NCHW tensor with batch statistics, and folds them into
the running statistics with flax's semantics (``momentum`` the weight of
the old value, the *biased* batch variance), as :class:`..models.layers.
BatchNorm` does.

* A CPU tensor takes :func:`batch_norm_act_plain`: ``F.batch_norm``, then
  ``+ residual``, then ``F.relu``, with the running-variance fold of
  ``layers.BatchNorm`` (the composition the JAX package's flax model
  computes, and what the CPU tests hold the models to).
* A CUDA tensor takes :class:`_BatchNormAct`, whose forward and backward
  launch the hand-written kernels of ``csrc/batch_norm.cu`` (built by
  :mod:`.._build`): one statistics pass (which also updates the running
  statistics in place), one apply pass that writes the output once, and
  in the backward a reduce pass and an element-wise pass.  bf16 and f32
  four-dimensional inputs whose channels are whole 16-byte vectors (8
  bf16, 4 f32; every ResNet and Inception norm); a tensor not in
  ``channels_last`` memory is made so; anything else raises.  Nothing
  falls back.  The checks of a shape and its workspace's size are made
  once a shape.

The kernels replace no TPU kernel (the JAX package leaves batch norm to
XLA); they were added because ATen's channels-last batch norm and the
separate ReLU and add passes around it moved about 87 GB a ResNet-50 step
at batch 256, bytes the fused passes do not move (``PERF.md``).

:func:`_forward_reference` and :func:`_backward_reference` are the
kernels' arithmetic in plain PyTorch (f32 statistics, the add before the
one rounding, the backward's Σg and Σg·x̂): the CPU tests check the
backward's formulas on them, and the card's tests hold the kernels to
them.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

# Kernel launches so far, one counter per kernel: each wrapper adds one per
# launch and nothing else touches them except callers that reset them to 0
# to count a run.
stats_launches = 0
apply_launches = 0
bwd_reduce_launches = 0
bwd_elemt_launches = 0

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 2}
_VECTOR = {torch.bfloat16: 8, torch.float32: 4}   # elements in 16 bytes
_DIMS = (0, 2, 3)
_SHAPE = (1, -1, 1, 1)


def batch_norm_act_plain(x, weight, bias, running_mean, running_var, *,
                         momentum: float, eps: float, relu: bool = False,
                         residual: torch.Tensor | None = None):
    """``F.batch_norm`` in train mode, ``+ residual``, ``F.relu``.  torch
    folds var·n/(n−1) into ``running_var`` with weight ``1 − momentum``;
    flax folds var itself: the new share is scaled back by (n−1)/n.  The op
    updates a copy, which autograd keeps unchanged."""
    n = x.numel() // x.shape[1]
    folded = running_var.clone()
    y = F.batch_norm(x, running_mean, folded, weight, bias, True,
                     1.0 - momentum, eps)
    with torch.no_grad():
        kept = running_var * momentum
        running_var.copy_((folded - kept) * ((n - 1) / n) + kept)
    if residual is not None:
        y = y + residual
    return F.relu(y) if relu else y


def batch_norm_act(x, weight, bias, running_mean, running_var, *,
                   momentum: float, eps: float, relu: bool = False,
                   residual: torch.Tensor | None = None):
    """CPU tensors take :func:`batch_norm_act_plain`; CUDA tensors take the
    kernels."""
    if x.device.type == "cpu":
        return batch_norm_act_plain(
            x, weight, bias, running_mean, running_var, momentum=momentum,
            eps=eps, relu=relu, residual=residual)
    return _BatchNormAct.apply(x, weight, bias, residual, running_mean,
                               running_var, momentum, eps, relu)


# -- the kernels' arithmetic in plain PyTorch ------------------------------


def _acc(x: torch.Tensor) -> torch.dtype:
    """f32 arithmetic for f32 and narrower storage; f64 stays f64."""
    return torch.promote_types(x.dtype, torch.float32)


def _forward_reference(x, weight, bias, residual, running_mean,
                       running_var, momentum: float, eps: float,
                       relu: bool):
    """y = act(x·a + b [+ residual]) in f32 with one rounding, and the
    statistics [2, C] (mean, invstd); the running statistics updated in
    place with the biased variance."""
    xf = x.to(_acc(x))
    mean = xf.mean(_DIMS)
    var = (xf - mean.view(_SHAPE)).square().mean(_DIMS)
    invstd = torch.rsqrt(var + eps)
    with torch.no_grad():
        running_mean.mul_(momentum).add_(mean.to(running_mean.dtype),
                                         alpha=1 - momentum)
        running_var.mul_(momentum).add_(var.to(running_var.dtype),
                                        alpha=1 - momentum)
    a = weight.to(xf.dtype) * invstd
    b = bias.to(xf.dtype) - mean * a
    y = xf * a.view(_SHAPE) + b.view(_SHAPE)
    if residual is not None:
        y = y + residual.to(xf.dtype)
    if relu:
        y = y.clamp_min(0)
    return y.to(x.dtype), torch.stack([mean, invstd])


def _backward_reference(dy, x, y, weight, stats, relu: bool,
                        has_residual: bool):
    """(dx, dγ, dβ, d_residual): g = dy·[y > 0] where the ReLU was fused,
    dβ = Σg, dγ = Σg·x̂, dx = γ·invstd·(g − Σg/M − x̂·Σg·x̂/M), and
    d_residual = g."""
    acc = _acc(x)
    mean, invstd = stats[0].to(acc), stats[1].to(acc)
    g = dy.to(acc)
    if relu:
        g = torch.where(y > 0, g, torch.zeros((), dtype=acc, device=g.device))
    xhat = (x.to(acc) - mean.view(_SHAPE)) * invstd.view(_SHAPE)
    m = x.numel() // x.shape[1]
    sum_g, sum_gx = g.sum(_DIMS), (g * xhat).sum(_DIMS)
    a = weight.to(acc) * invstd
    dx = a.view(_SHAPE) * (g - (sum_g / m).view(_SHAPE)
                           - xhat * (sum_gx / m).view(_SHAPE))
    dres = (g.to(dy.dtype) if relu else dy) if has_residual else None
    return (dx.to(x.dtype), sum_gx.to(weight.dtype), sum_g.to(weight.dtype),
            dres)


# -- the kernels -----------------------------------------------------------

_PTR, _INT, _LL, _FLOAT = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_float)
# C signatures: the tensors' pointers, then M, C, dtype, relu (and the
# forward's eps and momentum), then the stream.
_SIGNATURES = {
    "hvd_bn_forward": [_PTR] * 10 + [_LL] + [_INT] * 3 + [_FLOAT] * 2
                      + [_PTR],
    "hvd_bn_backward": [_PTR] * 11 + [_LL] + [_INT] * 3 + [_PTR],
    "hvd_bn_workspace": [_LL, _INT, _INT, ctypes.POINTER(_LL),
                         ctypes.POINTER(_INT)],
}
_lib: ctypes.CDLL | None = None
# Per device: the f32 scratch of the partials and the last-block tickets
# (grown to the largest call so far; kernels on one stream take turns),
# with their pointers.
_workspaces: dict[int, tuple[torch.Tensor, torch.Tensor, int, int]] = {}


def _kernel_lib() -> ctypes.CDLL:
    """``csrc/batch_norm.cu`` built and loaded, its C signatures declared."""
    global _lib
    if _lib is None:
        from horovod_tpu_torch import _build

        lib = _build.load("batch_norm")
        for fn, args in _SIGNATURES.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = _INT
        lib.hvd_cuda_error_string.argtypes = [_INT]
        lib.hvd_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(rc: int, fn: str) -> None:
    if rc != 0:
        msg = _kernel_lib().hvd_cuda_error_string(rc).decode()
        raise RuntimeError(f"{fn} launch failed: {msg} (cudaError {rc})")


@functools.lru_cache(maxsize=None)
def _plan(shape: torch.Size, dtype: torch.dtype) -> tuple[int, int, int]:
    """(M, C, dtype code) of an x of this shape and dtype, which the kernels
    take or this raises; worked out once a shape."""
    if len(shape) != 4:
        raise ValueError(f"batch-norm kernel: x must be NCHW, got "
                         f"{tuple(shape)}")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"batch-norm kernel: x has dtype {dtype}; the "
                        f"kernel takes bf16 or f32")
    c = shape[1]
    if c % _VECTOR[dtype]:
        raise ValueError(f"batch-norm kernel: {c} channels are no whole "
                         f"16-byte vectors of {dtype}")
    return shape.numel() // c, c, _DTYPE_CODE[dtype]


@functools.lru_cache(maxsize=None)
def _need(m: int, c: int, code: int) -> tuple[int, int]:
    floats, tickets = _LL(0), _INT(0)
    _check(_kernel_lib().hvd_bn_workspace(m, c, code, ctypes.byref(floats),
                                          ctypes.byref(tickets)),
           "hvd_bn_workspace")
    return floats.value, tickets.value


def _workspace(index: int, m: int, c: int, code: int) -> tuple[int, int]:
    """Pointers to device ``index``'s scratch and tickets, large enough for
    a call at (m, c); the tickets start at zero and every launch leaves
    them so."""
    floats, tickets = _need(m, c, code)
    have = _workspaces.get(index)
    if have is None or have[0].numel() < floats or have[1].numel() < tickets:
        device = torch.device("cuda", index)
        scratch = torch.empty(floats, dtype=torch.float32, device=device)
        ticket = torch.zeros(max(tickets, 64), dtype=torch.int32,
                             device=device)
        have = (scratch, ticket, scratch.data_ptr(), ticket.data_ptr())
        _workspaces[index] = have
    return have[2], have[3]


def _check_params(c: int, device: torch.device, *params) -> None:
    """weight, bias, running_mean, running_var: contiguous f32 [C] on x's
    device."""
    for t in params:
        if (t.dtype != torch.float32 or t.shape != (c,)
                or t.device != device or not t.is_contiguous()):
            raise ValueError(f"batch-norm kernel: weight, bias, running_mean "
                             f"and running_var must be contiguous f32 [{c}] "
                             f"on {device}")


def _cl(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=torch.channels_last)


def _check_aligned(*tensors) -> None:
    ptrs = 0
    for t in tensors:
        ptrs |= t.data_ptr()
    if ptrs % 16:
        raise ValueError("batch-norm kernel: a tensor is not 16-byte "
                         "aligned")


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _launch(fn, name: str, index: int, *args) -> None:
    """Call C entry ``fn`` with ``args`` and the current stream of device
    ``index``, on that device; raise if a launch is refused."""
    if index == torch._C._cuda_getDevice():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    _check(rc, name)


def _forward_cuda(x, weight, bias, residual, running_mean, running_var,
                  momentum: float, eps: float, relu: bool):
    """The statistics kernel (mean and invstd into [2, C], the running
    statistics updated in place), then the apply kernel.  x channels-last
    (:func:`_cl`)."""
    global stats_launches, apply_launches
    m, c, code = _plan(x.shape, x.dtype)
    device = x.device
    _check_params(c, device, weight, bias, running_mean, running_var)
    if residual is not None:
        if (residual.shape != x.shape or residual.dtype != x.dtype
                or residual.device != device):
            raise ValueError("batch-norm kernel: the residual must match x "
                             "in shape, dtype and device")
        residual = _cl(residual)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    stats = torch.empty((2, c), dtype=torch.float32, device=device)
    _check_aligned(x, y, *(() if residual is None else (residual,)))
    index = device.index
    scratch, ticket = _workspace(index, m, c, code)
    _launch(_kernel_lib().hvd_bn_forward, "hvd_bn_forward", index,
            x.data_ptr(), _ptr(residual), y.data_ptr(), stats.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), running_mean.data_ptr(),
            running_var.data_ptr(), scratch, ticket, m, c, code, relu, eps,
            momentum)
    stats_launches += 1
    apply_launches += 1
    return y, stats


def _backward_cuda(dy, x, y, weight, stats, relu: bool, has_residual: bool,
                   dw=None, db=None):
    """The reduce kernel (dγ, dβ into ``dw``, ``db`` where given), then the
    element-wise kernel (dx, and d_residual = g where the ReLU was fused;
    without it d_residual is dy).  x and y channels-last."""
    global bwd_reduce_launches, bwd_elemt_launches
    dy = _cl(dy)
    if dy.dtype != x.dtype:
        raise TypeError(f"batch-norm kernel: dy has dtype {dy.dtype}, x "
                        f"{x.dtype}")
    m, c, code = _plan(x.shape, x.dtype)
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    dres = (torch.empty_like(x, memory_format=torch.channels_last)
            if has_residual and relu else None)
    if dw is None:
        dw, db = _param_grads(x)
    _check_aligned(dy, dx, *((y,) if relu else ()),
                   *(() if dres is None else (dres,)))
    index = x.device.index
    scratch, ticket = _workspace(index, m, c, code)
    _launch(_kernel_lib().hvd_bn_backward, "hvd_bn_backward", index,
            dy.data_ptr(), _ptr(y), x.data_ptr(), stats.data_ptr(),
            weight.data_ptr(), scratch, ticket, dw.data_ptr(), db.data_ptr(),
            dx.data_ptr(), _ptr(dres), m, c, code, relu)
    bwd_reduce_launches += 1
    bwd_elemt_launches += 1
    if has_residual and not relu:
        dres = dy
    return dx, dw, db, dres


def _param_grads(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    c = x.shape[1]
    return (torch.empty(c, dtype=torch.float32, device=x.device),
            torch.empty(c, dtype=torch.float32, device=x.device))


class _BatchNormAct(torch.autograd.Function):
    """The kernels, on CUDA tensors; the profiler opens a range of this name
    around the forward and ``autograd::engine::evaluate_function:
    _BatchNormActBackward`` around the backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, running_mean, running_var,
                momentum, eps, relu):
        x = _cl(x)
        y, stats = _forward_cuda(x, weight, bias, residual, running_mean,
                                 running_var, momentum, eps, relu)
        # The ReLU's mask is read back from the output, which the next
        # layer keeps anyway; without the ReLU the output is not needed.
        ctx.save_for_backward(x, y if relu else None, weight, stats)
        ctx.relu, ctx.has_residual = relu, residual is not None
        # dγ and dβ allocated here, so that the backward allocates only
        # what has x's size.
        ctx.param_grads = _param_grads(x)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y, weight, stats = ctx.saved_tensors
        # A second backward through the graph takes fresh gradients.
        grads, ctx.param_grads = ctx.param_grads or (None, None), None
        dx, dw, db, dres = _backward_cuda(
            dy, x, y, weight, stats, ctx.relu, ctx.has_residual, *grads)
        return dx, dw, db, dres, None, None, None, None, None
