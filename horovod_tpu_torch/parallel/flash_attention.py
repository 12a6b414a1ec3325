"""Flash-attention forward: a hand-written Hopper kernel and its plain version.

Port of ``horovod_tpu/parallel/flash_attention.py`` (``_flash_forward`` and
the public ``flash_attention``).  The TPU's Pallas ``_flash_kernel`` becomes
``csrc/flash_fwd.cu`` (CUDA C++ for ``sm_90a``, built by :mod:`.._build`);
:func:`_flash_forward_reference` is the same computation in plain PyTorch
(same block loop, causal block skip, tail mask, storage-dtype cast of P,
1e-30 clamp and log-sum-exp).

Dispatch is by the tensors' device: a CPU tensor takes the reference, a
CUDA tensor takes the kernel or raises.  Nothing falls back.

Backward: the dQ and dK/dV kernels (the reference's ``_flash_dq_kernel``
and ``_flash_dkv_kernel``) come with slice 2 of the port (training).
Until then a CUDA backward raises ``NotImplementedError`` unless
``bwd="blockwise"`` (or ``HVD_TORCH_FLASH_BWD=blockwise``) recomputes the
gradients through :func:`blockwise_attention`; on the CPU the default
backward differentiates through the reference.
"""

from __future__ import annotations

import ctypes
import math
import os

import torch

from horovod_tpu_torch.parallel.attention import NEG_INF, blockwise_attention

# Kernel launches so far; the wrapper adds one per launch and nothing else
# touches it except callers that reset it to 0 to count a run.
launches = 0

_DTYPE_CODE = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
_HEAD_DIM = 128       # the kernel's one head width (Llama-3)


def _kv_rows(bh: int, n_heads: int, n_kv_heads: int, device) -> torch.Tensor:
    """KV row of each q row: ``(bh // H)·KVH + (bh % H) // (H / KVH)``."""
    r = torch.arange(bh, device=device)
    return (r // n_heads) * n_kv_heads + (r % n_heads) // (n_heads // n_kv_heads)


def _flash_forward_reference(q, k, v, *, n_heads: int, n_kv_heads: int,
                             causal: bool, block_q: int, block_k: int):
    """Plain PyTorch forward.  q: [B·H, L, D]; k/v: [B·KVH, L, D].

    Returns ``(o [B·H, L, D] in q.dtype, lse [B·H, L, 1] f32)``.  Products
    take storage-dtype operands upcast to f32 (exact for bf16/fp16) with
    f32 accumulation, as the TPU kernel's ``preferred_element_type``."""
    bh, l, d = q.shape
    rows = _kv_rows(bh, n_heads, n_kv_heads, q.device)
    k, v = k[rows], v[rows]
    nq, nk = math.ceil(l / block_q), math.ceil(l / block_k)
    scale = 1.0 / math.sqrt(d)
    outs, lses = [], []
    for qi in range(nq):
        q_start = qi * block_q
        qb = q[:, q_start:q_start + block_q].float()
        bq = qb.shape[1]
        qpos = q_start + torch.arange(bq, device=q.device)[:, None]
        acc = torch.zeros((bh, bq, d), dtype=torch.float32, device=q.device)
        m = torch.full((bh, bq, 1), NEG_INF, dtype=torch.float32, device=q.device)
        lsum = torch.zeros((bh, bq, 1), dtype=torch.float32, device=q.device)
        for ki in range(nk):
            k_start = ki * block_k
            # Skip blocks entirely above the causal diagonal.
            if causal and k_start > q_start + block_q - 1:
                continue
            kb = k[:, k_start:k_start + block_k]
            vb = v[:, k_start:k_start + block_k]
            kpos = k_start + torch.arange(kb.shape[1], device=q.device)[None, :]
            s = torch.matmul(qb, kb.float().transpose(1, 2)) * scale
            mask = kpos < l                          # padded tail keys
            if causal:
                mask = mask & (qpos >= kpos)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            lsum = lsum * corr + p.sum(dim=-1, keepdim=True)
            m = m_new
            # P rides the product in the storage dtype, as in the kernel.
            acc = acc * corr + torch.matmul(p.to(v.dtype).float(), vb.float())
        lc = torch.clamp(lsum, min=1e-30)
        outs.append((acc / lc).to(q.dtype))
        lses.append(m + torch.log(lc))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=1)


def _check_cuda_inputs(q, k, v, n_heads, n_kv_heads):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash kernel: {name} is on {t.device}, not CUDA")
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"flash kernel: {name} has dtype {t.dtype}; "
                            f"the kernel takes bf16, fp16 or f32")
        if not t.is_contiguous():
            raise ValueError(f"flash kernel: {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash kernel: {name} is not 16-byte aligned")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash kernel: q/k/v must share one dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("flash kernel: q/k/v must be on one device")
    bh, l, d = q.shape
    if d != _HEAD_DIM:
        raise ValueError(f"flash kernel: head dim {d}, the kernel takes "
                         f"{_HEAD_DIM}")
    if n_heads % n_kv_heads or bh % n_heads:
        raise ValueError(f"flash kernel: {bh} q rows, {n_heads} heads and "
                         f"{n_kv_heads} kv heads do not divide")
    want = (bh // n_heads * n_kv_heads, l, d)
    if tuple(k.shape) != want or tuple(v.shape) != want:
        raise ValueError(f"flash kernel: k/v must be {want}, got "
                         f"{tuple(k.shape)}/{tuple(v.shape)}")


def _kernel_lib() -> ctypes.CDLL:
    """``csrc/flash_fwd.cu`` built and loaded, its C signatures declared."""
    from horovod_tpu_torch import _build

    lib = _build.load("flash_fwd")
    lib.hvd_flash_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.hvd_flash_fwd.restype = ctypes.c_int
    lib.hvd_cuda_error_string.argtypes = [ctypes.c_int]
    lib.hvd_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _flash_forward_cuda(q, k, v, *, n_heads: int, n_kv_heads: int,
                        causal: bool):
    """Launch ``csrc/flash_fwd.cu`` on the current stream.  Same contract
    as :func:`_flash_forward_reference`; its own 64×64 tiles replace
    ``block_q``/``block_k``."""
    global launches
    _check_cuda_inputs(q, k, v, n_heads, n_kv_heads)
    lib = _kernel_lib()
    bh, l, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, l, 1), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.hvd_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh // n_heads, n_heads, n_kv_heads, l, d,
            _DTYPE_CODE[q.dtype], int(causal), 1.0 / math.sqrt(d), stream)
    if rc != 0:
        msg = lib.hvd_cuda_error_string(rc).decode()
        raise RuntimeError(f"flash_fwd launch failed: {msg} (cudaError {rc})")
    launches += 1
    return o, lse


def _flash_forward(q, k, v, *, n_heads: int, n_kv_heads: int, causal: bool,
                   block_q: int, block_k: int):
    """CPU tensors take the reference; CUDA tensors take the kernel."""
    if q.device.type == "cpu":
        return _flash_forward_reference(
            q, k, v, n_heads=n_heads, n_kv_heads=n_kv_heads, causal=causal,
            block_q=block_q, block_k=block_k)
    return _flash_forward_cuda(q, k, v, n_heads=n_heads,
                               n_kv_heads=n_kv_heads, causal=causal)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, n_heads, n_kv_heads, causal, block_q, block_k,
                bwd_impl):
        out, _ = _flash_forward(q, k, v, n_heads=n_heads,
                                n_kv_heads=n_kv_heads, causal=causal,
                                block_q=block_q, block_k=block_k)
        ctx.save_for_backward(q, k, v)
        ctx.cfg = (n_heads, n_kv_heads, causal, block_q, block_k, bwd_impl)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        n_heads, n_kv_heads, causal, block_q, block_k, bwd_impl = ctx.cfg
        if bwd_impl == "blockwise":
            b = q.shape[0] // n_heads
            l, d = q.shape[1], q.shape[2]

            def fn(q, k, v):
                qb = q.reshape(b, n_heads, l, d).transpose(1, 2)
                kb = k.reshape(b, n_kv_heads, l, d).transpose(1, 2)
                vb = v.reshape(b, n_kv_heads, l, d).transpose(1, 2)
                out = blockwise_attention(qb, kb, vb, causal=causal,
                                          block_size=block_k)
                return out.transpose(1, 2).reshape(b * n_heads, l, d)
        elif q.device.type == "cpu":
            def fn(q, k, v):
                return _flash_forward_reference(
                    q, k, v, n_heads=n_heads, n_kv_heads=n_kv_heads,
                    causal=causal, block_q=block_q, block_k=block_k)[0]
        else:
            raise NotImplementedError(
                "flash_attention backward on CUDA needs the dQ and dK/dV "
                "kernels (horovod_tpu/parallel/flash_attention.py "
                "_flash_dq_kernel, _flash_dkv_kernel), which come with "
                "slice 2 of the port (training); use bwd='blockwise' "
                "meanwhile")
        with torch.enable_grad():
            qd, kd, vd = (t.detach().requires_grad_() for t in (q, k, v))
            out = fn(qd, kd, vd)
            dq, dk, dv = torch.autograd.grad(out, (qd, kd, vd), g)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    block_q: int = 512, block_k: int = 512, bwd: str | None = None,
) -> torch.Tensor:
    """Flash attention for [B, L, H, D] q and [B, L, KVH, D] k/v (GQA ok).

    On CUDA tensors the forward is the hand-written kernel; on CPU tensors
    it is the plain reference, blocked by ``block_q``/``block_k`` (clamped
    to the sequence length).  ``bwd``: ``"kernel"`` (default) or
    ``"blockwise"``; ``None`` reads ``HVD_TORCH_FLASH_BWD``.
    """
    bwd_impl = (bwd or os.environ.get("HVD_TORCH_FLASH_BWD", "kernel")).lower()
    if bwd_impl not in ("kernel", "blockwise"):
        raise ValueError(f"bwd must be 'kernel' or 'blockwise', got {bwd!r}")
    if not (q.dtype == k.dtype == v.dtype):
        # The kernel runs its products on the operands' storage dtype; cast
        # at the call site (usually to the KV cache's dtype).
        raise ValueError(
            f"flash_attention requires q/k/v of one dtype, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}")
    b, l, h, d = q.shape
    kvh = k.shape[2]
    block_q = min(block_q, max(l, 1))
    block_k = min(block_k, max(l, 1))
    # [B, L, H, D] → [B*H, L, D]; at B=1 reshape alone may return a
    # strided view, and the kernel takes contiguous rows.
    qt = q.transpose(1, 2).reshape(b * h, l, d).contiguous()
    kt = k.transpose(1, 2).reshape(b * kvh, l, d).contiguous()
    vt = v.transpose(1, 2).reshape(b * kvh, l, d).contiguous()
    out = _Flash.apply(qt, kt, vt, h, kvh, causal, block_q, block_k, bwd_impl)
    return out.reshape(b, h, l, d).transpose(1, 2)
