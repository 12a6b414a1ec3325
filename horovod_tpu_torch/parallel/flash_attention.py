"""Flash attention: hand-written Hopper kernels and their plain versions.

Port of ``horovod_tpu/parallel/flash_attention.py`` (``_flash_forward``,
``_flash_backward``, the ``custom_vjp`` glue and the public
``flash_attention``).  The TPU's three Pallas kernels become CUDA C++ for
``sm_90a``, built by :mod:`.._build`:

* ``_flash_kernel`` → :func:`_flash_forward_cuda`: the Hopper kernels
  (TMA, wgmma) for bf16 and fp16, ``hvd_flash_fwd`` (``csrc/flash_fwd.cu``)
  at head dim 128 and ``hvd_flash_fwd_d64`` (``csrc/flash_fwd_d64.cu``) at
  64; ``hvd_flash_fwd_mma`` (``csrc/flash_fwd.cu``), the ``mma.sync``/FMA
  kernel, for f32;
* ``_flash_dq_kernel`` → :func:`_flash_bwd_dq_cuda`: the Hopper kernels
  for bf16 and fp16, ``hvd_flash_bwd_dq`` (``csrc/flash_bwd.cu``) at head
  dim 128 and ``hvd_flash_bwd_dq_d64`` (``csrc/flash_bwd_d64.cu``) at 64;
  ``hvd_flash_bwd_dq_mma`` (``csrc/flash_bwd.cu``) for f32;
* ``_flash_dkv_kernel`` → :func:`_flash_bwd_dkv_cuda`: likewise
  ``hvd_flash_bwd_dkv``, ``hvd_flash_bwd_dkv_d64`` and
  ``hvd_flash_bwd_dkv_mma``.

The kernels take head dims 64 (every ViT) and 128 (every Llama-3); a CUDA
call at any other head dim raises ``ValueError``.

:func:`_flash_forward_reference` and :func:`_flash_backward_reference` are
the same computations in plain PyTorch (same block loops, causal block
skips, tail masks, storage-dtype casts, log-sum-exp, Δ and GQA group-sum).

Dispatch is by the tensors' device: a CPU tensor takes the reference, a
CUDA tensor takes the kernels or raises.  Nothing falls back.  The
backward runs the two kernels (or, on the CPU, the plain backward) unless
``bwd="blockwise"`` (or ``HVD_TORCH_FLASH_BWD=blockwise``) asks for the
cross-check oracle that recomputes the gradients through
:func:`blockwise_attention`.
"""

from __future__ import annotations

import ctypes
import math
import os

import torch

from horovod_tpu_torch.parallel.attention import NEG_INF, blockwise_attention

# Kernel launches so far, one counter per kernel: each wrapper adds one per
# launch and nothing else touches them except callers that reset them to 0
# to count a run.  ``launches`` counts the forward.
launches = 0
dq_launches = 0
dkv_launches = 0

_DTYPE_CODE = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
_HEAD_DIMS = (64, 128)   # the kernels' head widths (ViT, Llama-3)


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


def _group_sum(x: torch.Tensor, n_heads: int, n_kv_heads: int):
    """Per-query-head [B·H, L, D] → per-KV-head [B·KVH, L, D]: the sum over
    each GQA group of ``H / KVH`` consecutive heads, in x's dtype."""
    bh, l, d = x.shape
    b = bh // n_heads
    return x.reshape(b, n_kv_heads, n_heads // n_kv_heads, l, d).sum(2).reshape(
        b * n_kv_heads, l, d).to(x.dtype)


def _delta(o: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Δ = rowsum(dO∘O) in f32, [B·H, L]."""
    return (g.float() * o.float()).sum(-1)


def _bwd_block(q, kx, vx, g, lse, delta, q_start, k_start, *, causal,
               block_q, block_k):
    """P and dS (f32) of one (query block, key block) pair: S masked for
    keys >= L and above the diagonal, P = exp(S − LSE), dP = g·Vᵀ,
    dS = P∘(dP − Δ)·scale.  kx/vx hold the KV head of each q row."""
    l, d = q.shape[1], q.shape[2]
    qb = q[:, q_start:q_start + block_q].float()
    kb = kx[:, k_start:k_start + block_k].float()
    qpos = q_start + torch.arange(qb.shape[1], device=q.device)[:, None]
    kpos = k_start + torch.arange(kb.shape[1], device=q.device)[None, :]
    mask = kpos < l
    if causal:
        mask = mask & (qpos >= kpos)
    scale = 1.0 / math.sqrt(d)
    s = torch.where(mask, torch.matmul(qb, kb.transpose(1, 2)) * scale,
                    NEG_INF)
    p = torch.exp(s - lse[:, q_start:q_start + block_q, None])
    dp = torch.matmul(g[:, q_start:q_start + block_q].float(),
                      vx[:, k_start:k_start + block_k].float().transpose(1, 2))
    return p, p * (dp - delta[:, q_start:q_start + block_q, None]) * scale


def _flash_bwd_dq_reference(q, k, v, do, lse, delta, *, n_heads: int,
                            n_kv_heads: int, causal: bool, block_q: int,
                            block_k: int):
    """Plain version of the dQ kernel: dQ [B·H, L, D] in q's dtype from
    q, k, v, dO, LSE and Δ ([B·H, L] f32).  A loop over query blocks, each
    summing dS·K over the key blocks up to the diagonal, dS rounded to k's
    dtype first (the reference's ``_flash_dq_kernel``)."""
    bh, l, d = q.shape
    rows = _kv_rows(bh, n_heads, n_kv_heads, q.device)
    kx, vx = k[rows], v[rows]
    lse = lse.reshape(bh, l)
    kw = dict(causal=causal, block_q=block_q, block_k=block_k)
    out = []
    for q_start in range(0, l, block_q):
        acc = torch.zeros((bh, min(block_q, l - q_start), d),
                          dtype=torch.float32, device=q.device)
        for k_start in range(0, l, block_k):
            if causal and k_start > q_start + block_q - 1:
                continue
            _, ds = _bwd_block(q, kx, vx, do, lse, delta, q_start, k_start,
                               **kw)
            kb = kx[:, k_start:k_start + block_k].float()
            acc = acc + torch.matmul(ds.to(k.dtype).float(), kb)
        out.append(acc.to(q.dtype))
    return torch.cat(out, dim=1)


def _flash_bwd_dkv_reference(q, k, v, do, lse, delta, *, n_heads: int,
                             n_kv_heads: int, causal: bool, block_q: int,
                             block_k: int):
    """Plain version of the dK/dV kernel: dK and dV per *query* head,
    ``([B·H, L, D], [B·H, L, D])`` in k's and v's dtypes.  A loop over key
    blocks, each summing P'ᵀ·dO and dS'ᵀ·q over the query blocks from the
    diagonal on, P rounded to dO's dtype and dS to q's first (the
    reference's ``_flash_dkv_kernel``)."""
    bh, l, d = q.shape
    rows = _kv_rows(bh, n_heads, n_kv_heads, q.device)
    kx, vx = k[rows], v[rows]
    lse = lse.reshape(bh, l)
    kw = dict(causal=causal, block_q=block_q, block_k=block_k)
    dks, dvs = [], []
    for k_start in range(0, l, block_k):
        width = min(block_k, l - k_start)
        dk = torch.zeros((bh, width, d), dtype=torch.float32, device=q.device)
        dv = torch.zeros((bh, width, d), dtype=torch.float32, device=q.device)
        for q_start in range(0, l, block_q):
            if causal and q_start + block_q - 1 < k_start:
                continue
            p, ds = _bwd_block(q, kx, vx, do, lse, delta, q_start, k_start,
                               **kw)
            qb = q[:, q_start:q_start + block_q].float()
            gb = do[:, q_start:q_start + block_q].float()
            dv = dv + torch.matmul(p.to(do.dtype).float().transpose(1, 2), gb)
            dk = dk + torch.matmul(ds.to(q.dtype).float().transpose(1, 2), qb)
        dks.append(dk.to(k.dtype))
        dvs.append(dv.to(v.dtype))
    return torch.cat(dks, dim=1), torch.cat(dvs, dim=1)


def _flash_backward_reference(q, k, v, o, lse, g, *, n_heads: int,
                              n_kv_heads: int, causal: bool, block_q: int,
                              block_k: int):
    """Plain PyTorch backward.  q/o/g: [B·H, L, D]; k/v: [B·KVH, L, D];
    lse: [B·H, L] or [B·H, L, 1] f32.  Returns ``(dq, dk, dv)`` in the
    inputs' dtypes.

    Step by step the reference's ``_flash_backward``: Δ in f32, the dQ
    pass and the dK/dV pass (:func:`_flash_bwd_dq_reference`,
    :func:`_flash_bwd_dkv_reference`), and the group-sum of the per-query-
    head dK/dV in the storage dtype."""
    delta = _delta(o, g)
    kw = dict(n_heads=n_heads, n_kv_heads=n_kv_heads, causal=causal,
              block_q=block_q, block_k=block_k)
    dq = _flash_bwd_dq_reference(q, k, v, g, lse, delta, **kw)
    dk_h, dv_h = _flash_bwd_dkv_reference(q, k, v, g, lse, delta, **kw)
    return (dq, _group_sum(dk_h, n_heads, n_kv_heads),
            _group_sum(dv_h, n_heads, n_kv_heads))


def _check_cuda_inputs(q, k, v, n_heads, n_kv_heads):
    """Shapes first (they do not depend on the device), then device, dtype
    and layout."""
    bh, l, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash kernel: head dim {d}; the kernels take "
                         f"head dims {_HEAD_DIMS}")
    if n_heads % n_kv_heads or bh % n_heads:
        raise ValueError(f"flash kernel: {bh} q rows, {n_heads} heads and "
                         f"{n_kv_heads} kv heads do not divide")
    want = (bh // n_heads * n_kv_heads, l, d)
    if tuple(k.shape) != want or tuple(v.shape) != want:
        raise ValueError(f"flash kernel: k/v must be {want}, got "
                         f"{tuple(k.shape)}/{tuple(v.shape)}")
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


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# C signatures of the kernels' launch entries: pointers, then B, H, KVH, L,
# D, dtype and causal as ints, then the softmax scale and the stream.
_SIGNATURES = {
    "flash_fwd": {"hvd_flash_fwd": 5, "hvd_flash_fwd_mma": 5},
    "flash_fwd_d64": {"hvd_flash_fwd_d64": 5},
    "flash_bwd": {"hvd_flash_bwd_dq": 7, "hvd_flash_bwd_dkv": 8,
                  "hvd_flash_bwd_dq_mma": 7, "hvd_flash_bwd_dkv_mma": 8},
    "flash_bwd_d64": {"hvd_flash_bwd_dq_d64": 7, "hvd_flash_bwd_dkv_d64": 8},
}
_LIBRARY = {fn: lib for lib, fns in _SIGNATURES.items() for fn in fns}
# Entries by (dtype, head dim).  The Hopper kernels (wgmma, whose only
# 32-bit path is TF32) take the 16-bit types, each head width its own:
# D = 128 in ``flash_fwd`` and ``flash_bwd``, D = 64 in ``flash_fwd_d64``
# and ``flash_bwd_d64``.  f32 takes the mma.sync/FMA kernels.
_HOPPER_FWD = {128: "hvd_flash_fwd", 64: "hvd_flash_fwd_d64"}
_HOPPER_BWD = {128: ("hvd_flash_bwd_dq", "hvd_flash_bwd_dkv"),
               64: ("hvd_flash_bwd_dq_d64", "hvd_flash_bwd_dkv_d64")}
_MMA_FWD = "hvd_flash_fwd_mma"
_MMA_BWD = ("hvd_flash_bwd_dq_mma", "hvd_flash_bwd_dkv_mma")
_FWD_ENTRY = {(dt, d): _MMA_FWD if dt == torch.float32 else _HOPPER_FWD[d]
              for dt in _DTYPE_CODE for d in _HEAD_DIMS}
_BWD_ENTRY = {  # (dtype, D) -> (dQ entry, dK/dV entry)
    (dt, d): _MMA_BWD if dt == torch.float32 else _HOPPER_BWD[d]
    for dt in _DTYPE_CODE for d in _HEAD_DIMS}
_libs: dict[str, ctypes.CDLL] = {}


def _kernel_lib(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu`` built and loaded, its C signatures declared
    (once per library)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    from horovod_tpu_torch import _build

    lib = _build.load(name)
    for fn, n_ptrs in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = [_PTR] * n_ptrs + [_INT] * 7 + [ctypes.c_float, _PTR]
        f.restype = _INT
    lib.hvd_cuda_error_string.argtypes = [_INT]
    lib.hvd_cuda_error_string.restype = ctypes.c_char_p
    _libs[name] = lib
    return lib


def smem_bytes(name: str, entry: str) -> int:
    """Dynamic shared memory of one block of a Hopper kernel, from its
    library's ``<entry>_smem_bytes()``."""
    f = getattr(_kernel_lib(name), f"{entry}_smem_bytes")
    f.argtypes, f.restype = [], _INT
    return f()


def _launch(name: str, fn: str, tensors, q, n_heads, n_kv_heads, causal):
    """Call C entry ``fn`` of kernel library ``name`` on the current stream
    with the pointers of ``tensors`` and q's shape; raise if the launch is
    refused."""
    lib = _kernel_lib(name)
    bh, l, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, fn)(
            *(t.data_ptr() for t in tensors), bh // n_heads, n_heads,
            n_kv_heads, l, d, _DTYPE_CODE[q.dtype], int(causal),
            1.0 / math.sqrt(d), stream)
    if rc != 0:
        msg = lib.hvd_cuda_error_string(rc).decode()
        raise RuntimeError(f"{fn} launch failed: {msg} (cudaError {rc})")


def _flash_forward_cuda(q, k, v, *, n_heads: int, n_kv_heads: int,
                        causal: bool):
    """Launch the forward kernel for q's dtype and head dim (``_FWD_ENTRY``)
    on the current stream: for bf16/fp16 the Hopper kernel of
    ``csrc/flash_fwd.cu`` at D = 128 (128×128 tiles) or of
    ``csrc/flash_fwd_d64.cu`` at D = 64 (64×64), for f32 the
    ``mma.sync``/FMA kernel of ``csrc/flash_fwd.cu`` (64×64).  Same contract
    as :func:`_flash_forward_reference`; the kernel's tiles replace
    ``block_q``/``block_k``."""
    global launches
    _check_cuda_inputs(q, k, v, n_heads, n_kv_heads)
    bh, l, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, l, 1), dtype=torch.float32, device=q.device)
    entry = _FWD_ENTRY[q.dtype, d]
    _launch(_LIBRARY[entry], entry, (q, k, v, o, lse), q, n_heads,
            n_kv_heads, causal)
    launches += 1
    return o, lse


def _check_bwd_inputs(q, k, v, do, lse, delta, n_heads, n_kv_heads):
    _check_cuda_inputs(q, k, v, n_heads, n_kv_heads)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"flash backward: dO must match q, got "
                         f"{tuple(do.shape)} {do.dtype} on {do.device}")
    if not do.is_contiguous() or do.data_ptr() % 16:
        raise ValueError("flash backward: dO is not contiguous and aligned")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or t.device != q.device
                or t.numel() != q.shape[0] * q.shape[1]
                or not t.is_contiguous()):
            raise ValueError(f"flash backward: {name} must be a contiguous "
                             f"f32 [B·H, L] on {q.device}")


def _flash_bwd_dq_cuda(q, k, v, do, lse, delta, *, n_heads: int,
                       n_kv_heads: int, causal: bool):
    """Launch the dQ kernel for q's dtype and head dim (``_BWD_ENTRY``):
    dQ [B·H, L, D] in q's dtype from q, k, v, dO, the forward's LSE and Δ
    ([B·H, L] f32)."""
    global dq_launches
    _check_bwd_inputs(q, k, v, do, lse, delta, n_heads, n_kv_heads)
    dq = torch.empty_like(q)
    entry = _BWD_ENTRY[q.dtype, q.shape[2]][0]
    _launch(_LIBRARY[entry], entry, (q, k, v, do, lse, delta, dq), q,
            n_heads, n_kv_heads, causal)
    dq_launches += 1
    return dq


def _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, *, n_heads: int,
                        n_kv_heads: int, causal: bool):
    """Launch the dK/dV kernel for q's dtype and head dim (``_BWD_ENTRY``):
    dK and dV per *query* head, ``([B·H, L, D], [B·H, L, D])`` in k's
    dtype, for :func:`_group_sum`."""
    global dkv_launches
    _check_bwd_inputs(q, k, v, do, lse, delta, n_heads, n_kv_heads)
    dk_h, dv_h = torch.empty_like(q), torch.empty_like(q)
    entry = _BWD_ENTRY[q.dtype, q.shape[2]][1]
    _launch(_LIBRARY[entry], entry, (q, k, v, do, lse, delta, dk_h, dv_h), q,
            n_heads, n_kv_heads, causal)
    dkv_launches += 1
    return dk_h, dv_h


def _flash_backward_cuda(q, k, v, o, lse, g, *, n_heads: int,
                         n_kv_heads: int, causal: bool):
    """The two backward kernels around Δ and the GQA group-sum, which stay
    torch ops as they are XLA ops outside the Pallas kernels."""
    delta = _delta(o, g)
    lse = lse.reshape(delta.shape)
    kw = dict(n_heads=n_heads, n_kv_heads=n_kv_heads, causal=causal)
    dq = _flash_bwd_dq_cuda(q, k, v, g, lse, delta, **kw)
    dk_h, dv_h = _flash_bwd_dkv_cuda(q, k, v, g, lse, delta, **kw)
    return (dq, _group_sum(dk_h, n_heads, n_kv_heads),
            _group_sum(dv_h, n_heads, n_kv_heads))


def _flash_forward(q, k, v, *, n_heads: int, n_kv_heads: int, causal: bool,
                   block_q: int, block_k: int):
    """CPU tensors take the reference; CUDA tensors take the kernel."""
    if q.device.type == "cpu":
        return _flash_forward_reference(
            q, k, v, n_heads=n_heads, n_kv_heads=n_kv_heads, causal=causal,
            block_q=block_q, block_k=block_k)
    return _flash_forward_cuda(q, k, v, n_heads=n_heads,
                               n_kv_heads=n_kv_heads, causal=causal)


def _flash_backward(q, k, v, o, lse, g, *, n_heads: int, n_kv_heads: int,
                    causal: bool, block_q: int, block_k: int):
    """CPU tensors take the plain backward; CUDA tensors take the kernels."""
    if q.device.type == "cpu":
        return _flash_backward_reference(
            q, k, v, o, lse, g, n_heads=n_heads, n_kv_heads=n_kv_heads,
            causal=causal, block_q=block_q, block_k=block_k)
    return _flash_backward_cuda(q, k, v, o, lse, g, n_heads=n_heads,
                                n_kv_heads=n_kv_heads, causal=causal)


def _blockwise_grads(q, k, v, g, *, n_heads, n_kv_heads, causal, block_k):
    """The cross-check oracle: gradients recomputed through
    :func:`blockwise_attention` by autograd."""
    b = q.shape[0] // n_heads
    l, d = q.shape[1], q.shape[2]

    def fn(q, k, v):
        qb = q.reshape(b, n_heads, l, d).transpose(1, 2)
        kb = k.reshape(b, n_kv_heads, l, d).transpose(1, 2)
        vb = v.reshape(b, n_kv_heads, l, d).transpose(1, 2)
        out = blockwise_attention(qb, kb, vb, causal=causal,
                                  block_size=block_k)
        return out.transpose(1, 2).reshape(b * n_heads, l, d)

    with torch.enable_grad():
        qd, kd, vd = (t.detach().requires_grad_() for t in (q, k, v))
        return torch.autograd.grad(fn(qd, kd, vd), (qd, kd, vd), g)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, n_heads, n_kv_heads, causal, block_q, block_k,
                bwd_impl):
        out, lse = _flash_forward(q, k, v, n_heads=n_heads,
                                  n_kv_heads=n_kv_heads, causal=causal,
                                  block_q=block_q, block_k=block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (n_heads, n_kv_heads, causal, block_q, block_k, bwd_impl)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        n_heads, n_kv_heads, causal, block_q, block_k, bwd_impl = ctx.cfg
        kw = dict(n_heads=n_heads, n_kv_heads=n_kv_heads, causal=causal)
        g = g.contiguous()
        if bwd_impl == "blockwise":
            dq, dk, dv = _blockwise_grads(q, k, v, g, block_k=block_k, **kw)
        else:
            dq, dk, dv = _flash_backward(q, k, v, o, lse, g, block_q=block_q,
                                         block_k=block_k, **kw)
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
