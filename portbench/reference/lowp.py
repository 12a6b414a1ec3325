"""fp8 products for the controls: the references one precision down.

A configuration that computes in bf16 has fp8 as the next precision below
it.  These products round both operands to fp8 e4m3 in the forward and
the incoming gradient to fp8 e5m2 in the backward, each tensor with one
scale (its largest magnitude mapped to the format's largest finite
value), and multiply the rounded values in float32, as an fp8 training
recipe with per-tensor current scaling does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2


def round_fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under one scale, back in float32."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = torch.finfo(dtype).max / amax
    return (x.float() * scale).to(dtype).float() / scale


class _Fp8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = round_fp8(a, E4M3), round_fp8(b, E4M3)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = round_fp8(g, E5M2)
        da = qg @ qb.transpose(-1, -2)
        if qb.dim() == 2:
            db = qa.reshape(-1, qa.shape[-1]).t() @ qg.reshape(-1, qg.shape[-1])
        else:
            db = qa.transpose(-1, -2) @ qg
        return da, db


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _Fp8MatMul.apply(a, b)


class _Fp8Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding):
        qx, qw = round_fp8(x, E4M3), round_fp8(w, E4M3)
        ctx.save_for_backward(qx, qw)
        ctx.conf = (stride, padding)
        return F.conv2d(qx, qw, None, stride, padding)

    @staticmethod
    def backward(ctx, g):
        qx, qw = ctx.saved_tensors
        stride, padding = ctx.conf
        qg = round_fp8(g, E5M2)
        dx = torch.nn.grad.conv2d_input(qx.shape, qw, qg, stride, padding)
        dw = torch.nn.grad.conv2d_weight(qx, qw.shape, qg, stride, padding)
        return dx, dw, None, None


def fp8_conv2d(x, w, stride, padding):
    return _Fp8Conv.apply(x, w, stride, padding)
