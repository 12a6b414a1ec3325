"""Train-mode batch norm with the residual add and ReLU fused in
(``horovod_tpu_torch/ops/batch_norm.py``).

On the CPU: the fused function against ``F.batch_norm`` → ``+ residual`` →
``F.relu`` with flax's running-statistics fold, in the four variants, for
both plain versions (the composition the CPU takes, and the kernels'
arithmetic, ``_forward_reference`` and ``_backward_reference``, as an
autograd function here); the backward's formulas by ``gradcheck`` in
float64; the wrapper's checks.  On the card
(``cuda`` marker, skipped without a GPU): the kernels against their plain
arithmetic at ResNet-50's batch-256 shapes and at ragged ones, in bf16 and
f32, and one ResNet-50 train step's launches.
This file imports no JAX, so it runs on a machine with the card::

    python -m pytest --noconftest -m cuda tests/test_torch_batch_norm_act.py
"""

from __future__ import annotations

import ctypes
import re
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from horovod_tpu_torch.models import layers
from horovod_tpu_torch.ops import batch_norm as bn

MOMENTUM, EPS = 0.9, 1e-5
# (relu, residual): the block's first norms, its last, the downsample
# path's (nothing fused) and a residual alone.
VARIANTS = [(False, False), (True, False), (True, True), (False, True)]
VARIANT_IDS = ["plain", "relu", "residual_relu", "residual"]


def _inputs(shape, dtype=torch.float32, device="cpu", seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    n, c = shape[0], shape[1]

    def randn(*s):
        return torch.randn(*s, generator=g, device=device)

    # An offset mean, so the statistics have something to cancel.
    x = (3.0 + 2.0 * randn(*shape)).to(dtype)
    r = randn(*shape).to(dtype)
    w = (1.0 + 0.5 * randn(c)).float()
    b = (0.5 * randn(c)).float()
    rm, rv = (0.1 * randn(c)).float(), (1.0 + randn(c).abs()).float()
    dy = randn(*shape).to(dtype)
    if device == "cuda":
        x, r, dy = (t.contiguous(memory_format=torch.channels_last)
                    for t in (x, r, dy))
    return x, r, w, b, rm, rv, dy


def _composition(x, w, b, rm, rv, relu, residual):
    """F.batch_norm → + residual → F.relu, the running variance folded as
    flax folds it: momentum on the old value, the biased batch variance."""
    n = x.numel() // x.shape[1]
    unbiased = rv.clone()
    y = F.batch_norm(x, rm, unbiased, w, b, True, 1 - MOMENTUM, EPS)
    rv.copy_(MOMENTUM * rv + (unbiased - MOMENTUM * rv) * (n - 1) / n)
    if residual is not None:
        y = y + residual
    return F.relu(y) if relu else y


def _fused_plain(x, w, b, rm, rv, relu, residual):
    return bn.batch_norm_act(x, w, b, rm, rv, momentum=MOMENTUM, eps=EPS,
                             relu=relu, residual=residual)


class _Arithmetic(torch.autograd.Function):
    """The kernels' arithmetic in plain PyTorch, with ``_BatchNormAct``'s
    arguments and saved tensors."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, running_mean, running_var,
                momentum, eps, relu):
        y, stats = bn._forward_reference(x, weight, bias, residual,
                                         running_mean, running_var,
                                         momentum, eps, relu)
        ctx.save_for_backward(x, y if relu else None, weight, stats)
        ctx.relu, ctx.has_residual = relu, residual is not None
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y, weight, stats = ctx.saved_tensors
        dx, dw, db, dres = bn._backward_reference(
            dy, x, y, weight, stats, ctx.relu, ctx.has_residual)
        return dx, dw, db, dres, None, None, None, None, None


def _fused_arithmetic(x, w, b, rm, rv, relu, residual):
    return _Arithmetic.apply(x, w, b, residual, rm, rv, MOMENTUM, EPS, relu)


def _run(fn, x, r, w, b, rm, rv, dy, relu, has_residual):
    leaves = [t.detach().clone().requires_grad_()
              for t in (x, w, b, r)]
    rm, rv = rm.clone(), rv.clone()
    y = fn(leaves[0], leaves[1], leaves[2], rm, rv, relu,
           leaves[3] if has_residual else None)
    y.backward(dy)
    grads = [t.grad for t in leaves]
    return y.detach(), grads, rm, rv


@pytest.mark.parametrize("impl", ["plain", "kernel_arithmetic"])
@pytest.mark.parametrize("relu,has_residual", VARIANTS, ids=VARIANT_IDS)
def test_fused_equals_batch_norm_add_relu(relu, has_residual, impl):
    """Forward, the gradients of x, γ, β and the residual, and the running
    statistics, f32 on the CPU."""
    fn = _fused_plain if impl == "plain" else _fused_arithmetic
    x, r, w, b, rm, rv, dy = _inputs((4, 6, 5, 3))
    y, grads, got_rm, got_rv = _run(fn, x, r, w, b, rm, rv, dy, relu,
                                    has_residual)
    y0, grads0, want_rm, want_rv = _run(_composition, x, r, w, b, rm, rv, dy,
                                        relu, has_residual)
    torch.testing.assert_close(y, y0, rtol=1e-5, atol=1e-5)
    for name, got, want in zip(("x", "weight", "bias", "residual"), grads,
                               grads0):
        if name == "residual" and not has_residual:
            assert got is None and want is None
            continue
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5,
                                   msg=lambda m: f"d{name}: {m}")
    torch.testing.assert_close(got_rm, want_rm, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(got_rv, want_rv, rtol=1e-6, atol=1e-7)
    xf = x.double()
    biased = xf.var((0, 2, 3), unbiased=False).float()
    torch.testing.assert_close(got_rv, MOMENTUM * rv + (1 - MOMENTUM) * biased,
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("relu,has_residual", VARIANTS, ids=VARIANT_IDS)
def test_kernel_arithmetic_gradcheck_float64(relu, has_residual):
    """The backward's formulas (Σg, Σg·x̂, the mask from the output) against
    finite differences, in float64."""
    x, r, w, b, rm, rv, _ = _inputs((3, 4, 3, 2), torch.float64, seed=3)
    w, b, rm, rv = (t.double() for t in (w, b, rm, rv))
    leaves = [t.requires_grad_() for t in (x, w, b, r)]

    def fn(x, w, b, r):
        return _Arithmetic.apply(x, w, b, r if has_residual else None, rm,
                                 rv, MOMENTUM, EPS, relu)

    assert torch.autograd.gradcheck(fn, leaves, eps=1e-6, atol=1e-6)


def test_kernel_arithmetic_keeps_bf16_storage_and_f32_statistics():
    """bf16 in, bf16 out with one rounding after the add; the statistics,
    the running statistics and the parameters' gradients in f32."""
    x, r, w, b, rm, rv, dy = _inputs((4, 8, 3, 3), torch.bfloat16, seed=5)
    y, grads, got_rm, got_rv = _run(_fused_arithmetic, x, r, w, b, rm, rv,
                                    dy, True, True)
    assert y.dtype == torch.bfloat16
    assert grads[0].dtype == grads[3].dtype == torch.bfloat16
    assert grads[1].dtype == grads[2].dtype == torch.float32
    xf = x.float()
    mean = xf.mean((0, 2, 3))
    var = xf.var((0, 2, 3), unbiased=False)
    want = ((xf - mean.view(1, -1, 1, 1)) * torch.rsqrt(var + EPS).view(
        1, -1, 1, 1) * w.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)
        + r.float()).clamp_min(0).bfloat16()
    assert torch.equal(y, want)
    torch.testing.assert_close(got_rm, MOMENTUM * rm + (1 - MOMENTUM) * mean)
    torch.testing.assert_close(got_rv, MOMENTUM * rv + (1 - MOMENTUM) * var)


@pytest.mark.parametrize("relu,has_residual", VARIANTS, ids=VARIANT_IDS)
def test_layer_eval_mode_applies_the_add_and_relu_after(relu, has_residual):
    """Eval mode keeps its plain code: the running statistics, then the
    residual and the ReLU; the running statistics do not move."""
    layer = layers.BatchNorm(6, momentum=MOMENTUM, epsilon=EPS)
    x, r, w, b, rm, rv, _ = _inputs((2, 6, 4, 4), seed=7)
    with torch.no_grad():
        for name, t in (("weight", w), ("bias", b), ("running_mean", rm),
                        ("running_var", rv)):
            getattr(layer, name).copy_(t)
    residual = r if has_residual else None
    got = layer(x, train=False, relu=relu, residual=residual)
    want = F.batch_norm(x, rm, rv, w, b, False, 0.0, EPS)
    if has_residual:
        want = want + r
    torch.testing.assert_close(got, F.relu(want) if relu else want)
    torch.testing.assert_close(layer.running_var, rv)


def test_cuda_path_refuses_what_the_kernel_does_not_take():
    """The checks run before any launch, so they are held here."""
    x, r, w, b, rm, rv, _ = _inputs((2, 8, 3, 3))
    args = (w, b, None, rm, rv, MOMENTUM, EPS, False)
    with pytest.raises(TypeError, match="bf16 or f32"):
        bn._forward_cuda(x.half(), *args)
    with pytest.raises(ValueError, match="NCHW"):
        bn._forward_cuda(x[0], *args)
    with pytest.raises(ValueError, match="weight"):
        bn._forward_cuda(x, w.double(), *args[1:])
    with pytest.raises(ValueError, match="residual"):
        bn._forward_cuda(x, w, b, r.bfloat16(), rm, rv, MOMENTUM, EPS, True)
    with pytest.raises(ValueError, match="16-byte"):
        bn._forward_cuda(x[:, :6].bfloat16(), w[:6], b[:6], None, rm[:6],
                         rv[:6], MOMENTUM, EPS, False)


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "long long": ctypes.c_longlong, "int": ctypes.c_int,
            "float": ctypes.c_float,
            "long long*": ctypes.POINTER(ctypes.c_longlong),
            "int*": ctypes.POINTER(ctypes.c_int)}


@pytest.mark.parametrize("entry", sorted(bn._SIGNATURES))
def test_signature_row_matches_the_source(entry):
    """Each C entry's parameter types, in order, as ``_kernel_lib``
    declares them: a mismatch would make ``ctypes`` cut or shift the
    arguments on the card."""
    text = (Path(bn.__file__).resolve().parents[1] / "csrc"
            / "batch_norm.cu").read_text()
    text = text[text.index('extern "C" {'):]
    m = re.search(rf"^int\s+{entry}\(([^)]*)\)", text, re.M)
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    types = [_C_TYPES[p.rsplit(" ", 1)[0].replace(" *", "*")]
             for p in params]
    assert types == bn._SIGNATURES[entry]


# -- on the card -----------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


# Kernel against its plain arithmetic: one rounding of the storage dtype
# where the two f32 values straddle a rounding boundary (their statistics
# differ in the last f32 bits: Welford and Chan against two-pass sums).
Y_TOL = {torch.bfloat16: (1e-3, 2 ** -7), torch.float32: (1e-4, 1e-4)}

# ResNet-50's batch norms at batch 256 (N, C, H, W), each with what the
# model fuses there: the stem; stage 1's first norms, its last and the
# downsample; then stages 2-4, whose first norm runs at the stage's input
# size.
B256 = [((256, 64, 112, 112), (True, False)),
        ((256, 64, 56, 56), (True, False)),
        ((256, 256, 56, 56), (True, True)),
        ((256, 256, 56, 56), (False, False)),
        ((256, 128, 56, 56), (True, False)),
        ((256, 128, 28, 28), (True, False)),
        ((256, 512, 28, 28), (True, True)),
        ((256, 256, 28, 28), (True, False)),
        ((256, 1024, 14, 14), (True, True)),
        ((256, 512, 14, 14), (True, False)),
        ((256, 512, 7, 7), (True, False)),
        ((256, 2048, 7, 7), (True, True))]
# Rows that are no multiple of a block's, channels at 64 and 2,048, and
# channel tiles narrower than a warp (8 and 24 channels).
RAGGED = [((3, 64, 7, 5), (True, True)), ((5, 2048, 3, 3), (True, True)),
          ((7, 64, 33, 31), (False, True)), ((2, 2048, 1, 1), (True, False)),
          ((3, 24, 5, 7), (True, True)), ((2, 8, 9, 9), (False, False))]


def _close(got, want, atol, rtol, what):
    diff = (got.float() - want.float()).abs()
    excess = float((diff - rtol * want.float().abs()).max())
    assert excess <= atol, f"{what}: exceeds its bound by {excess}"


def _check_kernels(shape, relu, has_residual, dtype, seed):
    x, r, w, b, rm, rv, dy = _inputs(shape, dtype, "cuda", seed)
    w, b, rm, rv = (t.cuda() for t in (w, b, rm, rv))
    residual = r if has_residual else None
    before = (bn.stats_launches, bn.apply_launches, bn.bwd_reduce_launches,
              bn.bwd_elemt_launches)
    got_rm, got_rv = rm.clone(), rv.clone()
    y, stats = bn._forward_cuda(x, w, b, residual, got_rm, got_rv, MOMENTUM,
                                EPS, relu)
    want_rm, want_rv = rm.clone(), rv.clone()
    y_ref, stats_ref = bn._forward_reference(x, w, b, residual, want_rm,
                                             want_rv, MOMENTUM, EPS, relu)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y.float()).all())
    torch.testing.assert_close(stats, stats_ref, rtol=2e-5, atol=1e-6)
    torch.testing.assert_close(got_rm, want_rm, rtol=2e-5, atol=1e-6)
    torch.testing.assert_close(got_rv, want_rv, rtol=2e-5, atol=1e-6)
    atol, rtol = Y_TOL[dtype]
    _close(y, y_ref, atol, rtol, "y")
    # The backward from the same saved tensors on both sides.
    got = bn._backward_cuda(dy, x, y_ref, w, stats_ref, relu, has_residual)
    want = bn._backward_reference(dy, x, y_ref, w, stats_ref, relu,
                                  has_residual)
    torch.cuda.synchronize()
    scale = float(want[0].float().abs().max())
    _close(got[0], want[0], atol * scale, rtol, "dx")
    for name, g_, w_ in (("dweight", got[1], want[1]),
                         ("dbias", got[2], want[2])):
        torch.testing.assert_close(
            g_, w_, rtol=1e-4, atol=1e-4 * float(w_.abs().max()) + 1e-4,
            msg=lambda m: f"{name}: {m}")
    if has_residual:
        assert torch.equal(got[3], want[3])
    else:
        assert got[3] is None
    after = (bn.stats_launches, bn.apply_launches, bn.bwd_reduce_launches,
             bn.bwd_elemt_launches)
    assert [a - b_ for a, b_ in zip(after, before)] == [1, 1, 1, 1]
    assert not bool(bn._workspaces[x.device.index][1].any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape,variant", B256 + RAGGED,
                         ids=[f"{'x'.join(map(str, s))}-{VARIANT_IDS[VARIANTS.index(v)]}"
                              for s, v in B256 + RAGGED])
def test_kernels_match_their_arithmetic_on_card(shape, variant, dtype):
    _need_card()
    _check_kernels(shape, *variant, dtype, seed=shape[1] + shape[2])


@pytest.mark.cuda
@pytest.mark.parametrize("relu,has_residual", VARIANTS, ids=VARIANT_IDS)
def test_fused_function_matches_the_composition_on_card(relu, has_residual):
    """The autograd function on bf16 tensors, from an NCHW-contiguous input
    (which the wrapper makes channels-last), against F.batch_norm → add →
    ReLU (ATen's kernels) in f32 on the same values: one bf16 rounding
    apart.  Where the two sums straddle 0 within their last f32 bits the
    ReLU's masks differ; those few elements are counted, not compared."""
    _need_card()
    x, r, w, b, rm, rv, dy = _inputs((16, 256, 14, 14), torch.bfloat16,
                                     "cuda", 11)
    x = x.contiguous()
    w, b, rm, rv = (t.cuda() for t in (w, b, rm, rv))
    y, grads, got_rm, got_rv = _run(_fused_plain, x, r, w, b, rm, rv, dy,
                                    relu, has_residual)
    y0, grads0, want_rm, want_rv = _run(
        _composition, x.float(), r.float(), w, b, rm, rv, dy.float(), relu,
        has_residual)
    _close(y, y0, 1e-3, 2 ** -7, "y")
    torch.testing.assert_close(got_rm, want_rm, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got_rv, want_rv, rtol=1e-5, atol=1e-6)
    same = (y > 0) == (y0 > 0)
    flips = int((~same).sum())
    assert flips <= 4
    # A flipped element moves Σg by |dy| and Σg·x̂ by |dy·x̂| (|x̂| < 8).
    moved = flips * 8 * float(dy.float().abs().max())
    for name, got, want in zip(("x", "weight", "bias", "residual"), grads,
                               grads0):
        if name == "residual" and not has_residual:
            assert got is None
            continue
        scale = float(want.abs().max())
        if got.shape == x.shape:
            got, want = got.float()[same], want[same]
            _close(got, want, 1e-3 * scale, 2 ** -7, f"d{name}")
        else:
            torch.testing.assert_close(got, want, rtol=1e-3,
                                       atol=1e-3 * scale + moved,
                                       msg=lambda m: f"d{name}: {m}")


@pytest.mark.cuda
def test_resnet50_train_step_runs_every_norm_through_the_kernels():
    """53 train-mode local batch norms a ResNet-50 forward (the stem, three
    a block, four downsample paths), each one launch of every kernel."""
    _need_card()
    from horovod_tpu_torch.models.resnet import ResNet50

    model = ResNet50(dtype=torch.bfloat16, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    images = torch.randn((8, 224, 224, 3), generator=g, device="cuda")
    labels = torch.randint(0, 1000, (8,), generator=g, device="cuda")
    before = (bn.stats_launches, bn.apply_launches, bn.bwd_reduce_launches,
              bn.bwd_elemt_launches)
    loss = F.cross_entropy(model(images), labels)
    loss.backward()
    torch.cuda.synchronize()
    after = (bn.stats_launches, bn.apply_launches, bn.bwd_reduce_launches,
             bn.bwd_elemt_launches)
    assert [a - b for a, b in zip(after, before)] == [53] * 4
    assert bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(p.grad).all())
               for p in model.parameters())
