"""The kernels' C entries and routing, and their plain versions at the
Hopper kernels' tiles, on the CPU.

* Every launch entry of ``horovod_tpu_torch/csrc/*.cu`` (an ``extern "C"``
  function that takes the stream) has a ``_SIGNATURES`` row in its
  wrapper; the flash entries' rows have the same number of pointers, and
  the seven ints and one float ``_kernel_lib`` declares after them: a
  mismatch would make ``ctypes`` cut or shift the arguments on the card.
* ``_flash_forward_cuda`` sends bf16/fp16 to the Hopper kernels,
  ``hvd_flash_fwd`` at head dim 128 and ``hvd_flash_fwd_d64`` at 64, and
  f32 to ``hvd_flash_fwd_mma``; the backward wrappers send bf16/fp16 to
  ``hvd_flash_bwd_dq``/``hvd_flash_bwd_dkv`` at head dim 128 and to
  ``hvd_flash_bwd_dq_d64``/``hvd_flash_bwd_dkv_d64`` at 64, and f32 to
  their ``_mma`` entries; with ``_launch`` replaced.
* The plain forward blocked 128 × 128, as the D = 128 Hopper kernel tiles,
  and 64 × 64 at D = 64 in bf16 and fp16, as the D = 64 one does, against
  the JAX ``_flash_forward`` (the Pallas kernel in interpret mode) at the
  same blocks: ragged L, GQA with H=4, KVH=2.  The plain dQ and dK/dV
  blocked 64 × 64, as the Hopper backward kernels tile, against the JAX
  ``_flash_backward`` the same way, at the kernels' head widths D = 128
  and, in bf16 with GQA, D = 64.
"""

from __future__ import annotations

import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import batch_norm as tbn
from horovod_tpu_torch.parallel import flash_attention as tflash

jflash = importlib.import_module("horovod_tpu.parallel.flash_attention")

CSRC = Path(tflash.__file__).resolve().parents[1] / "csrc"


def _launch_entries() -> dict[tuple[str, str], list[str]]:
    """``{(library, entry): [parameter, ...]}`` of every ``extern "C"``
    function in ``csrc/*.cu`` whose last parameter is the stream."""
    out = {}
    for cu in sorted(CSRC.glob("*.cu")):
        text = cu.read_text()
        block = text[text.index('extern "C" {'):]
        for m in re.finditer(r"^int\s+(hvd_\w+)\(([^)]*)\)", block, re.M):
            params = [" ".join(p.split()) for p in m.group(2).split(",")]
            if params[-1] == "void* stream":
                out[(cu.stem, m.group(1))] = params
    return out


def test_every_launch_entry_has_a_signature_row():
    found = set(_launch_entries())
    declared = {(lib, fn) for lib, fns in tflash._SIGNATURES.items()
                for fn in fns}
    # The batch-norm library's launch entries, whose rows
    # tests/test_torch_batch_norm_act.py holds to the source.
    declared |= {("batch_norm", fn) for fn in tbn._SIGNATURES
                 if fn != "hvd_bn_workspace"}
    assert found == declared


@pytest.mark.parametrize("lib, entry", [
    ("flash_fwd", "hvd_flash_fwd"), ("flash_fwd", "hvd_flash_fwd_mma"),
    ("flash_fwd_d64", "hvd_flash_fwd_d64"),
    ("flash_bwd", "hvd_flash_bwd_dq"), ("flash_bwd", "hvd_flash_bwd_dkv"),
    ("flash_bwd", "hvd_flash_bwd_dq_mma"),
    ("flash_bwd", "hvd_flash_bwd_dkv_mma"),
    ("flash_bwd_d64", "hvd_flash_bwd_dq_d64"),
    ("flash_bwd_d64", "hvd_flash_bwd_dkv_d64")])
def test_signature_row_matches_the_source(lib, entry):
    params = _launch_entries()[(lib, entry)][:-1]       # the stream last
    pointers = [p for p in params if "*" in p]
    assert params[:len(pointers)] == pointers           # pointers first
    assert tflash._SIGNATURES[lib][entry] == len(pointers)
    scalars = [p.split()[0] for p in params[len(pointers):]]
    assert scalars == ["int"] * 7 + ["float"]


@pytest.mark.parametrize("dtype, entry", [
    (torch.bfloat16, "hvd_flash_fwd"), (torch.float16, "hvd_flash_fwd"),
    (torch.float32, "hvd_flash_fwd_mma")])
def test_forward_routes_by_dtype(monkeypatch, dtype, entry):
    """Through the wrapper every caller uses, 16-bit tensors reach the
    Hopper kernel and f32 the mma.sync kernel; one launch is counted."""
    calls = []
    monkeypatch.setattr(tflash, "_check_cuda_inputs", lambda *a: None)
    monkeypatch.setattr(
        tflash, "_launch",
        lambda name, fn, tensors, q, h, kvh, causal: calls.append(
            (name, fn, len(tensors), h, kvh, causal)))
    monkeypatch.setattr(tflash, "launches", 0)
    q = torch.zeros((2 * 4, 24, 128), dtype=dtype)
    k = v = torch.zeros((2 * 2, 24, 128), dtype=dtype)
    o, lse = tflash._flash_forward_cuda(q, k, v, n_heads=4, n_kv_heads=2,
                                        causal=True)
    assert calls == [("flash_fwd", entry, 5, 4, 2, True)]
    assert tflash._SIGNATURES["flash_fwd"][entry] == 5
    assert tflash.launches == 1
    assert o.shape == q.shape and o.dtype == dtype
    assert lse.shape == (8, 24, 1) and lse.dtype == torch.float32


@pytest.mark.parametrize("dtype, entries", [
    (torch.bfloat16, ("hvd_flash_bwd_dq", "hvd_flash_bwd_dkv")),
    (torch.float16, ("hvd_flash_bwd_dq", "hvd_flash_bwd_dkv")),
    (torch.float32, ("hvd_flash_bwd_dq_mma", "hvd_flash_bwd_dkv_mma"))])
def test_backward_routes_by_dtype(monkeypatch, dtype, entries):
    """Through the wrappers the backward calls, 16-bit tensors reach the
    Hopper dQ and dK/dV kernels and f32 the mma.sync kernels; each wrapper
    counts one launch and returns its outputs' contract (dQ like q; dK/dV
    per query head)."""
    calls = []
    monkeypatch.setattr(tflash, "_check_bwd_inputs", lambda *a: None)
    monkeypatch.setattr(
        tflash, "_launch",
        lambda name, fn, tensors, q, h, kvh, causal: calls.append(
            (name, fn, len(tensors), h, kvh, causal)))
    monkeypatch.setattr(tflash, "dq_launches", 0)
    monkeypatch.setattr(tflash, "dkv_launches", 0)
    q = do = torch.zeros((2 * 4, 24, 128), dtype=dtype)
    k = v = torch.zeros((2 * 2, 24, 128), dtype=dtype)
    lse = delta = torch.zeros((8, 24), dtype=torch.float32)
    kw = dict(n_heads=4, n_kv_heads=2, causal=False)
    dq = tflash._flash_bwd_dq_cuda(q, k, v, do, lse, delta, **kw)
    dk_h, dv_h = tflash._flash_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw)
    assert calls == [("flash_bwd", entries[0], 7, 4, 2, False),
                     ("flash_bwd", entries[1], 8, 4, 2, False)]
    assert [tflash._SIGNATURES["flash_bwd"][e] for e in entries] == [7, 8]
    assert (tflash.dq_launches, tflash.dkv_launches) == (1, 1)
    for t in (dq, dk_h, dv_h):
        assert t.shape == q.shape and t.dtype == dtype


# Tolerances as in test_torch_flash_attention.py: f32 differs only in the
# products' summation order; bf16 outputs by one bf16 unit at a tie of P's
# rounding; the LSE is f32 from the same f32 scores.
F32_ATOL, BF16_ATOL, LSE_ATOL = 1e-5, 2 ** -7, 1e-5


@pytest.mark.parametrize("l, causal, dtype", [
    (300, True, "float32"), (300, False, "float32"),
    (300, True, "bfloat16"), (129, False, "bfloat16")])
def test_plain_forward_at_kernel_tiles_matches_jax(l, causal, dtype):
    """128-row query and 128-key blocks, the tail block ragged (300 = 2·128
    + 44, 129 = 128 + 1): o and LSE equal JAX's at the same blocks."""
    b, h, kvh, d = 2, 4, 2, 16
    rng = np.random.RandomState(l)
    q = rng.randn(b * h, l, d).astype(np.float32)
    k = rng.randn(b * kvh, l, d).astype(np.float32)
    v = rng.randn(b * kvh, l, d).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jo, jlse = jflash._flash_forward(
        jnp.asarray(q).astype(jdt), jnp.asarray(k).astype(jdt),
        jnp.asarray(v).astype(jdt), n_heads=h, n_kv_heads=kvh, causal=causal,
        block_q=128, block_k=128, interpret=True)
    to, tlse = tflash._flash_forward_reference(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt), n_heads=h, n_kv_heads=kvh,
        causal=causal, block_q=128, block_k=128)
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo, np.float32), atol=atol)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse)[:, :l],
                               atol=LSE_ATOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_forward_at_head_dim_64_16_bit_gqa_matches_jax(causal, dtype):
    """The plain version of the Hopper D = 64 forward, in bf16 and fp16 at
    its 64 × 64 tiles: the ViT's L = 196 (a 4-row tail tile), GQA with H=4,
    KVH=2 (the kernel's index map), against JAX's ``_flash_forward`` in
    interpret mode at the same blocks, on the same seeded inputs."""
    b, h, kvh, l, d = 1, 4, 2, 196, 64
    rng = np.random.RandomState(l + causal)
    q = rng.randn(b * h, l, d).astype(np.float32)
    k = rng.randn(b * kvh, l, d).astype(np.float32)
    v = rng.randn(b * kvh, l, d).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jo, jlse = jflash._flash_forward(
        jnp.asarray(q).astype(jdt), jnp.asarray(k).astype(jdt),
        jnp.asarray(v).astype(jdt), n_heads=h, n_kv_heads=kvh, causal=causal,
        block_q=64, block_k=64, interpret=True)
    to, tlse = tflash._flash_forward_reference(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt), n_heads=h, n_kv_heads=kvh,
        causal=causal, block_q=64, block_k=64)
    assert to.dtype == tdt and to.shape == (b * h, l, d)
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo, np.float32), atol=BF16_ATOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse)[:, :l],
                               atol=LSE_ATOL)


# The plain backward against JAX's, relative to the largest |grad| of each
# tensor.  f32: the same block loops and the same f32 P and dS; only the
# products' summation order differs (measured below 4e-7).  bf16: P and dS
# are rounded to bf16 from f32 values that differ in summation order, so a
# tie may round the other way (one bf16 unit, 2**-8 relative, in one
# element of a sum over at most L terms), and dK/dV are summed over the GQA
# group in bf16 after that; measured below 7e-4.
BWD_F32_RTOL, BWD_BF16_RTOL = 1e-5, 2 ** -8


@pytest.mark.parametrize("b, l, causal, dtype", [
    (1, 100, True, "float32"), (1, 100, False, "float32"),
    (1, 130, True, "bfloat16"), (2, 65, False, "bfloat16")])
def test_plain_backward_at_kernel_tiles_matches_jax(b, l, causal, dtype):
    """64-row query and 64-key blocks, the tail block ragged (100 = 64 + 36,
    130 = 2·64 + 2, 65 = 64 + 1), D = 128, GQA with H=4, KVH=2: the plain
    dQ and the group-summed plain dK/dV equal JAX's ``_flash_backward`` at
    the same blocks, on the same q/k/v/dO and JAX's own O and LSE."""
    _plain_backward_matches_jax(b, l, causal, dtype, d=128)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_at_head_dim_64_bf16_gqa_matches_jax(causal):
    """The plain versions of the Hopper D = 64 backward kernels, in bf16 at
    their 64 × 64 tiles: the ViT's L = 196 (a 4-row tail tile), GQA with
    H=4, KVH=2 (the kernels' index map), against JAX's ``_flash_backward``
    in interpret mode at the same blocks."""
    _plain_backward_matches_jax(1, 196, causal, "bfloat16", d=64)


def _plain_backward_matches_jax(b, l, causal, dtype, d):
    h, kvh = 4, 2
    rng = np.random.RandomState(l + b)
    q = rng.randn(b * h, l, d).astype(np.float32)
    k = rng.randn(b * kvh, l, d).astype(np.float32)
    v = rng.randn(b * kvh, l, d).astype(np.float32)
    g = rng.randn(b * h, l, d).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jkw = dict(n_heads=h, n_kv_heads=kvh, causal=causal, block_q=64,
               block_k=64, interpret=True)
    jq, jk, jv, jg = (jnp.asarray(a).astype(jdt) for a in (q, k, v, g))
    jo, jlse = jflash._flash_forward(jq, jk, jv, **jkw)
    want = jflash._flash_backward(jq, jk, jv, jo, jlse, jg, **jkw)

    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(tdt)

    lse = torch.from_numpy(np.array(jlse, np.float32)[:, :l, 0].copy())
    delta = tflash._delta(t(jo), t(g))
    tkw = dict(n_heads=h, n_kv_heads=kvh, causal=causal, block_q=64,
               block_k=64)
    dq = tflash._flash_bwd_dq_reference(t(q), t(k), t(v), t(g), lse, delta,
                                        **tkw)
    dk_h, dv_h = tflash._flash_bwd_dkv_reference(t(q), t(k), t(v), t(g), lse,
                                                 delta, **tkw)
    got = (dq, tflash._group_sum(dk_h, h, kvh), tflash._group_sum(dv_h, h, kvh))
    rtol = BWD_F32_RTOL if dtype == "float32" else BWD_BF16_RTOL
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w, np.float32)
        assert a.dtype == tdt and tuple(a.shape) == w.shape, name
        np.testing.assert_allclose(a.float().numpy(), w,
                                   atol=rtol * float(np.abs(w).max()),
                                   err_msg=name)


@pytest.mark.parametrize("heads", [(12, 12, False), (4, 2, True)],
                         ids=["vit_b16", "gqa_causal"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_head_dim_64_routes_by_dtype(monkeypatch, dtype, heads):
    """At D = 64 (the ViT's head width) bf16/fp16 take the Hopper D = 64
    entries (the forward's of ``flash_fwd_d64``, the backward pair's of
    ``flash_bwd_d64``) and f32 the mma.sync entries of ``flash_fwd`` and
    ``flash_bwd``, with the ViT-B/16 heads and with GQA 4/2.  Each call
    passes the pointer count of its entry's signature row, each wrapper
    counts its launch, and the backward returns its outputs' contract (dQ
    like q; dK/dV per query head)."""
    h, kvh, causal = heads
    calls = []
    monkeypatch.setattr(tflash, "_check_cuda_inputs", lambda *a: None)
    monkeypatch.setattr(tflash, "_check_bwd_inputs", lambda *a: None)
    monkeypatch.setattr(
        tflash, "_launch",
        lambda name, fn, tensors, q, h_, kvh_, causal_: calls.append(
            (name, fn, len(tensors), h_, kvh_, causal_)))
    for name in ("launches", "dq_launches", "dkv_launches"):
        monkeypatch.setattr(tflash, name, 0)
    q = do = torch.zeros((2 * h, 196, 64), dtype=dtype)
    k = v = torch.zeros((2 * kvh, 196, 64), dtype=dtype)
    lse = delta = torch.zeros((2 * h, 196), dtype=torch.float32)
    kw = dict(n_heads=h, n_kv_heads=kvh, causal=causal)
    tflash._flash_forward_cuda(q, k, v, **kw)
    dq = tflash._flash_bwd_dq_cuda(q, k, v, do, lse, delta, **kw)
    dk_h, dv_h = tflash._flash_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw)
    if dtype == torch.float32:
        want = [("flash_fwd", "hvd_flash_fwd_mma"),
                ("flash_bwd", "hvd_flash_bwd_dq_mma"),
                ("flash_bwd", "hvd_flash_bwd_dkv_mma")]
    else:
        want = [("flash_fwd_d64", "hvd_flash_fwd_d64"),
                ("flash_bwd_d64", "hvd_flash_bwd_dq_d64"),
                ("flash_bwd_d64", "hvd_flash_bwd_dkv_d64")]
    assert [c[:2] for c in calls] == want
    for name, fn, n_ptr, *rest in calls:
        assert n_ptr == tflash._SIGNATURES[name][fn]
        assert rest == [h, kvh, causal]
    assert (tflash.launches, tflash.dq_launches, tflash.dkv_launches) == (
        1, 1, 1)
    for t in (dq, dk_h, dv_h):
        assert t.shape == q.shape and t.dtype == dtype


def test_routing_table_covers_dtype_and_head_dim():
    """The Hopper entries for 16-bit types at D = 128 and D = 64, each head
    width its own forward and backward pair; f32 takes the mma.sync
    entries at both."""
    hopper_fwd = {128: "hvd_flash_fwd", 64: "hvd_flash_fwd_d64"}
    hopper_bwd = {128: ("hvd_flash_bwd_dq", "hvd_flash_bwd_dkv"),
                  64: ("hvd_flash_bwd_dq_d64", "hvd_flash_bwd_dkv_d64")}
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        for d in (64, 128):
            assert tflash._FWD_ENTRY[dt, d] == (
                "hvd_flash_fwd_mma" if dt == torch.float32
                else hopper_fwd[d])
            assert tflash._BWD_ENTRY[dt, d] == (
                ("hvd_flash_bwd_dq_mma", "hvd_flash_bwd_dkv_mma")
                if dt == torch.float32 else hopper_bwd[d])
    assert set(tflash._FWD_ENTRY) == set(tflash._BWD_ENTRY)
    assert {d for _, d in tflash._FWD_ENTRY} == {64, 128}
    for entries in (*tflash._BWD_ENTRY.values(),
                    *((fn,) for fn in tflash._FWD_ENTRY.values())):
        for fn in entries:     # each entry is declared in its library
            assert fn in tflash._SIGNATURES[tflash._LIBRARY[fn]]
    assert tflash._LIBRARY["hvd_flash_fwd_d64"] == "flash_fwd_d64"


@pytest.mark.parametrize("d", [16, 96, 256])
def test_other_head_dims_raise_before_any_launch(monkeypatch, d):
    """D outside {64, 128} raises ValueError naming the supported set, in
    the forward and both backward wrappers, before the device is looked at
    and before anything is built or launched."""
    monkeypatch.setattr(tflash, "_launch", lambda *a: pytest.fail("launched"))
    q = torch.zeros((4, 8, d), dtype=torch.bfloat16)
    lse = torch.zeros((4, 8), dtype=torch.float32)
    kw = dict(n_heads=4, n_kv_heads=4, causal=True)
    for call in (lambda: tflash._flash_forward_cuda(q, q, q, **kw),
                 lambda: tflash._flash_bwd_dq_cuda(q, q, q, q, lse, lse, **kw),
                 lambda: tflash._flash_bwd_dkv_cuda(q, q, q, q, lse, lse,
                                                    **kw)):
        with pytest.raises(ValueError, match=rf"head dim {d}.*\(64, 128\)"):
            call()


@pytest.mark.parametrize("causal", [True, False])
def test_plain_forward_and_backward_at_head_dim_64_match_jax(causal):
    """At the D = 64 kernels' tiles (64 × 64), L = 196 as in ViT-B/16 (three
    full tiles and a ragged one of 4 rows), H = KVH: the plain forward and
    backward equal JAX's ``_flash_forward``/``_flash_backward`` in interpret
    mode at the same blocks, in f32 (summation order only)."""
    b, h, l, d = 1, 2, 196, 64
    rng = np.random.RandomState(64 + causal)
    q, k, v, g = (rng.randn(b * h, l, d).astype(np.float32) for _ in range(4))
    jkw = dict(n_heads=h, n_kv_heads=h, causal=causal, block_q=64,
               block_k=64, interpret=True)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    jo, jlse = jflash._flash_forward(jq, jk, jv, **jkw)
    want = jflash._flash_backward(jq, jk, jv, jo, jlse, jg, **jkw)
    tkw = dict(n_heads=h, n_kv_heads=h, causal=causal, block_q=64,
               block_k=64)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    to, tlse = tflash._flash_forward_reference(tq, tk, tv, **tkw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=F32_ATOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse)[:, :l],
                               atol=LSE_ATOL)
    got = tflash._flash_backward_reference(tq, tk, tv, to, tlse, tg, **tkw)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(a.numpy(), w, err_msg=name,
                                   atol=BWD_F32_RTOL * float(np.abs(w).max()))
