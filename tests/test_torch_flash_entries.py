"""The forward kernel's C entries and routing, and its plain version at the
Hopper kernel's tiles, on the CPU.

* Every launch entry of ``horovod_tpu_torch/csrc/*.cu`` (an ``extern "C"``
  function that takes the stream) has a ``_SIGNATURES`` row with the same
  number of pointers, and the seven ints and one float ``_kernel_lib``
  declares after them: a mismatch would make ``ctypes`` cut or shift the
  arguments on the card.
* ``_flash_forward_cuda`` sends bf16/fp16 to ``hvd_flash_fwd`` (the Hopper
  kernel) and f32 to ``hvd_flash_fwd_mma``, with ``_launch`` replaced.
* The plain forward blocked 128 × 128, as the Hopper kernel tiles, against
  the JAX ``_flash_forward`` (the Pallas kernel in interpret mode) at the
  same blocks: ragged L, GQA with H=4, KVH=2.
"""

from __future__ import annotations

import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    assert found == declared


@pytest.mark.parametrize("lib, entry", [
    ("flash_fwd", "hvd_flash_fwd"), ("flash_fwd", "hvd_flash_fwd_mma"),
    ("flash_bwd", "hvd_flash_bwd_dq"), ("flash_bwd", "hvd_flash_bwd_dkv")])
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
