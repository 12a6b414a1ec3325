"""The port's ``llama_generate`` twin against the JAX package's generation.

``horovod_tpu_torch/examples/llama_generate.py`` is the twin of
``examples/llama_generate.py``: the JAX script's prompt
(``default_rng(0)`` integers), one prefill, then cached decode through
``llama.generate``.  The oracle is ``horovod_tpu.models.llama.generate``
on ``llama_tiny`` weights from ``jax.random.key(0)``, carried into the port
with ``params_from_jax``, in f32: greedy tokens equal exactly.  Sampled
tokens come from a ``torch.Generator`` (the JAX draws are not the port's),
so they are held to their properties: each lies in its step's top-k and
top-p set of the logits it was drawn from.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import llama as jl
from horovod_tpu_torch import basics
from horovod_tpu_torch.checkpoint import save_checkpoint
from horovod_tpu_torch.examples import llama_generate
from horovod_tpu_torch.models import llama as tl
from horovod_tpu_torch.models.convert import params_from_jax


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny models on one torch thread: the test run's six workers share
    the host's cores, and eight threads a worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jcfg = jl.llama_tiny(dtype=jnp.float32)
    jp = jl.init_params(jcfg, jax.random.key(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    return jcfg, jp, tl.llama_tiny(dtype=torch.float32), tp


def test_greedy_tokens_equal_the_jax_generate_in_f32(weights, capsys):
    jcfg, jp, cfg, tp = weights
    out = llama_generate.run(tp, cfg)          # the script's defaults
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8))
    assert np.array_equal(out["prompt"].numpy(), prompt)
    want = jax.jit(jl.generate, static_argnums=(2,),
                   static_argnames=("max_new_tokens",))(
        jp, jnp.asarray(prompt, jnp.int32), jcfg, max_new_tokens=32)
    assert out["tokens"].shape == (2, 32)
    assert np.array_equal(out["tokens"].numpy(), np.asarray(want))
    assert out["tokens_per_s"] > 0
    text = capsys.readouterr().out
    assert "decode:" in text and "tok/s" in text
    assert f"tokens[0]: {np.asarray(want)[0].tolist()}" in text


def test_sampled_tokens_lie_in_each_steps_top_k_and_top_p(weights,
                                                          monkeypatch):
    """The CLI's sampled run (``--temperature 0.8 --top-k 40 --top-p
    0.9``), each draw checked against the logits it was drawn from."""
    _, _, cfg, tp = weights
    seen = []
    real = tl.sample_logits

    def record(logits, generator, **kw):
        tok = real(logits, generator, **kw)
        seen.append((logits.clone(), tok.clone(), kw))
        return tok

    monkeypatch.setattr(tl, "sample_logits", record)
    out = llama_generate.run(tp, cfg, max_new_tokens=6, temperature=0.8,
                             top_k=40, top_p=0.9, verbose=False)
    toks = out["tokens"]
    assert toks.shape == (2, 6)
    timed = seen[len(seen) // 2:]               # the second (timed) call
    assert len(timed) == 6
    for step, (logits, tok, kw) in enumerate(timed):
        assert kw == {"temperature": 0.8, "top_k": 40, "top_p": 0.9}
        assert torch.equal(tok, toks[:, step])
        top = torch.topk(logits, 40, dim=-1).indices
        assert bool((top == tok[:, None]).any(-1).all())
        kept = tl.filtered_logits(logits, 0.8, top_k=40, top_p=0.9)
        assert bool((kept.gather(1, tok[:, None]) > tl.NEG_INF_LOGIT).all())


def test_cli_restores_a_checkpoint(weights, tmp_path):
    """``--ckpt``: the weights restored through the port's checkpoint
    module, greedy tokens equal to a run on the saved weights."""
    _, _, _, tp = weights
    cfg = tl.llama_tiny()                       # the CLI's --tiny config
    params = tl.init_params(cfg, 5, device="cpu")
    path = str(tmp_path / "llama.pt")
    basics.init("cpu")
    save_checkpoint(path, params)
    basics.shutdown()
    try:
        toks = llama_generate.main(["--tiny", "--ckpt", path, "--device",
                                    "cpu", "--max-new-tokens", "8"])
    finally:
        basics.shutdown()
    want = llama_generate.run(params, cfg, max_new_tokens=8, verbose=False)
    assert torch.equal(toks, want["tokens"])
    fresh = llama_generate.run(tl.init_params(cfg, 0, device="cpu"), cfg,
                               max_new_tokens=8, verbose=False)
    assert not torch.equal(toks, fresh["tokens"])
