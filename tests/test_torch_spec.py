"""Port parity: speculative decoding with a draft model.

Mirrors tests/test_serving.py's speculative cases:
``speculative_generate`` gives JAX's tokens, acceptance and cache depths
and the port's own greedy ``generate`` for a good draft (the target), a
random one and a smaller one; over ragged prompts; accepting the full
draft width; and with finished rows clamped.  The self-drafting engine
is tests/test_torch_spec_engine.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu import serving as js
from horovod_tpu.models import llama as jl
from horovod_tpu_torch import serving as ts
from horovod_tpu_torch.models import llama as tl
from horovod_tpu_torch.models.convert import params_from_jax
from torch_engine_twin import tiny_world

pytestmark = pytest.mark.spec


@pytest.fixture(scope="module")
def world():
    return tiny_world()


def _port(jp):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")


@pytest.fixture(scope="module")
def drafts(world):
    small_j = jl.llama_tiny(dtype=jnp.float32, dim=32, n_layers=1,
                            n_heads=2, n_kv_heads=1, ffn_dim=64)
    small_t = tl.llama_tiny(dtype=torch.float32, dim=32, n_layers=1,
                            n_heads=2, n_kv_heads=1, ffn_dim=64)
    rand = jl.init_params(world.jcfg, jax.random.PRNGKey(99))
    small = jl.init_params(small_j, jax.random.PRNGKey(5))
    return {"self": (world.jcfg, world.jp, world.tcfg, world.tp),
            "random": (world.jcfg, rand, world.tcfg, _port(rand)),
            "smaller": (small_j, small, small_t, _port(small))}


def _both(world, draft, prompt, **kw):
    jdcfg, jdp, tdcfg, tdp = draft
    jstats, tstats = {}, {}
    want = np.asarray(js.speculative_generate(
        world.jp, world.jcfg, jdp, jdcfg, jnp.asarray(prompt, jnp.int32),
        stats=jstats, **{k: jnp.asarray(v, jnp.int32)
                         if k == "prompt_lengths" else v
                         for k, v in kw.items()}))
    got = ts.speculative_generate(
        world.tp, world.tcfg, tdp, tdcfg, torch.tensor(prompt),
        stats=tstats, **{k: torch.tensor(v) if k == "prompt_lengths" else v
                         for k, v in kw.items()})
    assert got.tolist() == want.tolist()
    assert tstats["rounds"] == jstats["rounds"]
    assert tstats["max_length_seen"] == jstats["max_length_seen"]
    assert [a.tolist() for a in tstats["accepted_per_round"]] == [
        np.asarray(a).tolist() for a in jstats["accepted_per_round"]]
    return got, tstats


@pytest.mark.parametrize("name", ["self", "random", "smaller"])
def test_speculative_equals_jax_and_greedy(world, drafts, name):
    prompt = [[5, 17, 42], [7, 9, 3]]
    got, _ = _both(world, drafts[name], prompt, max_new_tokens=6,
                   draft_k=3)
    want = tl.generate(world.tp, torch.tensor(prompt), world.tcfg,
                       max_new_tokens=6, max_len=24)
    assert torch.equal(got, want)


def test_speculative_ragged_full_width_and_clamped(world, drafts):
    """Ragged prompts; the target as its own draft accepts every
    proposal every round; a bad draft over ragged rows keeps finished
    rows clamped inside the cache."""
    prompt = [[5, 17, 42, 9], [7, 7, 0, 0]]
    got, _ = _both(world, drafts["self"], prompt, max_new_tokens=5,
                   draft_k=3, prompt_lengths=[4, 2])
    want = tl.generate(world.tp, torch.tensor(prompt), world.tcfg,
                       max_new_tokens=5, max_len=24,
                       prompt_lengths=torch.tensor([4, 2]))
    assert torch.equal(got, want)
    _, stats = _both(world, drafts["self"], [[5, 17, 42], [7, 9, 3]],
                     max_new_tokens=9, draft_k=3)
    assert all(a.tolist() == [3, 3] for a in stats["accepted_per_round"])
    assert stats["rounds"] == -(-9 // 4)
    prompt = [[5, 17, 42, 9, 1, 6], [7, 7, 0, 0, 0, 0]]
    _, stats = _both(world, drafts["random"], prompt, max_new_tokens=10,
                     draft_k=3, max_len=20, prompt_lengths=[6, 2])
    assert stats["max_length_seen"] <= 6 + 10 - 1
    assert stats["max_length_seen"] + 3 < 20
    with pytest.raises(ValueError, match="overshoot"):
        ts.speculative_generate(world.tp, world.tcfg, world.tp, world.tcfg,
                                torch.tensor(prompt), max_new_tokens=10,
                                draft_k=3, max_len=19)
