"""Port parity: horovod_tpu_torch.serving against the JAX reference.

Two oracles.  Across frameworks: the port's ``ContinuousBatcher`` returns
the same greedy tokens as the JAX ``ContinuousBatcher`` from the same
weights in float32.  Inside the port: every request served through the
slot pool equals solo port ``generate`` for it, mirroring
tests/test_serving.py.
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


@pytest.fixture(scope="module")
def world():
    jcfg = jl.llama_tiny(dtype=jnp.float32)
    tcfg = tl.llama_tiny(dtype=torch.float32)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(11))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def _solo(params, cfg, prompt, n_new, max_len):
    return tl.generate(params, torch.tensor([prompt]), cfg,
                       max_new_tokens=n_new, max_len=max_len)[0].tolist()


def _requests(mod, prefix=None):
    return [
        mod.Request(prompt=[5, 17, 42], max_new_tokens=4, prefix=prefix),
        mod.Request(prompt=[7], max_new_tokens=6, prefix=prefix),
        mod.Request(prompt=[9, 1, 2, 3, 4, 5], max_new_tokens=3, prefix=prefix),
        mod.Request(prompt=[100, 101], max_new_tokens=5, prefix=prefix),
    ]


@pytest.mark.parametrize("prefix", [None, "oneshot", "windowed"])
def test_batcher_tokens_equal_jax_batcher(world, prefix):
    """More requests than slots, mixed lengths, chunked admission; with no
    prefix, a one-shot ``precompute_prefix`` (through ``prefill``) and a
    windowed one (through ``prefill_chunked``)."""
    jcfg, jp, tcfg, tp = world
    system = [42, 7, 99, 3, 18]
    window = 4 if prefix == "windowed" else None
    jpre = tpre = None
    if prefix is not None:
        jpre = js.precompute_prefix(jp, jcfg, system, window=window)
        tpre = ts.precompute_prefix(tp, tcfg, system, window=window)
        np.testing.assert_allclose(tpre.k.numpy(), np.asarray(jpre.k),
                                   atol=1e-5)
        assert tpre.length == jpre.length == len(system)
    want = js.ContinuousBatcher(jp, jcfg, n_slots=2, max_len=24,
                                admit_width=4).run(_requests(js, jpre))
    got = ts.ContinuousBatcher(tp, tcfg, n_slots=2, max_len=24,
                               admit_width=4).run(_requests(ts, tpre))
    assert [list(map(int, w)) for w in want] == got


def test_serving_matches_solo_generate(world):
    _, _, cfg, params = world
    reqs = _requests(ts) + [ts.Request(prompt=[200, 3, 1], max_new_tokens=2)]
    b = ts.ContinuousBatcher(params, cfg, n_slots=2, max_len=16,
                             admit_width=8)
    results = b.run(reqs)
    assert len(results) == len(reqs)
    for req, got in zip(reqs, results):
        assert got == _solo(params, cfg, req.prompt, req.max_new_tokens, 16)


def test_serving_eos_stops_early(world):
    _, _, cfg, params = world
    prompt = [5, 17, 42]
    solo = _solo(params, cfg, prompt, 8, 16)
    eos = solo[2]
    b = ts.ContinuousBatcher(params, cfg, n_slots=1, max_len=16,
                             admit_width=8)
    out = b.run([ts.Request(prompt=prompt, max_new_tokens=8, eos_id=eos)])[0]
    assert out == solo[:solo.index(eos) + 1]
    assert b.free_slots() == [0]


def test_serving_admission_validation(world):
    _, _, cfg, params = world
    b = ts.ContinuousBatcher(params, cfg, n_slots=1, max_len=16,
                             admit_width=4)
    with pytest.raises(ValueError, match="max_new_tokens"):
        b.admit(ts.Request(prompt=[1], max_new_tokens=0))
    with pytest.raises(ValueError, match="empty"):
        b.admit(ts.Request(prompt=[], max_new_tokens=2))
    with pytest.raises(ValueError, match="max_len"):
        b.admit(ts.Request(prompt=[1, 2, 3], max_new_tokens=14))
    with pytest.raises(ValueError, match="max_len"):
        b.admit(ts.Request(prompt=list(range(1, 16)), max_new_tokens=2))
    b6 = ts.ContinuousBatcher(params, cfg, n_slots=1, max_len=16,
                              admit_width=6)
    with pytest.raises(ValueError, match="windows"):
        b6.admit(ts.Request(prompt=list(range(1, 14)), max_new_tokens=2))
    with pytest.raises(ValueError, match="temperature > 0"):
        b.admit(ts.Request(prompt=[1], max_new_tokens=2, temperature=0.5))
    with pytest.raises(ValueError, match="admit_width"):
        ts.ContinuousBatcher(params, cfg, n_slots=1, max_len=4, admit_width=8)
    b.admit(ts.Request(prompt=[1, 2], max_new_tokens=3))
    with pytest.raises(RuntimeError, match="free slot"):
        b.admit(ts.Request(prompt=[3], max_new_tokens=2))


def test_serving_long_prompt_chunked_admission(world):
    _, _, cfg, params = world
    b = ts.ContinuousBatcher(params, cfg, n_slots=1, max_len=16,
                             admit_width=4)
    prompt = [9, 1, 2, 3, 4, 5, 6, 7, 8, 2]         # 10 > admit_width 4
    got = b.run([ts.Request(prompt=prompt, max_new_tokens=4)])[0]
    assert got == _solo(params, cfg, prompt, 4, 16)


def test_serving_slot_reuse_no_leakage(world):
    """A short request in a slot a longer one used must not see the old
    occupant's cache tail; idle ticks of a free slot stay in bounds."""
    _, _, cfg, params = world
    b = ts.ContinuousBatcher(params, cfg, n_slots=2, max_len=16,
                             admit_width=8)
    first = b.run([ts.Request(prompt=[9, 1, 2, 3, 4, 5, 6, 7],
                              max_new_tokens=6)])[0]
    assert len(first) == 6
    for _ in range(20):          # more idle ticks than max_len
        b.step()
    assert int(b.cache.length.max()) <= 1
    short = ts.Request(prompt=[5, 17], max_new_tokens=5)
    assert b.run([short])[0] == _solo(params, cfg, short.prompt, 5, 16)


def test_serving_prefix_cache_matches_solo(world):
    _, _, cfg, params = world
    system = [42, 7, 99, 3, 18]
    pre = ts.precompute_prefix(params, cfg, system, window=4)
    b = ts.ContinuousBatcher(params, cfg, n_slots=2, max_len=24,
                             admit_width=4)
    suffixes = [[5, 17], [9, 1, 4, 2, 8], [3]]
    results = b.run([ts.Request(prompt=s, max_new_tokens=4, prefix=pre)
                     for s in suffixes])
    for s, got in zip(suffixes, results):
        assert got == _solo(params, cfg, system + s, 4, 24)
    with pytest.raises(ValueError, match="prefix"):
        b.admit(ts.Request(prompt=list(range(1, 15)), max_new_tokens=6,
                           prefix=pre))
    with pytest.raises(ValueError, match="empty prefix"):
        ts.precompute_prefix(params, cfg, [])


def test_serving_sampled_matches_solo_generate(world):
    """A sampling pool (per-request seeds, one greedy override) draws
    exactly what solo generate draws from the same seed."""
    _, _, cfg, params = world
    temp, tk, tp_ = 0.8, 50, 0.95
    b = ts.ContinuousBatcher(params, cfg, n_slots=2, max_len=16,
                             admit_width=4, temperature=temp, top_k=tk,
                             top_p=tp_)
    reqs = [ts.Request(prompt=[5, 17, 42], max_new_tokens=4, sample_key=7),
            ts.Request(prompt=[9, 1], max_new_tokens=6, sample_key=8),
            ts.Request(prompt=[3, 3, 3], max_new_tokens=3, temperature=0.0)]
    results = b.run(reqs)
    for req, got in zip(reqs, results):
        t = temp if req.temperature is None else req.temperature
        solo = tl.generate(params, torch.tensor([req.prompt]), cfg,
                           max_new_tokens=req.max_new_tokens, max_len=16,
                           temperature=t, top_k=tk, top_p=tp_,
                           key=req.sample_key)[0].tolist()
        assert got == solo
    with pytest.raises(ValueError, match="sample_key"):
        b.admit(ts.Request(prompt=[1], max_new_tokens=2))
    assert b.free_slots() == [0, 1]


def test_request_result_and_lifecycle_fields():
    r = ts.RequestResult([1, 2], status=ts.TIMEOUT)
    assert r == [1, 2] and r.tokens == [1, 2] and not r.ok
    assert ts.RequestResult([3]).ok
    req = ts.Request(prompt=[1], max_new_tokens=1, deadline_s=1.0, priority=2)
    assert (req.deadline_s, req.priority, req.trace_ctx) == (1.0, 2, None)
