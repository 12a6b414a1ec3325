"""The port's serving bench arms (``serving_scheduler.measure_*``).

``measure_throughput``, ``measure_prefix_throughput`` and
``measure_spec_throughput`` on ``llama_tiny`` in f32 with the JAX weights
carried over: each returns the reference's keys (the JAX functions run on
the same workload), the deterministic counts (tokens, prefix hits and
skipped tokens, verify rounds and acceptance) equal the JAX figures, and
the tokens equal the JAX engine's and its solo ``generate``'s.  Times are
recorded, never held to a limit.
"""

from __future__ import annotations

import numpy as np
import pytest

from horovod_tpu import serving as jserving
from horovod_tpu import serving_scheduler as jsched
from horovod_tpu_torch import serving_scheduler as tsched
from horovod_tpu_torch.serving import Request
from torch_engine_twin import solo, tiny_world


@pytest.fixture(scope="module")
def world():
    return tiny_world()


def _both(make):
    """The same workload as port and JAX ``Request`` lists."""
    return make(Request), make(jserving.Request)


def _staggered(R):
    """The reference's staggered workload, cut to two fixed batches: each
    batch pins one long budget, so static batching drains idle rows."""
    reqs = []
    for i in range(2):
        reqs += [R(prompt=list(range(1, 9 + i)), max_new_tokens=12),
                 R(prompt=[3, 5, 7], max_new_tokens=2),
                 R(prompt=[2, 4, 6, 8], max_new_tokens=2),
                 R(prompt=[9, 11, 13], max_new_tokens=2)]
    return reqs


def _shared_prefix(R):
    sys_prompt = [5, 17, 42, 9, 3, 8, 11, 2]
    return [R(prompt=sys_prompt + [7], max_new_tokens=5),
            R(prompt=sys_prompt + [30, 31], max_new_tokens=4),
            R(prompt=sys_prompt + [7], max_new_tokens=5),
            R(prompt=[100, 101], max_new_tokens=6),
            R(prompt=sys_prompt, max_new_tokens=3)]


def _repetitive(R):
    """Lookup-friendly prompts: the self-drafter finds their n-grams."""
    return [R(prompt=[4, 5, 6, 4, 5, 6, 4, 5], max_new_tokens=8),
            R(prompt=[9, 9, 9, 9, 9, 9], max_new_tokens=8),
            R(prompt=[1, 2, 3, 1, 2, 3], max_new_tokens=6)]


def test_measure_throughput_keys_and_tokens(world):
    reqs, jreqs = _both(_staggered)
    kw = dict(n_slots=4, max_len=32, chunk=8)
    got = tsched.measure_throughput(world.tp, world.tcfg, reqs,
                                    keep_tokens=True, **kw)
    want = jsched.measure_throughput(world.jp, world.jcfg, jreqs, **kw)
    extra = {"serve_tokens", "static_tokens", "static_batches"}
    assert set(got) - extra == set(want)
    assert set(got["serve_phase_pct"]) == set(want["serve_phase_pct"])
    for key in ("tokens", "n_requests", "n_slots", "max_len", "chunk",
                "preemptions", "serve_goodput", "device_peak_flops_known"):
        assert got[key] == want[key], key
    assert got["tokens"] == sum(r.max_new_tokens for r in reqs)
    assert got["static_batches"] == 2
    # honest MFU: no peak is known for the CPU, in both packages
    assert got["serve_mfu"] is None and want["serve_mfu"] is None
    assert got["serve_model_flops_per_token"] > 0
    for key in ("serve_tokens_per_sec", "static_tokens_per_sec",
                "serve_vs_static_ratio"):
        assert got[key] > 0, key
    for key in ("serve_metrics_overhead_pct", "monitor_overhead_pct",
                "serve_profiler_overhead_pct", "serve_health_overhead_pct",
                "serve_trace_overhead_pct",
                "device_telemetry_overhead_pct"):
        assert np.isfinite(got[key]), key
    # tokens: the engine's, the static baseline's, the JAX engine's and
    # solo generate's are one stream per request
    jeng = jsched.ServeEngine(world.jp, world.jcfg, sampler=False, **kw)
    jtokens = [[int(t) for t in r] for r in jeng.run(jreqs)]
    assert got["serve_tokens"] == jtokens
    assert got["static_tokens"] == jtokens
    assert got["serve_tokens"] == [solo(world, r.prompt, r.max_new_tokens,
                                        32) for r in reqs]


def test_measure_prefix_throughput_smoke_and_counts(world):
    reqs, jreqs = _both(_shared_prefix)
    kw = dict(n_slots=2, max_len=24, chunk=4)
    got = tsched.measure_prefix_throughput(world.tp, world.tcfg, reqs,
                                           **kw)
    want = jsched.measure_prefix_throughput(world.jp, world.jcfg, jreqs,
                                            **kw)
    assert set(got) == set(want)
    assert got["serve_prefix_hit_rate"] > 0
    assert got["serve_prefix_tokens_skipped"] > 0
    assert got["serve_prefix_tokens_per_sec"] > 0
    assert got["serve_prefix_off_tokens_per_sec"] > 0
    assert got["serve_prefix_speedup"] > 0
    assert got["n_requests"] == len(reqs)
    for key in ("serve_prefix_hit_rate", "serve_prefix_tokens_skipped",
                "tokens", "n_requests"):
        assert got[key] == want[key], key


def test_measure_spec_throughput_parity_and_counts(world):
    reqs, jreqs = _both(_repetitive)
    kw = dict(n_slots=2, max_len=32, chunk=8, draft_k=3)
    got = tsched.measure_spec_throughput(world.tp, world.tcfg, reqs, **kw)
    want = jsched.measure_spec_throughput(world.jp, world.jcfg, jreqs,
                                          **kw)
    assert set(got) == set(want)
    for key in ("serve_spec_accepted_per_round", "serve_spec_rounds",
                "draft_k", "tokens", "n_requests"):
        assert got[key] == want[key], key
    assert got["serve_spec_rounds"] > 0
    assert got["serve_spec_tokens_per_sec"] > 0
    assert got["serve_spec_vs_plain_ratio"] > 0
    # keep_tokens=True hands both token sets back instead of asserting them
    loose = tsched.measure_spec_throughput(world.tp, world.tcfg, reqs,
                                           keep_tokens=True, **kw)
    assert set(loose) - set(got) == {"serve_spec_tokens",
                                     "serve_spec_plain_tokens"}
    jeng = jsched.ServeEngine(world.jp, world.jcfg, sampler=False,
                              n_slots=2, max_len=32, chunk=8)
    want_tokens = [[int(t) for t in r] for r in jeng.run(jreqs)]
    assert loose["serve_spec_tokens"] == want_tokens
    assert loose["serve_spec_plain_tokens"] == want_tokens


def test_measure_functions_refuse_an_empty_workload(world):
    for fn in (tsched.measure_throughput, tsched.measure_prefix_throughput,
               tsched.measure_spec_throughput,
               tsched.measure_tp_throughput):
        with pytest.raises(ValueError, match="empty workload"):
            fn(world.tp, world.tcfg, [], n_slots=2, max_len=16, chunk=4)
