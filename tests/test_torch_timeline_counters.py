"""The port's ``Timeline`` serves the port's serving engine.

The same ``start`` / ``end`` / ``instant`` / ``counter`` / ``async_*``
calls into the JAX package's ``Timeline`` and the port's write the same
events, timestamps aside.  The port's ``ServeEngine`` (profiling on, so
each tick's ``phase/*`` spans are back-dated ``async_span`` pairs) and
``speculative_generate`` write through a real port ``Timeline`` whose file
parses back, and the engine's file equals the JAX engine's on the same
requests.  ``start_timeline(profiler_dir=...)`` records a
``torch.profiler`` trace for the timeline's window.
"""

from __future__ import annotations

import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu import serving as js
from horovod_tpu import timeline as jtimeline
from horovod_tpu_torch import basics
from horovod_tpu_torch import metrics as tmetrics
from horovod_tpu_torch import serving as ts
from horovod_tpu_torch import timeline as ttimeline
from horovod_tpu_torch.serving import Request
from horovod_tpu_torch.serving_scheduler import ServeEngine
from torch_engine_twin import Twin, parse_timeline, tiny_world


@pytest.fixture(scope="module")
def world():
    return tiny_world()


def _calls(tl) -> None:
    t0 = time.perf_counter()
    tl.start("grad.a", "ALLREDUCE", args={"fused_with": 2})
    tl.instant("grad.a", "NEGOTIATE_TICK_ALL")
    tl.end("grad.a", "ALLREDUCE")
    tl.counter("serving.scheduler", "SCHED",
               {"queued": 3, "decoding": 2, "free_blocks": 11})
    tl.async_start("serving.requests", "REQ", 7)
    tl.async_span("serving.profiler", "phase/admit", 4, t0,
                  t0 + 1e-3)
    tl.counter("serving.speculative", "ACCEPT", {"accepted": 5, "rows": 2})
    tl.async_end("serving.requests", "REQ", 7)
    tl.close()
    tl.counter("serving.scheduler", "SCHED", {"queued": 0})   # after close


def test_same_calls_same_events(tmp_path):
    jpath, tpath = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    _calls(jtimeline.Timeline(jpath))
    _calls(ttimeline.Timeline(tpath))
    want, got = parse_timeline(jpath), parse_timeline(tpath)
    assert got == want
    assert {e["ph"] for e in got} == {"M", "B", "E", "i", "C", "b", "e"}
    # async_span back-dates its pair to the caller's own clock reads
    with open(tpath) as f:
        span = [e for e in json.load(f) if e["name"] == "phase/admit"]
    assert [e["ph"] for e in span] == ["b", "e"]
    assert span[1]["ts"] - span[0]["ts"] == pytest.approx(1e3, rel=1e-6)


def _events(path) -> list[dict]:
    with open(path) as f:
        return json.load(f)


def _named(events) -> dict[int, str]:
    return {e["pid"]: e["args"]["name"] for e in events
            if e["name"] == "process_name"}


def test_port_engine_profiled_through_a_real_timeline(world, tmp_path):
    """llama_tiny in f32, 2 slots, max_len 64, chunk 8, profiling on, the
    prefix cache and self-drafting on: the file holds the SCHED /
    LIFECYCLE / SPEC / PREFIX counters every step and each tick's
    ``phase/*`` spans, paired by id."""
    path = str(tmp_path / "engine.json")
    tl = ttimeline.Timeline(path)
    eng = ServeEngine(world.tp, world.tcfg, n_slots=2, max_len=64, chunk=8,
                      metrics=tmetrics.MetricsRegistry(event_log=None),
                      profile=True, timeline=tl, prefix_cache=True,
                      spec=True, draft_k=3)
    rng = np.random.default_rng(0)
    sys_prompt = [int(t) for t in rng.integers(1, 250, 16)]
    out = eng.run([Request(prompt=sys_prompt + [i, i + 1],
                           max_new_tokens=6) for i in range(4)])
    assert all(r.status == "OK" for r in out)
    tl.close()
    events = _events(path)
    names = _named(events)
    counters = {}
    for e in events:
        if e["ph"] == "C":
            assert names[e["pid"]] == "serving.scheduler"
            counters.setdefault(e["name"], []).append(e["args"])
    assert set(counters) == {"SCHED", "LIFECYCLE", "SPEC", "PREFIX"}
    assert all(len(v) == eng.step_index for v in counters.values())
    assert counters["LIFECYCLE"][-1] == eng.counters
    assert counters["SPEC"][-1] == eng.spec_counters
    assert counters["PREFIX"][-1] == eng.prefix_counters
    spans = [e for e in events if e["ph"] in "be"
             and names[e["pid"]] == "serving.profiler"]
    phases = {e["name"] for e in spans}
    assert {"phase/expire", "phase/admit", "phase/decode_dispatch",
            "phase/device_sync", "phase/bookkeeping",
            "phase/admit.prefill_dispatch"} <= phases
    begins = sorted((e["name"], e["id"]) for e in spans if e["ph"] == "b")
    ends = sorted((e["name"], e["id"]) for e in spans if e["ph"] == "e")
    assert begins == ends and {i for _, i in begins} == set(
        range(eng.step_index))
    for e in spans:
        assert e["cat"] == e["name"]
    reqs = [e for e in events if e["name"] == "REQ"]
    assert sorted(e["id"] for e in reqs if e["ph"] == "b") == [0, 1, 2, 3]
    assert sorted(e["id"] for e in reqs if e["ph"] == "e") == [0, 1, 2, 3]


@pytest.mark.parametrize("options", [
    {"profile": True},
    {"profile": True, "spec": True, "draft_k": 3, "prefix_cache": True},
], ids=["plain", "spec_prefix"])
def test_engine_timeline_file_equals_jax(world, options):
    """The two engines, profiled, on the same requests: their timeline
    files hold the same events, timestamps aside."""
    tw = Twin(world, n_slots=2, max_len=64, chunk=8, timeline=True,
              **options)
    tw.run([dict(prompt=[3, 1, 4, 1, 5, 9, 2, 6, 5, 3][:n + 2],
                 max_new_tokens=5) for n in range(5)])
    tw.check(max_len=64)
    events = parse_timeline(tw.ttimeline._path)
    assert any(e["ph"] == "C" for e in events)
    assert any(e["name"].startswith("phase/") for e in events)


def test_speculative_generate_through_a_real_timeline(world, tmp_path):
    """One ACCEPT counter a round, equal to the JAX run's file."""
    prompt = [[5, 17, 42], [7, 9, 3]]
    tpath, jpath = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    tl, jtl = ttimeline.Timeline(tpath), jtimeline.Timeline(jpath)
    stats = {}
    ts.speculative_generate(world.tp, world.tcfg, world.tp, world.tcfg,
                            torch.tensor(prompt), max_new_tokens=6,
                            draft_k=3, stats=stats, timeline=tl)
    js.speculative_generate(world.jp, world.jcfg, world.jp, world.jcfg,
                            jnp.asarray(prompt, jnp.int32),
                            max_new_tokens=6, draft_k=3, timeline=jtl)
    tl.close()
    jtl.close()
    assert parse_timeline(tpath) == parse_timeline(jpath)
    accept = [e["args"] for e in _events(tpath) if e["name"] == "ACCEPT"]
    assert len(accept) == stats["rounds"] > 0
    assert [a["accepted"] for a in accept] == [
        int(np.sum(a)) for a in stats["accepted_per_round"]]


@pytest.fixture
def initialized():
    basics.init("cpu")
    try:
        yield
    finally:
        basics.shutdown()


def test_start_timeline_profiler_dir_writes_a_torch_trace(tmp_path,
                                                          initialized):
    from horovod_tpu_torch.ops import eager as E

    path, prof_dir = str(tmp_path / "tl.json"), str(tmp_path / "prof")
    ttimeline.start_timeline(path, profiler_dir=prof_dir)
    h = E.allreduce_async(torch.ones(16), name="tl.profiled", average=True)
    E.synchronize(h)
    torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    ttimeline.stop_timeline()
    assert basics._state.profiler is None
    assert os.listdir(prof_dir) == ["trace_rank0.json"]
    with open(os.path.join(prof_dir, "trace_rank0.json")) as f:
        trace = json.load(f)
    assert any(e.get("name") == "aten::mm"
               for e in trace["traceEvents"])
    assert "tl.profiled" in _named(_events(path)).values()


def test_profiler_failure_closes_the_timeline(tmp_path, initialized,
                                              monkeypatch):
    def refuse(device):
        raise RuntimeError("a profiler is already running")

    monkeypatch.setattr(ttimeline, "_start_profiler", refuse)
    path = str(tmp_path / "tl.json")
    with pytest.raises(RuntimeError, match="already running"):
        ttimeline.start_timeline(path, profiler_dir=str(tmp_path / "p"))
    assert basics._state.timeline is None
    assert _events(path)[-1]["name"] == "done"      # closed, strict JSON
    ttimeline.start_timeline(str(tmp_path / "again.json"))
    ttimeline.stop_timeline()
