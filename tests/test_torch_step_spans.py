"""The training step's spans (``timeline.span``): what each phase opens in
``torch.profiler`` and on the timeline, on one clock, and nothing at all
when neither records."""

from __future__ import annotations

import collections
import json
import os
import time

import pytest
import torch

from horovod_tpu_torch import basics
from horovod_tpu_torch import timeline as ttimeline
from horovod_tpu_torch.ops import eager as E
from horovod_tpu_torch.ops import fusion
from horovod_tpu_torch.optim.distributed_optimizer import (
    DistributedOptimizer, make_train_step)

THRESHOLD = 4000        # bytes: the three gradients below take three buckets


@pytest.fixture
def initialized():
    basics.init("cpu")
    try:
        yield
    finally:
        basics.shutdown()


def _sync_step():
    torch.manual_seed(0)
    params = {"a": torch.randn(64, 32, requires_grad=True),
              "b": torch.randn(32, requires_grad=True),
              "c": torch.randn(1000, requires_grad=True)}
    opt = DistributedOptimizer(torch.optim.AdamW(list(params.values())),
                               fusion_threshold_bytes=THRESHOLD)

    def loss_fn(p, x):
        return (x @ p["a"] + p["b"]).square().mean() + p["c"].square().sum()

    step = make_train_step(loss_fn, opt, max_grad_norm=1.0)
    return params, step


def _frontend_step():
    import horovod_tpu_torch.torch_frontend as hvd

    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                                torch.nn.Linear(16, 4))
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters())

    def step():
        opt.zero_grad()
        model(torch.randn(5, 8)).square().mean().backward()
        opt.step()
    return model, opt, step


def _counts(prof) -> collections.Counter:
    return collections.Counter(e.name for e in prof.events()
                               if e.name.startswith("hvd."))


def test_span_off_constructs_no_record_function(initialized, monkeypatch):
    made = []

    def counting(real):
        def make(*a, **k):
            made.append(a)
            return real(*a, **k)
        return make

    monkeypatch.setattr(torch.profiler, "record_function",
                        counting(torch.profiler.record_function))
    monkeypatch.setattr(ttimeline, "_range", counting(ttimeline._range))
    assert basics._state.timeline is None
    assert not torch.autograd._profiler_enabled()
    assert ttimeline.span("hvd.x", k=1) is ttimeline.span("hvd.y")
    params, step = _sync_step()
    step(params, torch.randn(4, 64))
    model, opt, fstep = _frontend_step()
    fstep()
    opt.remove_hooks()
    assert made == []
    # The same calls under a profiler do construct them.
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        step(params, torch.randn(4, 64))
    assert {a[0] for a in made} >= {"hvd.forward", "hvd.update"}


def test_train_step_opens_each_phase_once(initialized):
    params, step = _sync_step()
    step(params, torch.randn(4, 64))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(params, torch.randn(4, 64))
    got = _counts(prof)
    buckets = fusion.plan_buckets([p.grad if p.grad is not None else p
                                   for p in params.values()], THRESHOLD)
    assert len(buckets) == 3
    assert got == {"hvd.forward": 1, "hvd.backward": 1, "hvd.reduce": 1,
                   "hvd.clip": 1, "hvd.update": 1,
                   "hvd.bucket": len(buckets)}


def test_frontend_step_opens_a_hook_per_parameter(initialized):
    model, opt, step = _frontend_step()
    step()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step()
    opt.remove_hooks()
    got = _counts(prof)
    n = len(list(model.parameters()))
    assert got["hvd.hook"] == n == 4
    assert got["hvd.reduce"] == 1 and got["hvd.update"] == 1
    assert "hvd.forward" not in got         # the loop is the caller's own


def _events(path) -> list[dict]:
    with open(path) as f:
        return json.load(f)


def test_timeline_and_torch_trace_share_one_clock(initialized, tmp_path):
    path, prof_dir = str(tmp_path / "tl.json"), str(tmp_path / "prof")
    params, step = _sync_step()
    step(params, torch.randn(4, 64))
    t_before = time.time_ns() / 1e3
    ttimeline.start_timeline(path, profiler_dir=prof_dir)
    step(params, torch.randn(4, 64))
    ttimeline.stop_timeline()
    t_after = time.time_ns() / 1e3
    events = _events(path)
    pids = {e["args"]["name"]: e["pid"] for e in events
            if e["name"] == "process_name"}
    track = [e for e in events if e.get("pid") == pids[ttimeline.STEP_TRACK]
             and e["ph"] in "BE"]
    assert [e["name"] for e in track if e["ph"] == "B"] == [
        "hvd.forward", "hvd.backward", "hvd.reduce", "hvd.bucket",
        "hvd.bucket", "hvd.bucket", "hvd.clip", "hvd.update"]
    assert len(track) == 16
    buckets = [e["args"] for e in track
               if e["name"] == "hvd.bucket" and e["ph"] == "B"]
    assert sum(b["bytes"] for b in buckets) == 4 * (64 * 32 + 32 + 1000)
    assert sum(b["tensors"] for b in buckets) == 3
    # Epoch microseconds, as torch.profiler stamps.
    assert all(t_before <= e["ts"] <= t_after for e in track)
    with open(os.path.join(prof_dir, "trace_rank0.json")) as f:
        trace = json.load(f)
    base_us = trace["baseTimeNanoseconds"] / 1e3
    ours = next(e["ts"] for e in track
                if e["name"] == "hvd.update" and e["ph"] == "B")
    torch_ts = [e["ts"] + base_us for e in trace["traceEvents"]
                if e.get("name") == "hvd.update" and e.get("ph") == "X"]
    assert len(torch_ts) == 1
    assert abs(torch_ts[0] - ours) < 1e3


def test_cycle_thread_dispatch_reaches_the_torch_trace(initialized,
                                                        tmp_path):
    path, prof_dir = str(tmp_path / "tl.json"), str(tmp_path / "prof")
    ttimeline.start_timeline(path, profiler_dir=prof_dir)
    h = E.allreduce_async(torch.ones(16), name="spans.cycle", average=True)
    deadline = time.monotonic() + 10
    eng = basics._state.engine
    while eng.stats["batches_dispatched"] == 0:     # the cycle thread's flush
        assert time.monotonic() < deadline
        time.sleep(0.01)
    E.synchronize(h)
    with ttimeline.span("hvd.caller"):
        torch.ones(2) + 1
    ttimeline.stop_timeline()
    with open(os.path.join(prof_dir, "trace_rank0.json")) as f:
        trace = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    dispatch = [e for e in trace if e["name"] == "hvd.dispatch"]
    caller = [e for e in trace if e["name"] == "hvd.caller"]
    assert len(dispatch) == 1 and len(caller) == 1
    assert dispatch[0]["tid"] != caller[0]["tid"]
    # The engine's own timeline events stay the reference's.
    assert "hvd.dispatch" not in {e.get("name") for e in _events(path)}
