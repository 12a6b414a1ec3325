"""The readers of the port's step spans, on synthetic summaries, and the
trace reduction's naming of an idle gap under a hook."""

from __future__ import annotations

import types

import pytest

from portbench import harness, trace
from portbench.tests.test_portbench_trace import _event, _run, _summary

MISTRAL, RESNET = "mistral7b-l8.train.4x4096", "resnet50.train.b256"
DEVICE_TIME = [("forward_ms.tokens", "hvd.forward", MISTRAL),
               ("reduce_ms.tokens", "hvd.reduce", MISTRAL),
               ("clip_ms.tokens", "hvd.clip", MISTRAL),
               ("optimizer_ms.tokens", "hvd.update", MISTRAL),
               ("reduce_ms.images", "hvd.reduce", RESNET),
               ("optimizer_ms.images", "hvd.update", RESNET)]


def _with(ranges=None, gaps=()):
    s = _summary([(0, 10, "k")], ranges=ranges)
    s["idle_gaps"] = [list(g) for g in gaps]
    return s


@pytest.mark.parametrize("name,span,cell", DEVICE_TIME,
                         ids=[m for m, _, _ in DEVICE_TIME])
def test_device_time_readers(name, span, cell):
    reader = harness.reader(name)
    assert reader.RANGES == (span,)
    assert span in harness.range_names(harness.Cell(cell))
    # Two traced steps, the outermost occurrences' µs summed: 5 ms a step.
    one = _run(cell, [_with({span: [6_000.0, 4_000.0]})], trace_steps=2)
    assert reader.read(one) == pytest.approx(5.0)
    # The mean over ranks; a rank whose range launched nothing counts 0.
    two = _run(cell, [_with({span: [6_000.0, 4_000.0]}),
                      _with({span: [0.0, 0.0]})], trace_steps=2)
    assert reader.read(two) == pytest.approx(2.5)
    # No occurrence on any rank (the parent program has no such span).
    for ranges in (None, {span: []}, {"portbench.update": [9_000.0]}):
        assert reader.read(_run(cell, [_with(ranges)] * 2)) is None
    assert reader.read(_run(cell, [])) is None


def test_hook_idle_reader():
    reader = harness.reader("hook_idle_ms.images")
    gaps = [("torch::autograd::AccumulateGrad", 0.010),
            ("hvd.hook", 0.060)]
    one = _run(RESNET, [_with(gaps=gaps)], trace_steps=30)
    assert reader.read(one) == pytest.approx(2.0)
    two = _run(RESNET, [_with(gaps=gaps), _with(gaps=gaps[:1])],
               trace_steps=30)
    assert reader.read(two) == pytest.approx(1.0)
    assert reader.read(_run(RESNET, [_with(gaps=gaps[:1])] * 2)) is None
    assert reader.read(_run(RESNET, [])) is None


def test_a_gap_under_a_hook_is_named_by_the_hook():
    """The hook runs inside autograd's ``AccumulateGrad`` node: a gap in
    it is the span's, the innermost host operation open there."""
    hook = _event("hvd.hook", 30, 70)
    acc = _event("torch::autograd::AccumulateGrad", 20, 80,
                 children=[hook])
    events = [_event("portbench.window", 0, 100), acc, hook,
              _event("conv", 0, 20, device="CUDA"),
              _event("conv", 80, 100, device="CUDA")]
    s = trace.summarize(types.SimpleNamespace(events=lambda: events),
                        ["hvd.hook"])
    assert s["idle_gaps"] == [["hvd.hook", pytest.approx(60e-6)]]
    run = _run(RESNET, [s], trace_steps=2)
    assert harness.reader("hook_idle_ms.images").read(run) == \
        pytest.approx(0.03)
