"""The reader of the port's fused batch norm, on synthetic summaries."""

from __future__ import annotations

import pytest

from portbench import harness
from portbench.tests.test_portbench_spans import RESNET, _with
from portbench.tests.test_portbench_trace import _run

FWD, BWD = ("_BatchNormAct",
            "autograd::engine::evaluate_function: _BatchNormActBackward")


def test_norm_reader_sums_the_forward_and_backward_ranges():
    reader = harness.reader("norm_ms.images")
    assert reader.RANGES == (FWD, BWD)
    assert {FWD, BWD} <= set(harness.range_names(harness.Cell(RESNET)))
    # Two traced steps of 53 norms: 4 ms forward and 6 ms backward a step.
    one = _run(RESNET, [_with({FWD: [4_000.0 / 53] * 53 * 2,
                               BWD: [6_000.0 / 53] * 53 * 2})],
               trace_steps=2)
    assert reader.read(one) == pytest.approx(10.0)
    # The mean over ranks; a rank whose ranges launched nothing counts 0.
    two = _run(RESNET, [_with({FWD: [8_000.0], BWD: [12_000.0]}),
                        _with({FWD: [0.0], BWD: [0.0]})], trace_steps=2)
    assert reader.read(two) == pytest.approx(5.0)
    # The forward alone still reads (a trace cut before a backward).
    assert reader.read(_run(RESNET, [_with({FWD: [4_000.0]})],
                            trace_steps=2)) == pytest.approx(2.0)


@pytest.mark.parametrize("ranges", [None, {FWD: [], BWD: []},
                                    {"hvd.reduce": [9_000.0]}],
                         ids=["no_ranges", "empty", "other_span"])
def test_norm_reader_reads_nothing_without_the_fused_norm(ranges):
    """The parent program has no such function: no value, never 0."""
    reader = harness.reader("norm_ms.images")
    assert reader.read(_run(RESNET, [_with(ranges)] * 2)) is None
    assert reader.read(_run(RESNET, [])) is None
