"""The control, the reference one precision down (fp8 products in place of
the configuration's bf16), must come out not correct.

On the CPU at a tiny size against the tiny limits (:mod:`tiny`); on the
card at each cell's own size, on three seeds, against the cell's own
limits (the calibration on the chip that set them is in ``PERF.md``).
"""

from __future__ import annotations

import pytest
import torch

from portbench import compare, harness
from portbench.tests import tiny

CELLS = ("mistral7b-l8.train.4x4096", "resnet50.train.b256")


def _control(cell, seed, device):
    args = (cell.config, cell.traffic, cell.config["training"], seed,
            cell.chips, cell.spec["checked_steps"], device)
    ref = cell.runner.reference(*args)
    return compare.judge(cell.runner.reference(*args, lowp=True), ref,
                         cell.spec["limits"])


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_at_a_tiny_size(name):
    ok, compared, _ = _control(tiny.cell(name), 2 ** 31 + 7,
                               torch.device("cpu"))
    assert not ok, compared


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 102,
                                  2 ** 31 + 103])
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_at_the_cells_size_on_card(name, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell's size runs on the card")
    cell = harness.Cell(name)
    ok, compared, _ = _control(cell, seed, torch.device("cuda"))
    assert not ok, compared


def _record(program, control=None, half=None):
    gaps = {"program": dict(zip(compare.NUMBERS, program))}
    if control is not None:
        gaps["control"] = dict(zip(compare.NUMBERS, control))
        gaps["half_batch"] = dict(zip(compare.NUMBERS, half))
    return {"gaps": gaps}


def test_the_calibration_sets_limits_the_control_fails():
    from portbench import calibrate

    # The control reads 2.9 times the sound loss gap, under the three
    # times from which it counts as the upper reading; half a batch sets
    # the loss's upper one, and under those limits the control would
    # fail nothing: its loss limit goes between the two.
    records = [_record((5.8e-5, 0.059, 0.053), (1.68e-4, 0.063, 0.061),
                       (1.38e-3, 0.45, 0.43))]
    records += [_record((2e-5, 0.02, 0.02))] * 11
    got = calibrate.summarize(records)
    assert got["loss_gap"]["upper"] == pytest.approx(1.38e-3)
    assert got["loss_gap"]["limit"] == pytest.approx(
        5.8e-5 ** 0.4 * 1.68e-4 ** 0.6)
    assert 5.8e-5 < got["loss_gap"]["limit"] < 1.68e-4
    # The leaf numbers' upper reading is a state left unchanged.
    assert got["grad_gap"]["upper"] == 1.0
    assert got["grad_gap"]["limit"] == pytest.approx(0.059 ** 0.4)
    # Where the control counts, the limit lies between it and the lower.
    clear = calibrate.summarize(
        [_record((1e-5, 0.01, 0.01), (1e-4, 0.02, 0.02), (1e-3, 0.5, 0.5))])
    assert clear["loss_gap"]["limit"] == pytest.approx(1e-5 ** 0.4 * 1e-4 ** 0.6)
