"""A run whose timed path is broken underneath comes out not correct.

Each test skips only the harness's look for a card: it drives the rest of
a run (the program built from the seed, the checked first steps, the
window, the reference, the comparison, the result line) on the CPU at a
tiny size (:mod:`tiny`), once for each fault a cell can have: a step that
leaves the state unchanged, half of each batch left out (the mean taken
over the rest), the 3×3 convolutions of ResNet's residual branches left
out of the update, and, across ranks, the exchange left out.
"""

from __future__ import annotations

import json
import os
import time

import pytest
import torch
import torch.multiprocessing as mp

from portbench import harness
from portbench.tests import tiny

SEED = 2 ** 31 + 7
CELLS = ("mistral7b-l8.train.4x4096", "resnet50.train.b256")


def _line(name: str, fault):
    cell = tiny.cell(name)
    t = time.time()
    report = harness.run_rank(cell, SEED, 0.2, False, device="cpu",
                              fault=fault)
    return harness.result_line(cell, [report], t, False)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    line = _line(name, None)
    assert line["correct"] is True
    assert line["failed"] == 0 and line["attempted"] >= 2
    assert list(line)[-1] == "compared"


# ``frozen_branch`` gives each 3×3 convolution of ResNet's residual
# branches a zero gradient: the branches are held to the reference too.
@pytest.mark.parametrize("name,fault", [
    *((n, f) for n in CELLS for f in ("unchanged", "half_batch")),
    ("resnet50.train.b256", "frozen_branch")])
def test_a_broken_step_is_not_correct(name, fault):
    line = _line(name, fault)
    assert line["correct"] is False
    over = [n for n, c in line["compared"].items() if c["value"] > c["limit"]]
    assert over, line["compared"]


def _rank(rank, world, ports, fault, out):
    # The environment harness.launch gives a four-chip cell's workers,
    # here around the one-chip ResNet cell's files in a world of two.
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(ports[0]),
                      HVD_TORCH_CONTROLLER_TRANSPORT=f"tcp:127.0.0.1:{ports[1]}")
    torch.set_num_threads(1)
    cell = tiny.cell("resnet50.train.b256")
    report = harness.run_rank(cell, 12345, 0.2, False, device="cpu",
                              fault=fault)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


@pytest.mark.parametrize("fault", [None, "no_exchange"])
def test_the_exchange_left_out_is_not_correct(tmp_path, fault):
    from portbench.harness import _free_port

    ports = (_free_port(), _free_port())
    mp.start_processes(_rank, args=(2, ports, fault, str(tmp_path)),
                       nprocs=2, start_method="spawn")
    reports = [json.loads((tmp_path / f"rank{r}.json").read_text())
               for r in range(2)]
    line = harness.result_line(tiny.cell("resnet50.train.b256"), reports,
                               time.time(), False)
    assert line["device"]["count"] == 2
    assert line["correct"] is (fault is None)
