"""The example twin ``python -m horovod_tpu_torch.examples.llama_finetune``.

It drives the port's data-parallel path (``init``, ``broadcast_parameters``,
``DistributedOptimizer``, ``make_train_step``) as a user would, and the
ZeRO and FSDP steps on a gloo world of two; the sequence-parallel engines
are refused before ``init``, as the example builds no sequence-parallel
group.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_gloo_world import start_world

ROOT = Path(__file__).resolve().parent.parent
LAUNCH_VARS = ("HOROVOD_TPU_PROCESS_ID", "HOROVOD_TPU_NUM_PROCESSES",
               "HOROVOD_TPU_COORDINATOR", "RANK", "WORLD_SIZE",
               "MASTER_ADDR", "MASTER_PORT")


def test_example_twin_runs_on_cpu():
    """``python -m horovod_tpu_torch.examples.llama_finetune --tiny --steps 2
    --device cpu`` trains and exits 0."""
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_VARS}
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.examples.llama_finetune",
         "--tiny", "--steps", "2", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "step 0: loss" in out.stdout


@pytest.mark.parametrize("attn", ["ring", "ulysses", "ulysses_flash"])
def test_example_twin_later_flags_raise(attn, monkeypatch):
    """The sequence-parallel engines refuse, naming the missing group,
    before ``init`` (the reference's example fails at its first step)."""
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.examples import llama_finetune

    monkeypatch.setattr(basics, "init", lambda *a: pytest.fail("init ran"))
    with pytest.raises(NotImplementedError,
                       match="builds no sequence-parallel group"):
        llama_finetune.main(["--tiny", "--device", "cpu", "--attn", attn])


def _sharded_example(rank, world, flag):
    from horovod_tpu_torch.examples import llama_finetune

    return llama_finetune.main(["--tiny", "--device", "cpu", flag,
                                "--steps", "3", "--lr", "1e-2"])


@pytest.fixture(scope="module")
def sharded_runs():
    joins = {flag: start_world(_sharded_example, 2, flag)
             for flag in ("--zero", "--fsdp")}
    return {flag: join(timeout=300) for flag, join in joins.items()}


@pytest.mark.parametrize("flag", ["--zero", "--fsdp"])
def test_example_twin_zero_and_fsdp_train_on_two_ranks(sharded_runs, flag):
    """``--zero`` and ``--fsdp`` on a gloo world of two: every rank sees
    the same finite losses, falling."""
    losses = sharded_runs[flag]
    assert losses[0] == losses[1]
    assert len(losses[0]) == 3 and all(np.isfinite(losses[0]))
    assert losses[0][-1] < losses[0][0]


def test_example_twin_fused_loss_and_step_cap(monkeypatch):
    """``--fused-loss`` trains through the chunked loss; ``--max-steps``
    caps ``--steps``."""
    from horovod_tpu_torch.examples import llama_finetune

    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    losses = llama_finetune.main(["--tiny", "--device", "cpu", "--steps", "5",
                                  "--max-steps", "2", "--seq-len", "16",
                                  "--fused-loss", "--lr", "1e-2"])
    assert len(losses) == 2 and all(l == l and l > 0 for l in losses)


def test_example_twin_zero_and_fsdp_are_exclusive():
    from horovod_tpu_torch.examples import llama_finetune

    with pytest.raises(SystemExit):
        llama_finetune.main(["--tiny", "--device", "cpu", "--zero", "--fsdp"])
