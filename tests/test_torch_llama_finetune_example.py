"""The example twin ``python -m horovod_tpu_torch.examples.llama_finetune``.

It drives the port's data-parallel path (``init``, ``broadcast_parameters``,
``DistributedOptimizer``, ``make_train_step``) as a user would; the flags
of paths that come with later slices raise.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

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


@pytest.mark.parametrize("flags,match", [(["--zero"], "later slice"),
                                         (["--fsdp"], "later slice"),
                                         (["--attn", "ring"], "later slice")])
def test_example_twin_later_flags_raise(flags, match):
    from horovod_tpu_torch.examples import llama_finetune

    with pytest.raises(NotImplementedError, match=match):
        llama_finetune.main(["--tiny", "--device", "cpu", *flags])


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
