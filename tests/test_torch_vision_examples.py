"""The vision example twins: ``python -m horovod_tpu_torch.examples.mnist``
and ``python -m horovod_tpu_torch.examples.synthetic_benchmark``.

Each drives the port's data-parallel path as a user would (``init``, the LR
scaled by the world size, ``DistributedOptimizer``, the broadcasts,
``make_train_step``), here with ``--smoke --device cpu`` in a world of one;
``--ckpt-dir`` writes rank-0 checkpoints and every ``--compression`` and
``--adasum`` of the JAX twin trains.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from horovod_tpu_torch.examples import mnist, synthetic_benchmark

ROOT = Path(__file__).resolve().parent.parent
LAUNCH_VARS = ("HOROVOD_TPU_PROCESS_ID", "HOROVOD_TPU_NUM_PROCESSES",
               "HOROVOD_TPU_COORDINATOR", "RANK", "WORLD_SIZE",
               "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture
def no_launcher(monkeypatch):
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)


def test_mnist_twin_runs_as_a_module_on_cpu():
    """``python -m horovod_tpu_torch.examples.mnist --smoke --device cpu``
    trains two epochs and exits 0."""
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_VARS}
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.examples.mnist", "--smoke",
         "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "epoch 0: loss" in out.stdout and "epoch 1: loss" in out.stdout


def test_mnist_twin_loss_falls(no_launcher):
    losses = mnist.main(["--smoke", "--device", "cpu"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert losses[1] < losses[0]


def test_mnist_twin_checkpoint_flag_waits_for_its_slice(no_launcher,
                                                        tmp_path):
    """``--ckpt-dir`` (the JAX twin's ``examples/jax_mnist.py:69-71``):
    one rank-0 checkpoint an epoch, holding the parameters and the
    optimizer state."""
    import torch

    mnist.main(["--smoke", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert sorted(os.listdir(tmp_path)) == ["step_0", "step_1"]
    saved = torch.load(tmp_path / "step_1", weights_only=True)
    assert set(saved) == {"params", "opt"} and saved["params"]


@pytest.mark.parametrize("compression", ["none", "fp16", "bf16"])
def test_synthetic_benchmark_twin_reports_img_per_sec(no_launcher, capsys,
                                                      compression):
    rates = synthetic_benchmark.main(["--smoke", "--device", "cpu",
                                      "--compression", compression])
    assert len(rates) == 2 and all(r > 0 for r in rates)
    out = capsys.readouterr().out
    assert "Img/sec per card:" in out and "Total img/sec on 1 card(s)" in out
    assert f"Compression: {compression}" in out


@pytest.mark.parametrize("flags", [["--compression", "int8"],
                                   ["--compression", "powersgd"],
                                   ["--compression", "ef-topk"],
                                   ["--adasum"]])
def test_synthetic_benchmark_twin_later_flags_raise(no_launcher, capsys,
                                                    flags):
    """The JAX twin's lossy compressors and ``--adasum`` train and report
    img/sec; ``--adasum`` with a lossy compressor is refused, as the twin's
    ``p.error`` does."""
    rates = synthetic_benchmark.main(["--smoke", "--device", "cpu", *flags])
    assert len(rates) == 2 and all(r > 0 for r in rates)
    out = capsys.readouterr().out
    assert "Img/sec per card:" in out
    if flags == ["--adasum"]:
        assert "Op: Adasum" in out
        return
    assert f"Compression: {flags[1]}" in out
    with pytest.raises(SystemExit):
        synthetic_benchmark.main(["--smoke", "--device", "cpu", "--adasum",
                                  *flags])
