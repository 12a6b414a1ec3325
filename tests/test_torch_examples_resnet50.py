"""The port's ``pytorch_imagenet_resnet50`` twin against the JAX package's
script.

``examples/pytorch_imagenet_resnet50.py`` drives the JAX package's torch
frontend (``horovod_tpu.torch``), which wants one device a process, so it
runs here in a child process on one CPU device, its ``metric_average``
recorded at full precision.  The twin drives
``horovod_tpu_torch.torch_frontend``; the model (the same torch module,
weights drawn under ``torch.manual_seed(42)``) and the data
(``default_rng(42)``) are the script's, so the ``--smoke`` epochs' averaged
train and validation loss and accuracy agree within 1e-5.  Both sides run
torch on one thread: two epochs of a BN net on 24 images carry a change of
summation order (the convolutions' thread count) into the second digit of
the loss.  The crash-and-resume drill is a world of one:
``--crash-after 1`` kills the twin's CLI in a child process after epoch
1's checkpoint, and the relaunch, here, resumes from it and trains epoch 2
alone.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from horovod_tpu_torch.examples import pytorch_imagenet_resnet50 as twin

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5

# The JAX script's main() in a child process on one CPU device, every
# metric_average it takes recorded; argv: repo root, output file, ckpt dir.
_JAX_SCRIPT = r"""
import importlib.util, json, os, sys
root, out, ck = sys.argv[1:4]
sys.path.insert(0, root)
import jax
import torch
jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(1)
spec = importlib.util.spec_from_file_location(
    "jax_resnet50", os.path.join(root, "examples",
                                 "pytorch_imagenet_resnet50.py"))
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
seen, average = [], mod.metric_average
def metric_average(value, name):
    r = average(value, name)
    seen.append([name, r])
    return r
mod.metric_average = metric_average
sys.argv = ["pytorch_imagenet_resnet50.py", "--smoke", "--checkpoint-dir", ck]
mod.main()
json.dump(seen, open(out, "w"))
"""


def _env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "PYTHONPATH")}
    # one device, no fusion: the JAX engine compiles one program a shape
    env.update(JAX_PLATFORMS="cpu", HOROVOD_FUSION_THRESHOLD="0",
               OMP_NUM_THREADS="1")
    return env


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread, as the JAX child runs (see the docstring)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Started at once and read when first needed: the child runs while
    this file's other cases do."""
    d = tmp_path_factory.mktemp("jax_resnet50")
    out = str(d / "metrics.json")
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SCRIPT, ROOT, out, str(d / "ck")],
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    state = {}

    def result() -> list:
        if "seen" not in state:
            log, _ = proc.communicate(timeout=240)
            assert proc.returncode == 0, log
            with open(out) as f:
                state["seen"] = json.load(f)
        return state["seen"]

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def test_crash_after_one_epoch_then_resume_trains_epoch_two(
        jax_run, tmp_path, capsys):
    ck = str(tmp_path / "ck")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    first = subprocess.run(
        [sys.executable, "-m",
         "horovod_tpu_torch.examples.pytorch_imagenet_resnet50", "--smoke",
         "--device", "cpu", "--checkpoint-dir", ck, "--crash-after", "1"],
        env={**env, "OMP_NUM_THREADS": "1"}, cwd=ROOT, capture_output=True,
        text=True, timeout=240)
    assert first.returncode == 3, first.stdout + first.stderr
    assert "CRASH-INJECTED after epoch 1" in first.stdout, first.stderr
    assert sorted(os.listdir(ck)) == ["checkpoint-1.pt"]
    hist = twin.main(["--smoke", "--device", "cpu", "--checkpoint-dir", ck])
    out = capsys.readouterr().out
    assert "resumed_from 1" in out
    assert "epoch 2:" in out and "epoch 1:" not in out
    assert [row["epoch"] for row in hist] == [2]
    assert sorted(os.listdir(ck)) == ["checkpoint-1.pt", "checkpoint-2.pt"]


def test_smoke_metrics_equal_the_jax_scripts(jax_run, tmp_path, capsys):
    hist = twin.main(["--smoke", "--device", "cpu", "--checkpoint-dir",
                      str(tmp_path / "ck")])
    names = ("train_loss", "train_accuracy", "val_loss", "val_accuracy")
    mine = [[n, row[k]] for row in hist
            for n, k in zip(names, ("train_loss", "train_acc", "val_loss",
                                    "val_acc"))]
    ref = jax_run()
    assert [n for n, _ in mine] == [n for n, _ in ref]
    got, want = (np.array([v for _, v in s]) for s in (mine, ref))
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert "resumed_from 0" in capsys.readouterr().out


def test_fp16_allreduce_smoke_rounds_the_wire(jax_run, tmp_path):
    """``--fp16-allreduce`` sends every gradient as fp16, a world of one
    included: the run is finite and parts from the f32 wire's."""
    plain = twin.main(["--smoke", "--device", "cpu", "--checkpoint-dir",
                       str(tmp_path / "a")])
    fp16 = twin.main(["--smoke", "--device", "cpu", "--fp16-allreduce",
                      "--checkpoint-dir", str(tmp_path / "b")])
    assert all(np.isfinite(list(row.values())).all() for row in fp16)
    assert [r["train_loss"] for r in fp16] != [r["train_loss"]
                                               for r in plain]
