"""The port's ``word2vec`` twin against ``examples/jax_word2vec.py``.

The JAX script runs in a child process on one CPU device (this test
process's JAX world has eight), dense and ``--sparse``, its optimizer's
per-step loss recorded; its batch generator is seeded from ``hash("w2v")``,
so the child fixes ``PYTHONHASHSEED`` and reports the seed.  The twin
trains in this process, a world of one, from the same initial tables (the
JAX script's ``jax.random.normal(key(0)) · 0.05`` and zeros, computed here)
and the same batches: its losses agree within ``TOL``.  Adagrad differs
only in where epsilon (1e-7) sits (optax: 1/√(s + ε), torch: 1/(√s + ε),
with s ≥ 0.1); the top-k selection of ``--sparse`` is the same.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from horovod_tpu_torch import basics
from horovod_tpu_torch.examples import word2vec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--steps", "20", "--batch-per-chip", "16", "--vocab", "128",
        "--dim", "16"]
TOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny models on one torch thread: the test run's six workers share
    the host's cores, and eight threads a worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# jax_word2vec.main() dense, then --sparse, on one CPU device; argv: repo
# root, output file, then the script's arguments.
_JAX_SCRIPT = r"""
import importlib.util, json, os, sys
root, out, args = sys.argv[1], sys.argv[2], sys.argv[3:]
sys.path.insert(0, root)
import jax
jax.config.update("jax_platforms", "cpu")
import horovod_tpu as hvd
res = {"seed": hash("w2v") % 2 ** 31}
Base = hvd.EagerDistributedOptimizer
for mode, extra in (("dense", []), ("sparse", ["--sparse"])):
    seen = res[mode] = []
    class Recording(Base):
        def backward(self, *a, _seen=seen, **k):
            loss = super().backward(*a, **k)
            _seen.append(float(loss))
            return loss
    hvd.EagerDistributedOptimizer = Recording
    spec = importlib.util.spec_from_file_location(
        "jax_word2vec", os.path.join(root, "examples", "jax_word2vec.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.argv = ["jax_word2vec.py", *args, *extra]
    mod.main()
json.dump(res, open(out, "w"))
"""


@pytest.fixture(scope="module")
def jax_losses(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_w2v") / "losses.json")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "PYTHONPATH")}
    env.update(JAX_PLATFORMS="cpu", PYTHONHASHSEED="0")
    r = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, ROOT, out, *ARGS],
                       env=env, cwd=ROOT, capture_output=True, text=True,
                       timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("mode", ["dense", "sparse"])
def test_losses_equal_the_jax_example(jax_losses, mode):
    emb_in = np.asarray(jax.random.normal(jax.random.key(0), (128, 16))
                        * 0.05)
    args = word2vec.parse([*ARGS, "--device", "cpu"]
                          + (["--sparse"] if mode == "sparse" else []))
    try:
        losses = word2vec.run(args, (emb_in, np.zeros((128, 16),
                                                      np.float32)),
                              data_seed=jax_losses["seed"])
    finally:
        basics.shutdown()
    want = np.asarray(jax_losses[mode])
    assert len(losses) == len(want) == 20
    np.testing.assert_allclose(losses, want, rtol=TOL)
    assert losses[-1] < losses[0]


def test_cli_trains_from_its_own_tables(capsys):
    """The CLI's own seeded tables and batches, dense and sparse: finite
    losses that fall, rank 0's first print."""
    for extra in ([], ["--sparse"]):
        losses = word2vec.main([*ARGS, "--device", "cpu", *extra])
        assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert capsys.readouterr().out.count("step 0: loss") == 2
