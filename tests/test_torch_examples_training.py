"""The port's training example twins at smoke size on the CPU, each held
to its JAX script.

``mnist_eager`` (``examples/jax_mnist_eager.py``: the hook route),
``mnist_estimator`` (``examples/jax_mnist_estimator.py``: steps, periodic
evaluation, a rank-0 checkpoint), ``elastic`` (``examples/jax_elastic.py``:
commits every ``--commit-every`` batches; a second run on the same
commits resumes past the last epoch and trains nothing) and
``scaling_benchmark`` (``examples/scaling_benchmark.py``: worlds of 1 and 2
gloo ranks).

Each twin's own CLI run (its seeded init) trains: finite losses that fall.
Then the oracle: the JAX scripts run in two child processes on one CPU
device each (this test process's JAX world has eight), started with the
module so that they run beside the twin-only tests, every train step's
loss recorded (``make_train_step`` and the eager optimizer's ``backward``
wrapped) with the final parameters and the printed evaluations.  The twin
runs in this process, a world of one, from the JAX script's flax init
(computed here from the same key, carried over with
``vision_state_dict_from_flax``) on the same ``synthetic_mnist`` and
``ShardedLoader`` order: its per-step losses agree within ``LOSS_RTOL``,
each of the estimator's final parameters moved from the init by an update
within ``UPDATE_RTOL`` of the script's (in norm), and its evaluated
accuracy equals the printed three decimals.  Both sides are f32; SGD with
momentum and Adam are the same arithmetic in optax and torch.  The
update is held in norm because Adam divides each gradient by its own
root mean square: an element whose gradient is near zero, below the two
sides' f32 summation differences, steps by up to the learning rate on
either side (17 of the dense layer's 401,408 weights do, by up to 2.3e-4).
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu_torch.data import synthetic_mnist
from horovod_tpu_torch.examples import (elastic, mnist_eager,
                                        mnist_estimator, scaling_benchmark)
from horovod_tpu_torch.models.convert import vision_state_dict_from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
UPDATE_RTOL = 1e-4

# The JAX scripts' arguments, the twins' too: small enough that compiling
# dominates the children's time.
EAGER_ARGS = ["--epochs", "2", "--samples", "128"]
ESTIMATOR_ARGS = ["--train-steps", "8", "--eval-every", "4"]
ELASTIC_ARGS = ["--epochs", "2", "--batch-per-chip", "16", "--samples",
                "256", "--commit-every", "4"]
SCALING_ARGS = ["--model", "mlp", "--bs", "2", "--iters", "1", "--batches",
                "2", "--no-contention-baseline"]

# Named JAX scripts' main() in turn on one CPU device, each train step's
# loss and the last step's parameters recorded, stdout captured; argv: repo
# root, output pickle, then (name, script, arguments joined by \x1f)
# triples.
_JAX_SCRIPT = r"""
import contextlib, importlib.util, io, os, pickle, sys
root, out, *jobs = sys.argv[1:]
sys.path.insert(0, root)
import jax
jax.config.update("jax_platforms", "cpu")
import horovod_tpu as hvd
make_step, Eager = hvd.make_train_step, hvd.EagerDistributedOptimizer
res = {}
for key, script, argv in zip(jobs[::3], jobs[1::3], jobs[2::3]):
    seen, last = [], []
    def make(*a, **k):
        step = make_step(*a, **k)
        def run(*b, **kw):
            r = step(*b, **kw)
            seen.append(float(r.loss))
            last[:] = [jax.device_get(r.params)]
            return r
        return run
    class Recording(Eager):
        def backward(self, *a, **k):
            loss = super().backward(*a, **k)
            seen.append(float(loss))
            return loss
    hvd.make_train_step, hvd.EagerDistributedOptimizer = make, Recording
    spec = importlib.util.spec_from_file_location(
        script, os.path.join(root, "examples", script + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.argv = [script + ".py", *argv.split("\x1f")]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main()
    res[key] = {"losses": seen, "stdout": buf.getvalue(),
                "params": last[0] if last else None}
with open(out, "wb") as f:
    pickle.dump(res, f)
"""

# Two children: the two scripts that save checkpoints (orbax's first save
# takes seconds) beside the two that do not.  ``elastic_again`` reruns on
# ``elastic``'s commits.
_CHILDREN = (
    (("eager", "jax_mnist_eager", EAGER_ARGS, None),
     ("scaling", "scaling_benchmark", SCALING_ARGS, None)),
    (("estimator", "jax_mnist_estimator", ESTIMATOR_ARGS, "estimator"),
     ("elastic", "jax_elastic", ELASTIC_ARGS, "elastic"),
     ("elastic_again", "jax_elastic", ELASTIC_ARGS, "elastic")),
)


class _JaxRuns:
    """The children's results by key; ``[key]`` waits for its child."""

    def __init__(self, tmp):
        env = {k: v for k, v in os.environ.items()
               if k not in ("XLA_FLAGS", "PYTHONPATH")}
        env.update(JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
        self._procs = []
        for i, jobs in enumerate(_CHILDREN):
            out = tmp / f"child{i}.pkl"
            argv = []
            for key, script, args, ck in jobs:
                if ck:
                    args = [*args, "--ckpt-dir", str(tmp / ck)]
                argv += [key, script, "\x1f".join(args)]
            p = subprocess.Popen(
                [sys.executable, "-c", _JAX_SCRIPT, ROOT, str(out), *argv],
                env=env, cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
            self._procs.append(([job[0] for job in jobs], p, out))
        self._res: dict = {}

    def __getitem__(self, key):
        if key not in self._res:
            keys, p, out = next(c for c in self._procs if key in c[0])
            log, _ = p.communicate(timeout=240)
            assert p.returncode == 0, log
            with open(out, "rb") as f:
                self._res.update(pickle.load(f))
        return self._res[key]

    def close(self):
        for _, p, _ in self._procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module", autouse=True)
def jax_runs(tmp_path_factory):
    runs = _JaxRuns(tmp_path_factory.mktemp("jax_examples"))
    yield runs
    runs.close()


def _flax_init(model, key: int, x) -> dict:
    return vision_state_dict_from_flax(
        {"params": model.init(jax.random.key(key), jnp.asarray(x))["params"]})


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny models on one torch thread: the test run's six workers share
    the host's cores, and eight threads a worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_mnist_eager_smoke_loss_falls(capsys):
    losses = mnist_eager.main(["--smoke", "--device", "cpu"])
    assert len(losses) == 16 and np.all(np.isfinite(losses))
    assert np.mean(losses[8:]) < np.mean(losses[:8])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["epoch 0", "epoch 1"]


def test_mnist_estimator_smoke_evaluates_and_checkpoints(tmp_path, capsys):
    """12 steps at Adam(0.005): the JAX script's first update overshoots
    (its loss jumps, as flax's does) and the net settles near chance, so
    the held-out loss is what falls."""
    out = mnist_estimator.main(["--smoke", "--device", "cpu", "--ckpt-dir",
                                str(tmp_path)])
    assert len(out["losses"]) == 13 and np.all(np.isfinite(out["losses"]))
    assert [e["step"] for e in out["evals"]] == [0, 4, 8, 12]
    assert out["evals"][-1]["loss"] < out["evals"][0]["loss"]
    assert all(0.0 <= e["accuracy"] <= 1.0 for e in out["evals"])
    assert os.listdir(tmp_path) == ["step_12"]
    assert capsys.readouterr().out.startswith("step 0: loss ")


def test_elastic_second_run_resumes_and_trains_nothing(tmp_path, capsys):
    argv = ["--epochs", "2", "--batch-per-chip", "16", "--samples", "256",
            "--commit-every", "4", "--ckpt-dir", str(tmp_path), "--device",
            "cpu"]
    first = elastic.main(argv)
    assert len(first["losses"]) == 32 and np.all(np.isfinite(first["losses"]))
    assert np.mean(first["losses"][16:]) < np.mean(first["losses"][:16])
    # four commits an epoch from the cadence, one at each epoch's end
    assert first["epoch"] == 2 and first["commit_step"] == 10
    assert any(p.startswith("step_") for p in os.listdir(tmp_path))
    second = elastic.main(argv)
    assert second == {"losses": [], "epoch": 2, "commit_step": 10}
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["epoch 0", "epoch 1"]


def test_scaling_benchmark_smoke_over_worlds_of_one_and_two(capsys):
    out = scaling_benchmark.main(["--smoke", "--device", "cpu"])
    assert sorted(out["scaling"]) == [1, 2]
    assert out["scaling"][1]["scaling_efficiency"] == 1.0
    for n, row in out["scaling"].items():
        assert row["img_per_sec_per_rank"] > 0
        assert row["collective_efficiency"] > 0
        losses = out["losses"][n]
        assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    # both worlds train the same replicated model on the same batch
    np.testing.assert_allclose(out["losses"][1], out["losses"][2],
                               rtol=1e-5)
    text = capsys.readouterr().out
    assert "n=   1" in text and "n=   2" in text and '"scaling"' in text


def test_mnist_eager_losses_equal_the_jax_example(jax_runs):
    from horovod_tpu.models.mnist import MnistMLP as FlaxMLP

    images, _ = synthetic_mnist(128)
    losses = mnist_eager.main([*EAGER_ARGS, "--device", "cpu"],
                              state_dict=_flax_init(FlaxMLP(), 42,
                                                    images[:1]))
    want = jax_runs["eager"]["losses"]
    assert len(losses) == len(want) == 8
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)


def test_mnist_estimator_equals_the_jax_example(jax_runs, tmp_path):
    """Per-step losses, the final (checkpointed) parameters, and the
    accuracy evaluated at steps 0, 4 and 8 against the script's prints."""
    from horovod_tpu.models.mnist import MnistConvNet as FlaxConvNet

    images, _ = synthetic_mnist(1)
    init = _flax_init(FlaxConvNet(), 0, images)
    out = mnist_estimator.main(
        [*ESTIMATOR_ARGS, "--device", "cpu", "--ckpt-dir", str(tmp_path)],
        state_dict=init)
    jx = jax_runs["estimator"]
    assert len(out["losses"]) == len(jx["losses"]) == 9
    np.testing.assert_allclose(out["losses"], jx["losses"], rtol=LOSS_RTOL)
    want = vision_state_dict_from_flax({"params": jx["params"]})
    assert sorted(out["params"]) == sorted(want)
    for key, w in want.items():
        moved, want_moved = out["params"][key] - init[key], w - init[key]
        assert float((moved - want_moved).norm()) \
            <= UPDATE_RTOL * float(want_moved.norm()), key
    printed = [(int(ln.split()[1].rstrip(":")), float(ln.split()[-1]))
               for ln in jx["stdout"].splitlines()]
    assert [(e["step"], round(e["accuracy"], 3)) for e in out["evals"]] \
        == printed
    assert os.listdir(tmp_path) == ["step_8"]


def test_elastic_losses_equal_the_jax_example(jax_runs, tmp_path):
    """Both scripts' first runs step alike from the same init; both second
    runs, on their own commits, train nothing."""
    from horovod_tpu.models.mnist import MnistMLP as FlaxMLP

    images, _ = synthetic_mnist(256)
    argv = [*ELASTIC_ARGS, "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    first = elastic.main(argv, state_dict=_flax_init(FlaxMLP(), 42,
                                                     images[:1]))
    want = jax_runs["elastic"]["losses"]
    assert len(first["losses"]) == len(want) == 32
    np.testing.assert_allclose(first["losses"], want, rtol=LOSS_RTOL)
    assert elastic.main(argv)["losses"] == []
    assert jax_runs["elastic_again"]["losses"] == []
    assert jax_runs["elastic_again"]["stdout"] == ""


def test_scaling_benchmark_losses_equal_the_jax_example(jax_runs):
    """The MLP's steps on ones and zeros from the JAX script's init, in the
    world of one that the JAX child has: the twin records the first step's
    loss and each timed group's last (steps 0 and 2).  That its world of
    two steps alike is the smoke test's."""
    from horovod_tpu.models.mnist import MnistMLP as FlaxMLP

    out = scaling_benchmark.main(
        [*SCALING_ARGS, "--max-world", "1", "--device", "cpu"],
        state_dict=_flax_init(FlaxMLP(), 0, np.ones((1, 28 * 28),
                                                    np.float32)))
    want = jax_runs["scaling"]["losses"]
    assert sorted(out["losses"]) == [1] and len(want) == 3
    np.testing.assert_allclose(out["losses"][1], [want[0], want[2]],
                               rtol=LOSS_RTOL)
