"""The PyTorch port stands alone: no JAX, no ``horovod_tpu``, no silent CPU.

``horovod_tpu_torch`` must import neither ``jax`` nor anything of the JAX
package (whose ``__init__`` pulls in jax, flax and optax), and its entry
points must refuse to run when CUDA is asked for (by default) and absent.
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "horovod_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "horovod_tpu")


def _modules() -> list[str]:
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PORT.rglob("*.py"))


def _forbidden(name: str) -> bool:
    # exact top-level match: "horovod_tpu_torch" is not "horovod_tpu"
    return name.split(".")[0] in FORBIDDEN


def test_port_modules_import_without_jax():
    mods = _modules()
    assert {"horovod_tpu_torch.serving", "horovod_tpu_torch.basics",
            "horovod_tpu_torch.optim.distributed_optimizer",
            "horovod_tpu_torch.examples.llama_finetune",
            "horovod_tpu_torch.data", "horovod_tpu_torch.callbacks",
            "horovod_tpu_torch.training", "horovod_tpu_torch.models.resnet",
            "horovod_tpu_torch.models.vit", "horovod_tpu_torch.models.vgg",
            "horovod_tpu_torch.models.inception",
            "horovod_tpu_torch.models.mnist",
            "horovod_tpu_torch.examples.mnist",
            "horovod_tpu_torch.examples.synthetic_benchmark",
            "horovod_tpu_torch.ops.compression",
            "horovod_tpu_torch.ops.collective_ops",
            "horovod_tpu_torch.ops.powersgd",
            "horovod_tpu_torch.checkpoint",
            "horovod_tpu_torch.models.convert",
            "horovod_tpu_torch.metrics", "horovod_tpu_torch.faults",
            "horovod_tpu_torch.profiler", "horovod_tpu_torch.drafting",
            "horovod_tpu_torch.scheduling",
            "horovod_tpu_torch.prefix_cache",
            "horovod_tpu_torch.serving_scheduler",
            "horovod_tpu_torch.examples.llama_serving",
            "horovod_tpu_torch.ops.eager",
            "horovod_tpu_torch.ops.handle_manager",
            "horovod_tpu_torch.timeline", "horovod_tpu_torch.autotune",
            "horovod_tpu_torch.native",
            "horovod_tpu_torch.optim.eager_optimizer",
            "horovod_tpu_torch.torch_frontend",
            "horovod_tpu_torch.examples.pytorch_mnist",
            "horovod_tpu_torch.examples.pytorch_synthetic_benchmark",
            "horovod_tpu_torch.knobs", "horovod_tpu_torch.device_telemetry",
            "horovod_tpu_torch.tracing", "horovod_tpu_torch.monitor",
            "horovod_tpu_torch.timeseries", "horovod_tpu_torch.alerts",
            "horovod_tpu_torch.elastic", "horovod_tpu_torch.torch_elastic",
            "horovod_tpu_torch.router", "horovod_tpu_torch.supervisor",
            "horovod_tpu_torch.examples.pytorch_elastic",
            "horovod_tpu_torch.loadgen", "horovod_tpu_torch.autoscaler",
            "horovod_tpu_torch.chaos", "horovod_tpu_torch.simfleet",
            "horovod_tpu_torch.tools",
            "horovod_tpu_torch.tools.device_report",
            "horovod_tpu_torch.tools.trace_report",
            "horovod_tpu_torch.tools.chaos_run",
            "horovod_tpu_torch.tools.simfleet_run",
            "horovod_tpu_torch.tools.perf_gate",
            "horovod_tpu_torch.parallel.mesh",
            "horovod_tpu_torch.keras", "horovod_tpu_torch.keras.callbacks",
            "horovod_tpu_torch.keras_elastic",
            } <= set(mods)
    assert len(mods) >= 78
    code = ("import sys\n"
            f"for m in {mods!r}:\n"
            "    __import__(m)\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
            "assert not bad, bad\n"
            # the Keras frontend imports keras at its first use only
            "assert 'keras' not in sys.modules, 'keras imported'\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*PORT.rglob("*.py"),
                                       ROOT / "chip_smoke.py"]))
def test_no_jax_imports_in_source(path):
    """AST scan of every port module and of chip_smoke.py."""
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


def test_forbidden_match_is_exact():
    assert _forbidden("horovod_tpu.models.llama") and _forbidden("jax.numpy")
    assert not _forbidden("horovod_tpu_torch.models.llama")


def test_entry_points_raise_without_cuda():
    """No device argument means the card; without one they raise."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from horovod_tpu_torch import resolve_device
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.models.convert import params_from_jax
    from horovod_tpu_torch.tools import chaos_run

    cfg = llama.llama_tiny()
    for call in (lambda: resolve_device(),
                 lambda: llama.init_params(cfg),
                 lambda: llama.init_cache(cfg, 1, 8),
                 lambda: params_from_jax({"w": [1.0]}),
                 lambda: chaos_run._build_world(None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
