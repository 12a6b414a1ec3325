"""The run's refusals: JAX in the process, no card, no program beside it."""

from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys

from portbench import harness

ROOT = harness.ROOT


def test_jax_check_compares_whole_top_level_names(monkeypatch):
    for name in ("horovod_tpu_torch.basics", "jaxtyping", "flaxen",
                 "horovod_tpu_tools"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.banned_modules() == []
    monkeypatch.setitem(sys.modules, "horovod_tpu.basics", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.banned_modules() == ["horovod_tpu", "jax"]


def test_no_benchmark_file_imports_the_jax_side():
    for path in (ROOT / "portbench").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in harness.BANNED, (path, m)


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "resnet50.train.b256", "--seed", str(2 ** 31 + 11), "--seconds",
         "10", "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        env=env, timeout=300)


def test_a_machine_without_a_card_gets_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_the_benchmark_alone_cannot_run(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _run(tmp_path, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
