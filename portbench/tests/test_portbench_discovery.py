"""Cells, configurations, traffic, runners and metrics are found by name.

A later change adds a cell, a configuration or a metric as files and
entries; these tests hold the harness to that, and ``BENCHMARK.json`` to
the shape the harness reads.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

from portbench import compare, harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_entry_has_its_files():
    bench = harness.load_bench()
    for w in bench["workloads"]:
        cell = harness.Cell(w["name"], bench)
        for attr in ("Program", "reference", "work_per_step", "FAULTS"):
            assert hasattr(cell.runner, attr), (cell.name, attr)
        assert set(cell.spec["limits"]) == set(compare.NUMBERS)
        assert cell.end_to_end and cell.per_layer
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.reader(m["name"]).read), m["name"]
    for c in bench["configs"]:
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["name"] == c["name"]
        assert sorted(config["reduced"]) == sorted(c["reduced"])
        assert config["source"] == c["source"]


def test_benchmark_json_keeps_the_shape_the_driver_reads():
    bench = harness.load_bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    cells = {w["name"]: w for w in bench["workloads"]}
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == \
        len(cells)
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert "workloads" not in e2e[m["moves"]] or \
                cell in e2e[m["moves"]]["workloads"]
    # The full check at 24 cells fits its 43,200 s.
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


def _tree_hashes(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_cell_and_metric_are_picked_up_from_files_alone(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    before = _tree_hashes(tmp_path / "portbench")
    pb = tmp_path / "portbench"
    (pb / "traffic" / "train.b128.json").write_text(json.dumps(
        {"kind": "images", "images_per_card": 128}))
    (pb / "cells" / "resnet50.train.b128.json").write_text(json.dumps(
        {"checked_steps": 3, "trace_steps": 10,
         "limits": {n: 1.0 for n in compare.NUMBERS}}))
    (pb / "metrics" / "images_per_step.images.py").write_text(
        "def read(run):\n    return run.work / run.steps\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "resnet50.train.b128",
                               "config": "resnet50", "traffic": "train.b128",
                               "chips": 1, "why": "a smaller batch"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("train_images_per_s", "mfu.images"):
            m["workloads"].append("resnet50.train.b128")
    bench["per_layer"].append({
        "name": "images_per_step.images", "unit": "images", "better":
        "higher", "source": "program_counter", "layer": "model step",
        "moves": "train_images_per_s", "workloads": ["resnet50.train.b128"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    probe = (
        "import json\n"
        "from portbench import harness\n"
        "cell = harness.Cell('resnet50.train.b128')\n"
        "run = harness.Run(cell, [{'rank': 0, 'window': {'steps': 4, "
        "'seconds': 1.0}, 'work_per_step': cell.runner.work_per_step("
        "cell.config, cell.traffic), 'trace': None, 'trace_steps': 0, "
        "'setup_end': 0.0}], 0.0)\n"
        "print(json.dumps({'traffic': cell.traffic['images_per_card'], "
        "'per_layer': [m['name'] for m in cell.per_layer], "
        "'value': harness.reader('images_per_step.images').read(run)}))\n")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path,
                         env=env, capture_output=True, text=True, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"traffic": 128, "per_layer": [
        "mfu.images", "images_per_step.images"], "value": 128.0}
    after = _tree_hashes(pb)
    assert {k: v for k, v in after.items() if k in before} == before
