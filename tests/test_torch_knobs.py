"""The port's knob table (``horovod_tpu_torch/knobs.py``) is complete.

The JAX package's table is policed by hvdlint, which scans only
``horovod_tpu/``; this AST scan is the port's counterpart: every
``HVD_TORCH_*`` / ``HOROVOD_*`` string literal in the port is a row of
``ENV_KNOBS``, every row is read somewhere outside the table, the table is
sorted and unique, and each ``HVD_TORCH_*`` row that mirrors a reference
knob keeps the reference's default.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

import pytest

from horovod_tpu import knobs as jknobs
from horovod_tpu_torch import knobs

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "horovod_tpu_torch"
KNOB = re.compile(r"(HVD_TORCH|HOROVOD)_[A-Z0-9_]+")

# the port's knobs whose reference counterpart has another name or meaning
_PORT_OWN = {"HVD_TORCH_CONTROLLER_TRANSPORT", "HVD_TORCH_NATIVE_CONTROLLER",
             "HVD_TORCH_FLASH_BWD"}
# the port's knobs whose reference counterpart is not HVD_TPU_<same>
_REF_NAME = {"HVD_TORCH_ELASTIC_RETRIES": "HOROVOD_TPU_ELASTIC_RETRIES"}


def _literals() -> dict[str, set[str]]:
    """Knob-shaped string constants, by name → the files reading them."""
    found: dict[str, set[str]] = {}
    for path in PORT.rglob("*.py"):
        if path.name == "knobs.py":
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)
                    and KNOB.fullmatch(node.value)):
                found.setdefault(node.value, set()).add(
                    str(path.relative_to(ROOT)))
    return found


def test_every_literal_is_a_row_and_every_row_is_read():
    rows = {k.name for k in knobs.knobs()}
    used = _literals()
    assert set(used) - rows == set(), "knobs read but not in ENV_KNOBS"
    assert rows - set(used) == set(), "ENV_KNOBS rows nothing reads"


def test_table_is_sorted_unique_and_renders():
    names = [k.name for k in knobs.knobs()]
    assert names == sorted(names) and len(names) == len(set(names))
    table = knobs.render_markdown_table()
    assert all(f"`{n}`" in table for n in names)
    for k in knobs.knobs():
        assert k.help and k.help.endswith(".")


@pytest.mark.parametrize("name", sorted(
    k.name for k in knobs.knobs()
    if k.name.startswith("HVD_TORCH_") and k.name not in _PORT_OWN))
def test_defaults_are_the_references(name):
    ref = {k.name: k.default for k in jknobs.knobs()}
    port = {k.name: k.default for k in knobs.knobs()}
    assert port[name] == ref[_REF_NAME.get(
        name, name.replace("HVD_TORCH_", "HVD_TPU_"))]


def test_the_new_planes_have_rows():
    rows = {k.name for k in knobs.knobs()}
    assert {"HVD_TORCH_DEVICE_TELEMETRY", "HVD_TORCH_DEVICE_POLL_S",
            "HVD_TORCH_PEAK_FLOPS", "HVD_TORCH_MONITOR_PORT",
            "HVD_TORCH_SAMPLE_S", "HVD_TORCH_ALERTS",
            "HVD_TORCH_TRACE_SAMPLE", "HVD_TORCH_TRACE_SEED"} <= rows


def test_the_elastic_router_and_supervisor_knobs_have_rows():
    rows = {k.name: k for k in knobs.knobs()}
    # the router's deployment settings are knobs; its tuning settings and
    # the supervisor's are constructor arguments, which the fleet's own
    # callers (loadgen, chaos, simfleet) pass directly
    assert {"HVD_TORCH_ELASTIC_RETRIES", "HVD_TORCH_AUTOSCALE",
            "HVD_TORCH_ROUTER_JOURNAL", "HVD_TORCH_ROUTER_POLICY",
            "HVD_TORCH_ROUTER_POLL_S", "HVD_TORCH_ROUTER_PORT"} <= set(rows)
    assert not any(n.startswith(("HVD_TORCH_ROUTER_DRAIN",
                                 "HVD_TORCH_SUPERVISE")) for n in rows)
    # the autoscaler is ported: its row says what it does, not a refusal
    assert "ROADMAP" not in rows["HVD_TORCH_AUTOSCALE"].help
    assert rows["HVD_TORCH_AUTOSCALE"].help == \
        {k.name: k for k in jknobs.knobs()}["HVD_TPU_AUTOSCALE"].help


def test_the_control_plane_knobs_have_rows():
    rows = {k.name for k in knobs.knobs()}
    assert {"HVD_TORCH_AUTOSCALE_COOLDOWN_S",
            "HVD_TORCH_AUTOSCALE_MAX_REPLICAS",
            "HVD_TORCH_AUTOSCALE_MIN_REPLICAS", "HVD_TORCH_AUTOSCALE_STABLE_S",
            "HVD_TORCH_AUTOSCALE_STEP", "HVD_TORCH_BENCH_CACHE",
            "HVD_TORCH_LOAD_DURATION_S", "HVD_TORCH_LOAD_LADDER",
            "HVD_TORCH_LOAD_PROCESS", "HVD_TORCH_LOAD_SEED",
            "HVD_TORCH_LOAD_TIMEOUT_S", "HVD_TORCH_SIM_REPLICAS",
            "HVD_TORCH_SIM_REQUESTS", "HVD_TORCH_SIM_SEED",
            "HVD_TORCH_STRAGGLER_WARN_S"} <= rows
