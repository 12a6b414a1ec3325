"""The benchmark's machinery: find a cell's files, run it, print its line.

Nothing here names a cell, a configuration, a traffic mix or a metric.
``BENCHMARK.json`` at the checkout's root lists them; each lives in a file
of its own that is found by its name:

* a configuration: the ``file`` its entry names; its ``runner`` key names
  ``portbench/runners/<runner>.py``;
* a traffic mix: ``portbench/traffic/<traffic>.json``;
* a cell's comparison limits and traced steps:
  ``portbench/cells/<cell>.json``;
* a metric, end-to-end or per layer: ``portbench/metrics/<metric>.py``,
  whose ``read(run)`` returns the value or None.

A runner module gives ``work_per_step(config, traffic)``, a ``Program``
class (built from the seed; ``first_steps(n)`` returns the comparison's
readings, ``step()`` runs one step and returns its loss, ``traced()``
opens the runner's own ranges, ``close()`` frees it) and
``reference(...)``, the plain readings.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from portbench import compare

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
BANNED = ("jax", "jaxlib", "flax", "horovod_tpu")


class Cell:
    """One cell of ``BENCHMARK.json`` with its files read."""

    def __init__(self, name: str, bench: dict | None = None):
        bench = bench if bench is not None else load_bench()
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"there are {sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        self.chips = self.entry["chips"]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = _json(ROOT / configs[self.entry["config"]]["file"])
        self.traffic = _json(PKG / "traffic" / f"{self.entry['traffic']}.json")
        self.spec = _json(PKG / "cells" / f"{name}.json")
        self.runner = importlib.import_module(
            f"portbench.runners.{self.config['runner']}")
        self.end_to_end = [m for m in bench["end_to_end"] if _applies(m, name)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if _applies(m, name) and m["moves"] in reported]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_bench() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def reader(metric: str):
    """``portbench/metrics/<metric>.py``, loaded by its path."""
    path = PKG / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def banned_modules() -> list[str]:
    """The JAX side's top-level modules that this process has loaded,
    compared by whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _agree(n: int, world: int, dev) -> int:
    """Rank 0's ``n`` on every rank (the harness's own broadcast)."""
    import torch
    import torch.distributed as dist

    if world == 1:
        return n
    t = torch.tensor([n], dtype=torch.int64, device=dev)
    dist.broadcast(t, 0)
    return int(t.item())


def run_rank(cell: Cell, seed: int, seconds: float, trace: bool, *,
             device: str | None = None, fault: str | None = None,
             range_names=()) -> dict:
    """This rank's part of a run: set-up with the checked first steps,
    the measured window, the traced segment, then, on rank 0 once the
    program is freed, the plain reference and the comparison."""
    import torch
    import torch.distributed as dist

    from portbench import trace as trace_mod

    spec, training = cell.spec, cell.config["training"]
    marks = [("start", time.perf_counter())]
    prog = cell.runner.Program(cell.config, cell.traffic, training, seed,
                               device=device, fault=fault)
    dev, rank, world = prog.dev, prog.rank, prog.world
    marks.append(("build", time.perf_counter()))
    readings = prog.first_steps(spec["checked_steps"])
    marks.append(("checked steps", time.perf_counter()))
    # Two more steps, timed, set the window's length in steps.
    _sync(dev)
    t = time.perf_counter()
    for _ in range(2):
        prog.step()
    _sync(dev)
    per_step = (time.perf_counter() - t) / 2
    marks.append(("warm-up", time.perf_counter()))
    n = _agree(max(2, round(seconds / per_step)), world, dev)
    if world > 1:
        dist.barrier()
    setup_end = time.time()

    t0 = time.perf_counter()
    losses = [prog.step() for _ in range(n)]
    _sync(dev)
    window_s = time.perf_counter() - t0
    marks.append(("window", time.perf_counter()))
    failed = int((~torch.isfinite(torch.stack(losses).float())).sum())

    summary = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            with prog.traced(), torch.profiler.record_function(
                    trace_mod.WINDOW_RANGE):
                for _ in range(spec["trace_steps"]):
                    prog.step()
                _sync(dev)
        marks.append(("traced steps", time.perf_counter()))
        summary = trace_mod.summarize(prof, range_names)
        del prof
        marks.append(("trace read", time.perf_counter()))

    report = {
        "rank": rank, "world": world, "setup_end": setup_end,
        "window": {"steps": n, "seconds": window_s},
        "work_per_step": cell.runner.work_per_step(cell.config, cell.traffic),
        "failed": failed, "trace": summary,
        "trace_steps": spec["trace_steps"] if trace else 0,
        "device_kind": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else 0),
    }
    prog.close()
    del prog, losses
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if rank == 0:
        ref = cell.runner.reference(cell.config, cell.traffic, training, seed,
                                    world, spec["checked_steps"], dev)
        marks.append(("reference", time.perf_counter()))
        ok, compared, detail = compare.judge(readings, ref, spec["limits"])
        report["judged"] = {"correct": ok, "compared": compared,
                            "detail": detail, "readings": readings,
                            "reference": ref}
    report["phases_s"] = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
    print(f"portbench: rank {rank}: window {n} steps in {window_s:.3f} s; "
          + ", ".join(f"{k} {v:.2f} s" for k, v in report["phases_s"].items()),
          file=sys.stderr, flush=True)
    return report


class Run:
    """What the metric readers read: the cell and every rank's report."""

    def __init__(self, cell: Cell, reports: list[dict], t_process: float):
        self.cell = cell
        self.reports = sorted(reports, key=lambda r: r["rank"])
        self.t_process = t_process
        self.chips = len(self.reports)
        self.config, self.traffic = cell.config, cell.traffic

    @property
    def window_s(self) -> float:
        """The measured window: the longest rank's."""
        return max(r["window"]["seconds"] for r in self.reports)

    @property
    def steps(self) -> int:
        return self.reports[0]["window"]["steps"]

    @property
    def work(self) -> float:
        """Tokens or images trained on in the window, over every rank."""
        return sum(r["window"]["steps"] * r["work_per_step"]
                   for r in self.reports)

    @property
    def traces(self) -> list[dict]:
        return [r["trace"] for r in self.reports if r["trace"] is not None]

    @property
    def trace_steps(self) -> int:
        return self.reports[0]["trace_steps"]


def range_names(cell: Cell) -> list[str]:
    """The ranges that the cell's per-layer readers ask the trace for."""
    names: list[str] = []
    for m in cell.per_layer:
        names.extend(getattr(reader(m["name"]), "RANGES", ()))
    return sorted(set(names))


def _finite(x):
    """JSON has no infinity: a gap that is not finite prints as text."""
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def result_line(cell: Cell, reports: list[dict], t_process: float,
                trace: bool) -> dict:
    run = Run(cell, reports, t_process)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    r0 = run.reports[0]
    judged = r0["judged"]
    failed = sum(r["failed"] for r in run.reports)
    device = {"platform": "gpu" if r0["device_kind"] != "cpu" else "cpu",
              "kind": r0["device_kind"], "count": run.chips,
              "memory_peak_bytes": max(r["memory_peak_bytes"]
                                       for r in run.reports)}
    line = {"correct": bool(judged["correct"] and failed == 0),
            "attempted": run.steps, "failed": failed, "metrics": metrics,
            "device": device}
    if trace:
        from portbench import trace as trace_mod

        device["busy_s"] = sum(trace_mod.busy_us(t) for t in run.traces) \
            / len(run.traces) / 1e6
        device["window_s"] = sum(trace_mod.window_us(t) for t in run.traces) \
            / len(run.traces) / 1e6
        first = run.traces[0]
        line["breakdown"] = {"device_ops": first["device_ops"],
                             "idle_gaps": first["idle_gaps"]}
    line["compared"] = judged["compared"]
    return _finite(line)


def set_cache_dirs() -> None:
    """Fixed cache directories inside the checkout for every compiler a
    run could start (the port's nvcc libraries already live in
    ``build/horovod_tpu_torch``); worker processes inherit them."""
    base = ROOT / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(module: str, argv: list[str], chips: int) -> list[dict]:
    """Run ``python -m <module> <argv> --rank r --report <file>`` once per
    card, as rank r of a world of ``chips`` on this host, and return the
    JSON reports in rank order.  The workers' standard output goes to this
    process's standard error; a worker that fails ends the others."""
    out = tempfile.mkdtemp(prefix="portbench-")
    port, control = _free_port(), _free_port()
    procs = []
    try:
        for r in range(chips):
            # The launcher's part, as Horovod's launcher does it: the
            # rendezvous, and the eager engine's control plane on rank 0
            # (its native controller negotiates and fuses the buckets).
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(chips),
                       LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(chips),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       HVD_TORCH_CONTROLLER_TRANSPORT=f"tcp:127.0.0.1:{control}")
            cmd = [sys.executable, "-m", module, *argv, "--rank", str(r),
                   "--report", os.path.join(out, f"rank{r}.json")]
            procs.append(subprocess.Popen(cmd, env=env, stdout=sys.stderr))
        while True:
            codes = [p.poll() for p in procs]
            bad = [c for c in codes if c not in (None, 0)]
            if bad:
                raise RuntimeError(f"a worker of {module} exited with "
                                   f"{bad[0]}")
            if all(c == 0 for c in codes):
                break
            time.sleep(0.2)
        reports = []
        for r in range(chips):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                reports.append(json.load(f))
        return reports
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        shutil.rmtree(out, ignore_errors=True)
