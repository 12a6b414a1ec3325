"""The readings a cell's limits are set from, on the chip, in one process.

    python3 -m portbench.calibrate --workload <cell> --first-seed <n> \\
        [--seeds 12] [--control 3] [--faults 3] [--out <file.json>]

For each seed the program's first steps are read as a run reads them
(``Program.first_steps``), the plain reference is run once, and the gaps
between them are taken (:mod:`portbench.compare`).  On the first
``--control`` seeds the control (the reference in fp8,
:mod:`portbench.reference.lowp`) is read against the same reference, and
on the first ``--faults`` seeds each fault of the runner's ``FAULTS``
(the program broken underneath).  A fault that leaves the state unchanged
reads 1 on both leaf numbers by their definition and is not run.

The summary gives, for each number, the lower reading (the largest of
the sound seeds), the upper one (the least of the control's and of each
fault's that reads at least ten times the lower one; the control counts
from three times) and a limit between them, nearer the upper one in
ratio.  Where the control would fail no number under those limits, the
number on which it reads farthest above the lower one takes its limit
between the lower one and the control's least.  A four-chip cell runs
one worker per card.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from portbench import compare, harness


def _free(dev) -> None:
    import torch

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _program(cell, seed, fault, device):
    prog = cell.runner.Program(cell.config, cell.traffic,
                               cell.config["training"], seed, device=device,
                               fault=fault)
    dev = prog.dev
    readings = prog.first_steps(cell.spec["checked_steps"])
    rank, world = prog.rank, prog.world
    prog.close()
    del prog
    _free(dev)
    return readings, dev, rank, world


def calibrate_rank(cell, seeds, n_control: int, n_faults: int,
                   device=None) -> dict:
    """This rank's part: the runs of every seed; on rank 0, the gaps."""
    records = []
    for i, seed in enumerate(seeds):
        t = time.perf_counter()
        kinds = [None] + (list(cell.runner.FAULTS) if i < n_faults else [])
        got = {}
        for fault in kinds:
            if fault == "no_exchange" and cell.chips == 1:
                continue
            got[fault or "program"], dev, rank, world = _program(
                cell, seed, fault, device)
        t_prog = time.perf_counter() - t
        if rank != 0:
            continue
        args = (cell.config, cell.traffic, cell.config["training"], seed,
                world, cell.spec["checked_steps"], dev)
        t = time.perf_counter()
        ref = cell.runner.reference(*args)
        t_ref = time.perf_counter() - t
        gaps = {k: compare.readings_gaps(r, ref) for k, r in got.items()}
        if i < n_control:
            got["control"] = cell.runner.reference(*args, lowp=True)
            gaps["control"] = compare.readings_gaps(got["control"], ref)
        _free(dev)
        records.append({"seed": seed, "gaps": gaps, "program_s": t_prog,
                        "reference_s": t_ref, "reference": ref,
                        "readings": got})
        print(f"calibrate {cell.name} seed {seed}: " + json.dumps(
            {k: {n: g[n] for n in compare.NUMBERS} for k, g in gaps.items()}),
            file=sys.stderr, flush=True)
    return {"rank": 0 if records else 1, "records": records}


def summarize(records: list[dict]) -> dict:
    """Lower and upper readings of each number, and a limit between."""
    out = {}
    for n in compare.NUMBERS:
        sound = [r["gaps"]["program"][n] for r in records]
        lower = max(sound)
        reads = {}
        for r in records:
            for kind, g in r["gaps"].items():
                if kind != "program":
                    reads.setdefault(kind, []).append(g[n])
        if n in ("grad_gap", "change_gap"):
            reads["unchanged"] = [1.0]
        least = {k: min(v) for k, v in reads.items()}
        need = {"control": 3, "unchanged": 3}
        upper_from = {k: v for k, v in least.items()
                      if v >= need.get(k, 10) * lower}
        upper = min(upper_from.values()) if upper_from else None
        out[n] = {"lower": lower, "sound": sound, "least": least,
                  "upper": upper,
                  "upper_from": (min(upper_from, key=upper_from.get)
                                 if upper_from else None),
                  "limit": (lower ** 0.4 * upper ** 0.6
                            if upper is not None else None)}
    # The control has to fail one number.  Where it fails none under
    # those limits, the number on which it reads farthest above the lower
    # takes its limit between the lower and the control's least instead.
    control = {n: o["least"]["control"] for n, o in out.items()
               if "control" in o["least"]}
    if control and not any(o["limit"] is not None and control[n] > o["limit"]
                           for n, o in out.items() if n in control):
        n = max(control, key=lambda n: control[n] / out[n]["lower"])
        if control[n] > out[n]["lower"]:
            out[n]["limit"] = out[n]["lower"] ** 0.4 * control[n] ** 0.6
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--first-seed", type=int, required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--out", default=None)
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--report", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    harness.set_cache_dirs()
    cell = harness.Cell(args.workload)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    if args.rank is not None:
        report = calibrate_rank(cell, seeds, args.control, args.faults)
        with open(args.report, "w") as f:
            json.dump(report, f)
        return 0
    if cell.chips == 1:
        reports = [calibrate_rank(cell, seeds, args.control, args.faults)]
    else:
        reports = harness.launch(
            "portbench.calibrate",
            ["--workload", args.workload, "--first-seed",
             str(args.first_seed), "--seeds", str(args.seeds), "--control",
             str(args.control), "--faults", str(args.faults)], cell.chips)
    records = next(r["records"] for r in reports if r["rank"] == 0)
    result = {"workload": args.workload, "records": records,
              "summary": summarize(records)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result["summary"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
