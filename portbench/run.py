"""Run one cell of the port's benchmark and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  A one-chip cell runs in this process, a
world of one as ``hvd.init()`` alone makes it.  A four-chip cell starts
one worker process per card (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` 127.0.0.1 and a free
``MASTER_PORT``); each writes its report to a temporary directory and
this process reads them and prints the line.  The last line of standard
output is the result; the numbers compared with the reference are also
the last lines of standard error.
"""

from __future__ import annotations

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # A four-chip cell's workers: their rank and where the report goes.
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--report", default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _refuse_jax(where: str) -> None:
    from portbench import harness

    found = harness.banned_modules()
    if found:
        print(f"portbench: {where} loaded {found}: the benchmark runs the "
              f"PyTorch port alone", file=sys.stderr)
        sys.exit(3)


def main(argv=None) -> int:
    args = _args(argv)
    from portbench import harness

    harness.set_cache_dirs()
    cell = harness.Cell(args.workload)
    if args.rank is not None:                         # a four-chip worker
        report = harness.run_rank(cell, args.seed, args.seconds,
                                  bool(args.trace),
                                  range_names=harness.range_names(cell))
        _refuse_jax(f"rank {args.rank}")
        with open(args.report, "w") as f:
            json.dump(report, f)
        return 0

    import torch

    chips = cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if chips == 1:
        reports = [harness.run_rank(cell, args.seed, args.seconds,
                                    bool(args.trace),
                                    range_names=harness.range_names(cell))]
    else:
        reports = harness.launch(
            "portbench.run", ["--workload", args.workload,
                              "--seed", str(args.seed),
                              "--seconds", str(args.seconds),
                              "--trace", str(args.trace)], chips)
    _refuse_jax("the process that prints the result")
    line = harness.result_line(cell, reports, T_PROCESS, bool(args.trace))
    for name, c in line["compared"].items():
        print(f"compared {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
