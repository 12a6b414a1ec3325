"""Run seeded chaos campaigns against an in-process serving fleet of the
port's engines (the port twin of ``tools/chaos_run.py``).

One campaign (the CI smoke shape — a storm over the engine fault
sites plus a replica kill, checked against the recovery oracles), on
``llama_tiny`` in f32 with random weights from a fixed seed, on the card
unless ``--device cpu`` is given:

    python -m horovod_tpu_torch.tools.chaos_run --seed 7 [--device cpu]

Soak mode keeps launching consecutive-seed campaigns until the
wall-clock budget runs out:

    python -m horovod_tpu_torch.tools.chaos_run --soak 300

Regression gate (the ``profile_report.py --compare`` contract — saved
report JSONs in, exit 1 when recovery got worse):

    python -m horovod_tpu_torch.tools.chaos_run --compare old.json new.json \\
        [--threshold 0.1]

Exit status: 0 when every oracle held (or no regression in compare
mode), 1 otherwise — wire it straight into CI.  ``--json PATH`` saves
the report for a later ``--compare``.
"""

from __future__ import annotations

import argparse
import json
import sys


def _build_world(device: "str | None"):
    import torch

    from horovod_tpu_torch import resolve_device
    from horovod_tpu_torch.models import llama

    cfg = llama.llama_tiny(dtype=torch.float32)
    params = llama.init_params(cfg, 11, device=resolve_device(device))
    return params, cfg


def _print_report(report: dict) -> None:
    oracles = report.get("oracles", {})
    for name, held in sorted(oracles.items()):
        print(f"  {'PASS' if held else 'FAIL'}  {name}")
    for key in ("seed", "campaigns", "n_requests", "faults_fired",
                "kills_fired", "respawns", "failovers", "ok_fraction",
                "min_ok_fraction", "leaked_tickets", "leaked_blocks"):
        if key in report:
            print(f"  {key}: {report[key]}")
    if report.get("failures"):
        print(f"  failing seeds: "
              f"{[f['seed'] for f in report['failures']]}")
    print(f"chaos: {'OK' if report.get('ok') else 'FAILED'}")


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(
        description="Seeded chaos campaigns over the serving fleet.")
    ap.add_argument("--seed", type=int, default=0,
                    help="campaign seed (default 0)")
    ap.add_argument("--soak", type=float, metavar="SECONDS",
                    help="run consecutive-seed campaigns for this "
                         "many wall-clock seconds")
    ap.add_argument("--compare", nargs=2, metavar=("OLD", "NEW"),
                    help="diff two saved report JSONs instead of "
                         "running; exit 1 on regression")
    ap.add_argument("--threshold", type=float, default=0.1,
                    help="--compare: max tolerated OK-fraction drop "
                         "(absolute, default 0.1)")
    ap.add_argument("--json", metavar="PATH",
                    help="write the report JSON here")
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--waves", type=int, default=4)
    ap.add_argument("--faults", type=int, default=6,
                    help="storm rules per campaign (default 6)")
    ap.add_argument("--kills", type=int, default=1,
                    help="replica kills per campaign (default 1)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    if args.compare:
        with open(args.compare[0]) as f:
            old = json.load(f)
        with open(args.compare[1]) as f:
            new = json.load(f)
        from horovod_tpu_torch.chaos import compare_campaigns
        ok, problems = compare_campaigns(old, new,
                                         threshold=args.threshold)
        for p in problems:
            print(f"REGRESSION: {p}")
        print(f"chaos compare: {'OK' if ok else 'FAILED'}")
        return 0 if ok else 1

    from horovod_tpu_torch.chaos import run_campaign, soak

    params, cfg = _build_world(args.device)
    kw = dict(n_replicas=args.replicas, waves=args.waves,
              n_faults=args.faults, n_kills=args.kills)
    if args.soak:
        report = soak(params, cfg, seconds=args.soak,
                      start_seed=args.seed, **kw)
    else:
        report = run_campaign(params, cfg, seed=args.seed, **kw)
    _print_report(report)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
        print(f"report written to {args.json}")
    return 0 if report.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
