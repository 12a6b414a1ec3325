"""Run a fleet-scale simulation campaign: hundreds of simulated
replicas under chaos through the port's real router / supervisor /
autoscaler / alert control plane, on virtual time (the port twin of
``tools/simfleet_run.py``; host only, no card).

One campaign (the tier-1 acceptance shape — 200 replicas, ~100k
virtual requests, crash storm + partition wave + straggler epidemic +
KV-exhaustion ramp + scripted epoch bumps, all invariant oracles):

    python -m horovod_tpu_torch.tools.simfleet_run --seed 7

Scale overrides (a laptop-quick smoke, or a bigger soak):

    python -m horovod_tpu_torch.tools.simfleet_run --replicas 40 --requests 5000

Regression gate (saved report JSONs in, exit 1 when an oracle that
held before broke, or delivery got worse):

    python -m horovod_tpu_torch.tools.simfleet_run --compare old.json new.json \\
        [--threshold 0.1]

Exit status: 0 when every oracle held (or no regression in compare
mode), 1 otherwise.  ``--json PATH`` saves the report for a later
``--compare``.
"""

from __future__ import annotations

import argparse
import json
import sys


def _print_report(report: dict) -> None:
    oracles = report.get("oracles", {})
    for name, held in sorted(oracles.items()):
        print(f"  {'PASS' if held else 'FAIL'}  {name}")
    for key in ("seed", "n_replicas", "n_requests", "delivered",
                "ok_fraction", "failovers", "replica_deaths",
                "respawns", "epoch", "keyed", "journal_dedups",
                "shadow_evictions", "virtual_s", "wall_s"):
        if key in report:
            print(f"  {key}: {report[key]}")
    alerts = report.get("alerts", {})
    if alerts:
        print(f"  alerts fired: {alerts.get('fired')}"
              f" unresolved: {alerts.get('unresolved')}")
    print(f"simfleet: {'OK' if report.get('ok') else 'FAILED'}")


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(
        description="Fleet-scale simulated chaos campaigns through "
                    "the real serving control plane.")
    ap.add_argument("--seed", type=int, default=None,
                    help="campaign seed (default HVD_TORCH_SIM_SEED)")
    ap.add_argument("--replicas", type=int, default=None,
                    help="simulated fleet size "
                         "(default HVD_TORCH_SIM_REPLICAS)")
    ap.add_argument("--requests", type=int, default=None,
                    help="offered virtual request count "
                         "(default HVD_TORCH_SIM_REQUESTS)")
    ap.add_argument("--no-poll-scaling", action="store_true",
                    help="skip the poll-cost scaling measurement "
                         "(and its oracle)")
    ap.add_argument("--compare", nargs=2, metavar=("OLD", "NEW"),
                    help="diff two saved report JSONs instead of "
                         "running; exit 1 on regression")
    ap.add_argument("--threshold", type=float, default=0.1,
                    help="--compare: max tolerated OK-fraction drop "
                         "(absolute, default 0.1)")
    ap.add_argument("--json", metavar="PATH",
                    help="write the report JSON here")
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
        print(f"simfleet compare: {'OK' if ok else 'FAILED'}")
        return 0 if ok else 1

    from horovod_tpu_torch.simfleet import run_sim_campaign

    report = run_sim_campaign(
        seed=args.seed, n_replicas=args.replicas,
        n_requests=args.requests,
        poll_scaling=not args.no_poll_scaling)
    _print_report(report)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
        print(f"report written to {args.json}")
    return 0 if report.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
