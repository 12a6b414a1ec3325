"""One exit-coded perf-CI verdict over every regression gate (the port
twin of ``tools/perf_gate.py``: its chaos and simfleet gates compare with
:func:`horovod_tpu_torch.chaos.compare_campaigns`, and its trace and
device gates read through the port's ``trace_report`` and
``device_report`` twins; the other readers are the repo's stdlib tools).

The repo grew seven ``--compare`` gates, one per observability plane:
``profile_report`` (per-phase tick time), ``load_report`` (saturation
knee + p99 TTFT + attribution coverage), ``chaos_run`` (recovery
oracles + OK fraction), ``health_report`` (alert hygiene),
``simfleet_run`` (fleet-scale control-plane campaigns),
``trace_report`` (critical-path composition), and ``device_report``
(serving MFU / achieved FLOPs-per-second / overlap headroom / host
stall).  This tool folds any subset of them into ONE verdict table and
ONE exit code — the shape a CI job wants:

    python -m horovod_tpu_torch.tools.perf_gate \\
        --profile old_prof.json new_prof.json \\
        --load old_sweep.json new_sweep.json \\
        --chaos old_chaos.json new_chaos.json \\
        --health old_health.json new_health.json \\
        --simfleet old_sim.json new_sim.json \\
        --trace old_trace.json new_trace.json \\
        --device old_dev.json new_dev.json \\
        [--threshold 10] [--json]

Each flag takes the OLD and NEW saved report JSONs its tool's own
``--json`` (or ``--compare`` contract) produces; omitted gates are
skipped.  Exit 1 when ANY supplied gate regressed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

#: The repo's stdlib report readers (profile, load, health) import by name.
TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tools")
if TOOLS not in sys.path:
    sys.path.append(TOOLS)


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _rows_verdict(rows: list[dict]) -> tuple[bool, list[str]]:
    """(ok, problems) from a row-list compare (profile/load/trace)."""
    bad = [r for r in rows if r.get("regressed")]
    return (not bad,
            [f"{r.get('metric', r.get('phase', '?'))}: "
             f"{r.get('delta_pct', 0.0):+.1f}%" for r in bad])


def _gate_profile(old: str, new: str, threshold: float):
    import profile_report
    return _rows_verdict(profile_report.compare_reports(
        profile_report.load_report(old), profile_report.load_report(new),
        threshold_pct=threshold))


def _gate_load(old: str, new: str, threshold: float):
    import load_report
    return _rows_verdict(load_report.compare_reports(
        load_report.load_report(old), load_report.load_report(new),
        threshold_pct=threshold))


def _gate_trace(old: str, new: str, threshold: float):
    from horovod_tpu_torch.tools import trace_report
    return _rows_verdict(trace_report.compare_reports(
        trace_report.load_report(old), trace_report.load_report(new),
        threshold_pct=threshold))


def _gate_device(old: str, new: str, threshold: float):
    from horovod_tpu_torch.tools import device_report
    return _rows_verdict(device_report.compare_reports(
        device_report.load_report(old), device_report.load_report(new),
        threshold_pct=threshold))


def _gate_chaos(old: str, new: str, threshold: float):
    from horovod_tpu_torch.chaos import compare_campaigns
    return compare_campaigns(_load(old), _load(new),
                             threshold=threshold / 100.0)


def _gate_simfleet(old: str, new: str, threshold: float):
    from horovod_tpu_torch.chaos import compare_campaigns
    return compare_campaigns(_load(old), _load(new),
                             threshold=threshold / 100.0)


def _gate_health(old: str, new: str, threshold: float):
    import health_report
    return health_report.compare(_load(old), _load(new))


#: Gate name -> compare runner; each returns ``(ok, problems)``.
GATES = {
    "profile": _gate_profile,
    "load": _gate_load,
    "chaos": _gate_chaos,
    "health": _gate_health,
    "simfleet": _gate_simfleet,
    "trace": _gate_trace,
    "device": _gate_device,
}


def run_gates(pairs: dict, threshold: float = 10.0) -> dict:
    """Run every supplied gate; returns the verdict dict the CLI
    renders (``gates`` rows + overall ``ok``).  A gate whose compare
    ITSELF breaks (unreadable report, schema drift) counts as
    regressed — a gate that cannot run must not pass."""
    gates = []
    for name, (old, new) in pairs.items():
        try:
            ok, problems = GATES[name](old, new, threshold)
        except SystemExit as exc:
            ok, problems = False, [f"compare unusable: {exc}"]
        except Exception as exc:  # noqa: BLE001 — verdict, not traceback
            ok, problems = False, [f"compare broke: {exc!r}"]
        gates.append({"gate": name, "ok": bool(ok),
                      "problems": list(problems)})
    return {"gates": gates,
            "ok": all(g["ok"] for g in gates),
            "n_regressed": sum(not g["ok"] for g in gates)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for name in GATES:
        ap.add_argument(f"--{name}", nargs=2, metavar=("OLD", "NEW"),
                        help=f"{name} gate: old/new saved report JSONs")
    ap.add_argument("--threshold", type=float, default=10.0,
                    help="regression threshold in percent (chaos/"
                         "simfleet take it as an absolute fraction "
                         "/100; default 10)")
    ap.add_argument("--json", action="store_true",
                    help="dump the verdict as JSON")
    args = ap.parse_args(argv)

    pairs = {name: getattr(args, name) for name in GATES
             if getattr(args, name)}
    if not pairs:
        ap.error("supply at least one gate (--profile/--load/--chaos/"
                 "--health/--simfleet/--trace/--device OLD NEW)")
    verdict = run_gates(pairs, threshold=args.threshold)
    if args.json:
        print(json.dumps(verdict, indent=2))
    else:
        for g in verdict["gates"]:
            print(f"  {'PASS' if g['ok'] else 'FAIL'}  {g['gate']}")
            for p in g["problems"]:
                print(f"        REGRESSION: {p}")
        print(f"perf gate: {'OK' if verdict['ok'] else 'FAILED'} "
              f"({len(verdict['gates']) - verdict['n_regressed']}/"
              f"{len(verdict['gates'])} gates clean)")
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
