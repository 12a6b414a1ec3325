"""Render and diff the port's device-telemetry reports in the terminal.

The port twin of ``tools/device_report.py``: the same reader, replaying
event logs through :mod:`horovod_tpu_torch.device_telemetry`.  The
``DeviceTelemetry`` plane (``HVD_TORCH_DEVICE_TELEMETRY=1``) publishes the
same report three ways; this tool reads any of them:

    python -m horovod_tpu_torch.tools.device_report http://127.0.0.1:9400
    python -m horovod_tpu_torch.tools.device_report events.jsonl
    python -m horovod_tpu_torch.tools.device_report device.json [--json]

A URL is scraped at its ``/device`` endpoint (appended when missing) —
the engine monitor serves one report, the router serves the fleet view
(each replica's report rendered in turn); a ``.jsonl`` source replays
the ``device.capture`` / ``device.tick`` / ``device.memory`` records of
the structured event log into an identical report via
:func:`horovod_tpu_torch.device_telemetry.report_from_events` (no wall
clock, so a crashed run diffs the same as a live scrape); anything else is a saved report JSON
— a prior ``--json`` dump, a raw ``/device`` body, or a full
``metrics_snapshot()`` (its ``"device"`` key is used).

Regression gate (gate #7 of ``horovod_tpu_torch.tools.perf_gate``):

    python -m horovod_tpu_torch.tools.device_report --compare old.json new.json \\
        [--threshold 10]

exits 1 when serving MFU / achieved FLOPs-per-second / overlap headroom
dropped more than ``--threshold`` percent, or per-tick host stall grew
more than ``--threshold`` percent AND ``--floor-ms`` absolute.  MFU
rows are skipped when either side has no honest peak (CPU rehearsals):
an unknown peak must never pass or fail a gate.
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.request

from horovod_tpu_torch.device_telemetry import report_from_events


def fetch_report(url: str) -> dict:
    """Scrape a live monitor's (or router's) ``/device`` endpoint."""
    if not url.rstrip("/").endswith("/device"):
        url = url.rstrip("/") + "/device"
    with urllib.request.urlopen(url, timeout=5) as resp:
        return json.loads(resp.read())


def load_report(source: str, window: int | None = None) -> dict:
    """Dispatch on the source shape: URL, event-log JSONL, or report
    JSON (accepts a bare report, a ``/device`` body — engine or router
    flavor — or a whole ``metrics_snapshot()`` dump)."""
    if source.startswith(("http://", "https://")):
        return fetch_report(source)
    if source.endswith(".jsonl"):
        events = []
        with open(source) as f:
            for line in f:
                try:
                    events.append(json.loads(line))
                except json.JSONDecodeError:
                    pass          # torn tail line of a live/crashed log
        return report_from_events(events, window=window)
    with open(source) as f:
        data = json.load(f)
    if "win" in data or "replicas" in data:
        return data
    if "device" in data:           # a metrics_snapshot() dump
        return data["device"]
    raise SystemExit(f"{source}: neither a device report nor a "
                     f"snapshot with a 'device' key")


def _render_one(report: dict, name: str | None = None) -> list[str]:
    peak = report.get("peak_flops")
    head = (f"device report{f' [{name}]' if name else ''}: "
            f"{report['platform']}/{report['device_kind']} "
            f"x{report['n_devices']}, peak="
            + (f"{peak:.3e} FLOP/s ({report.get('peak_flops_source')})"
               if peak else "unknown (no MFU)"))
    lines = [head,
             f"{'program':12s} {'dispatches':>10s} {'MFLOPs':>10s} "
             f"{'MB accessed':>12s} {'compile ms':>11s}"]
    for prog, row in report.get("programs", {}).items():
        lines.append(
            f"{prog:12s} {row['dispatches']:10d} "
            f"{row['flops'] / 1e6:10.3f} "
            f"{row['bytes_accessed'] / 1e6:12.3f} "
            f"{row['compile_s'] * 1e3:11.2f}")
    lines.append(
        f"compiles={report['compiles']} "
        f"total={report['compile_total_s'] * 1e3:.1f} ms  "
        f"retraces={report['retraces']} "
        f"(est cost {report['retrace_compile_est_s'] * 1e3:.1f} ms)")
    w = report["win"]
    mfu = w["mfu"]
    lines.append(
        f"window ({w['n']} ticks, {w['elapsed_s'] * 1e3:.1f} ms): "
        f"mfu={'n/a' if mfu is None else f'{mfu:.4f}'} "
        f"flops/s={w['flops_per_s']:.3e} "
        f"intensity={w['arithmetic_intensity']:.2f} FLOP/B")
    lines.append(
        f"  sync={w['sync_s'] * 1e3:.2f} ms "
        f"(compute_est={w['compute_est_s'] * 1e3:.2f} "
        f"host_stall={w['host_stall_s'] * 1e3:.2f}) "
        f"headroom={w['overlap_headroom_pct']:.1f}% "
        f"h2d={w['h2d_bytes']} B d2h={w['d2h_bytes']} B")
    mem = report.get("memory")
    if mem and mem.get("available"):
        lines.append(
            f"  hbm: in_use={mem['bytes_in_use']} "
            f"peak={mem['peak_bytes_in_use']} "
            f"limit={mem['bytes_limit']}")
        rec = report.get("reconciliation")
        if rec:
            lines.append(
                f"  reconciliation: params={rec['param_bytes']} "
                f"kv={rec['kv_total_bytes']} "
                f"framework_overhead={rec['framework_overhead_bytes']}")
    else:
        lines.append("  hbm: backend reports no memory_stats")
    return lines


def render(report: dict) -> str:
    """One engine report, or the router's fleet view replica by
    replica with its summary line."""
    if "replicas" in report:        # router fleet flavor
        lines: list[str] = []
        for name in sorted(report["replicas"]):
            lines += _render_one(report["replicas"][name], name)
        s = report.get("summary", {})
        fleet = (f"fleet: reporting={s.get('n_reporting', 0)} "
                 f"flops/s={s.get('fleet_flops_per_s', 0.0):.3e}")
        if "mfu_mean" in s:
            fleet += (f" mfu min/mean/max={s['mfu_min']:.4f}/"
                      f"{s['mfu_mean']:.4f}/{s['mfu_max']:.4f}")
        without = report.get("without_telemetry")
        if without:
            fleet += f" without_telemetry={','.join(without)}"
        lines.append(fleet)
        return "\n".join(lines)
    return "\n".join(_render_one(report))


#: Gate axes: (key, higher_is_better, absolute floor in the metric's
#: own unit below which a percent move is noise, extractor).
_GATE_AXES = (
    ("mfu", True, 1e-4,
     lambda r: r["win"]["mfu"]),
    ("flops_per_s", True, 1.0,
     lambda r: r["win"]["flops_per_s"]),
    ("overlap_headroom_pct", True, 0.1,
     lambda r: r["win"]["overlap_headroom_pct"]),
    ("host_stall_ms_per_tick", False, None,   # floor: --floor-ms
     lambda r: (r["win"]["host_stall_s"] / r["win"]["n"] * 1e3
                if r["win"]["n"] else 0.0)),
)


def compare_reports(old: dict, new: dict, threshold_pct: float = 10.0,
                    floor_ms: float = 0.05) -> list[dict]:
    """Scalar-axis diff of two device reports.  Higher-is-better axes
    (MFU, achieved FLOPs/s, overlap headroom) REGRESS on a drop past
    ``threshold_pct`` and their noise floor; host stall regresses on
    growth past the threshold AND ``floor_ms``.  The MFU row is
    emitted only when BOTH sides carry an honest peak — one unknown
    side makes the axis unjudgeable, never a pass or a fail."""
    rows = []
    for key, higher_better, floor, get in _GATE_AXES:
        try:
            o, n = get(old), get(new)
        except (KeyError, TypeError):
            continue
        if o is None or n is None:
            continue                # no honest peak on one side
        if floor is None:
            floor = floor_ms
        bad = (o - n) if higher_better else (n - o)
        pct = bad / o * 100.0 if o else (float("inf") if bad > 0
                                         else 0.0)
        rows.append({
            "metric": key, "old": o, "new": n, "delta": n - o,
            "delta_pct": (n - o) / o * 100.0 if o else 0.0,
            "regressed": pct > threshold_pct and bad > floor,
        })
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("source", nargs="?",
                    help="monitor/router URL, event-log .jsonl, or "
                         "report JSON")
    ap.add_argument("--compare", nargs=2, metavar=("OLD", "NEW"),
                    help="diff two report sources; exit 1 on regression")
    ap.add_argument("--threshold", type=float, default=10.0,
                    help="regression threshold in percent (default 10)")
    ap.add_argument("--floor-ms", type=float, default=0.05,
                    help="absolute host-stall growth floor in ms below "
                         "which a percent regression is ignored")
    ap.add_argument("--window", type=int, default=None,
                    help="for .jsonl replay: use only the last N ticks")
    ap.add_argument("--json", action="store_true",
                    help="dump the report (or the comparison rows) as "
                         "JSON")
    args = ap.parse_args(argv)

    if bool(args.source) == bool(args.compare):
        ap.error("give exactly one of: a source, or --compare OLD NEW")

    if args.compare:
        old = load_report(args.compare[0], window=args.window)
        new = load_report(args.compare[1], window=args.window)
        rows = compare_reports(new=new, old=old,
                               threshold_pct=args.threshold,
                               floor_ms=args.floor_ms)
        if args.json:
            print(json.dumps(rows, indent=2))
        else:
            print(f"{'metric':24s} {'old':>12s} {'new':>12s} "
                  f"{'pct':>8s}")
            for r in rows:
                flag = "  << REGRESSED" if r["regressed"] else ""
                print(f"{r['metric']:24s} {r['old']:12.4g} "
                      f"{r['new']:12.4g} "
                      f"{r['delta_pct']:+7.1f}%{flag}")
        return 1 if any(r["regressed"] for r in rows) else 0

    report = load_report(args.source, window=args.window)
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
        return 0
    print(render(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
