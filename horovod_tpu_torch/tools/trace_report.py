"""Reconstruct and render causal trace trees from the port's serving fleet.

The port twin of ``tools/trace_report.py``: the same reader over
:mod:`horovod_tpu_torch.tracing`.  The tracing plane persists ``trace.span`` / ``trace.span_open``
records in the rank-stamped JSONL event log (and serves recent closed
spans live on the router's and monitor's ``/traces`` endpoints).  This
tool folds those records back into per-request span forests:

    python -m horovod_tpu_torch.tools.trace_report events.jsonl [more.jsonl ...]
    python -m horovod_tpu_torch.tools.trace_report --scrape http://host:port
    python -m horovod_tpu_torch.tools.trace_report events.jsonl --trace <id>
    python -m horovod_tpu_torch.tools.trace_report events.jsonl --critical-path
    python -m horovod_tpu_torch.tools.trace_report events.jsonl \\
        --perfetto out.json [--timeline timeline.json]
    python -m horovod_tpu_torch.tools.trace_report events.jsonl --json

A multi-hop request renders as ONE tree: client → router.request →
replica.attempt (each failover replay a child of the attempt it
replaced) → serve.request → queue/prefill/decode, with the decode span
nesting the engine ticks it lived through when ``serve.profile_tick``
events ride the same log.  Damaged input degrades to labeled partial
trees — ``[orphan]`` when the parent record was torn away,
``[unclosed]`` when a crash ate the close — and never throws.

``--critical-path`` prints, per trace and fleet-aggregate, the blocking
chain whose spans tile the root's end-to-end time exactly.

Regression gate (fed from two ``--json`` report dumps):

    python -m horovod_tpu_torch.tools.trace_report --compare old.json new.json \\
        [--threshold 10]

exits 1 when the mean critical-path seconds per trace grew more than
``--threshold`` percent, or when any span name's share of fleet
critical-path time grew by more than ``--threshold`` percentage points
— the "decode got slower" vs "the queue ate the win" distinction.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from horovod_tpu_torch import tracing

#: Event kind carrying per-tick phase timings (horovod_tpu_torch.profiler);
#: used to nest engine ticks under the decode spans they served.
PROFILE_TICK_KIND = "serve.profile_tick"


def load_records(sources: list[str]) -> list[dict]:
    """All JSONL records across the given event logs (plus rotated
    ``.1`` generations), torn-line tolerant, oldest generation first."""
    out: list[dict] = []
    for src in sources:
        for p in (src + ".1", src):
            if p.endswith(".1") and not os.path.exists(p):
                continue
            with open(p) as f:
                for ln in f:
                    ln = ln.strip()
                    if not ln:
                        continue
                    try:
                        rec = json.loads(ln)
                    except json.JSONDecodeError:
                        continue          # torn line: dropped, labeled
                    if isinstance(rec, dict):
                        out.append(rec)
    return out


def scrape_records(base_url: str) -> list[dict]:
    """Live span records from a router's or monitor's ``/traces``."""
    import urllib.request
    url = base_url.rstrip("/") + "/traces"
    with urllib.request.urlopen(url, timeout=10) as resp:
        data = json.loads(resp.read().decode())
    return [r for r in data if isinstance(r, dict)]


def nest_ticks(forest: dict, records: list[dict]) -> int:
    """Attach synthetic ``serve.tick`` children under every
    ``serve.decode`` span from ``serve.profile_tick`` events on the
    same log: a tick at ``step`` covering ``[mono_s - tick_s, mono_s]``
    nests when its step lies in the decode span's
    ``[admit_step, terminal_step]`` and its interval overlaps.  Returns
    how many ticks were attached."""
    ticks = []
    for rec in records:
        if rec.get("kind") != PROFILE_TICK_KIND:
            continue
        step, mono, dt = rec.get("step"), rec.get("mono_s"), \
            rec.get("tick_s")
        if (isinstance(step, int) and isinstance(mono, (int, float))
                and isinstance(dt, (int, float))):
            ticks.append((step, float(mono) - float(dt), float(mono)))
    if not ticks:
        return 0
    n = 0
    for roots in forest.values():
        stack = list(roots)
        while stack:
            node = stack.pop()
            stack.extend(node["children"])
            if node["name"] != "serve.decode" or node["t1"] is None:
                continue
            a = node["attrs"]
            lo_s, hi_s = a.get("admit_step"), a.get("terminal_step")
            if not (isinstance(lo_s, int) and isinstance(hi_s, int)):
                continue
            for step, t0, t1 in ticks:
                if not (lo_s <= step <= hi_s):
                    continue
                if t1 <= node["t0"] or t0 >= node["t1"]:
                    continue
                node["children"].append({
                    "trace_id": node["trace_id"],
                    "span_id": f"tick:{step}",
                    "parent_id": node["span_id"],
                    "name": "serve.tick",
                    "t0": max(t0, node["t0"]),
                    "t1": min(t1, node["t1"]),
                    "attrs": {"step": step},
                    "unclosed": False, "orphan": False, "children": [],
                })
                n += 1
            node["children"].sort(key=lambda c: c["t0"])
    return n


def render_tree(node: dict, prefix: str = "", last: bool = True) -> list[str]:
    """One span subtree as box-drawing ASCII lines."""
    end = tracing.span_end(node)
    dur_ms = (end - node["t0"]) * 1e3
    labels = "".join(
        f" [{lab}]" for lab, on in (("orphan", node["orphan"]),
                                    ("unclosed", node["unclosed"])) if on)
    attrs = node["attrs"]
    extra = " ".join(f"{k}={attrs[k]}" for k in ("rid", "replica",
                                                 "status", "tenant")
                     if attrs.get(k) is not None)
    tee = "`- " if last else "|- "
    lines = [f"{prefix}{tee}{node['name']} {dur_ms:.3f}ms"
             f"{labels}{' ' + extra if extra else ''}"]
    ext = "   " if last else "|  "
    for i, ch in enumerate(node["children"]):
        lines.extend(render_tree(ch, prefix + ext,
                                 i == len(node["children"]) - 1))
    return lines


def _count(forest: dict, key: str) -> int:
    n = 0
    for roots in forest.values():
        stack = list(roots)
        while stack:
            node = stack.pop()
            stack.extend(node["children"])
            n += bool(node[key])
    return n


def build_report(records: list[dict], trace_id: str | None = None) -> dict:
    """Span forest + critical paths as one JSON-able report (the
    ``--json`` dump, and the ``--compare`` input)."""
    forest = tracing.build_forest(records)
    if trace_id is not None:
        forest = {t: r for t, r in forest.items()
                  if t.startswith(trace_id)}
    n_ticks = nest_ticks(forest, records)
    all_roots = [r for roots in forest.values() for r in roots]
    agg = tracing.aggregate_critical_paths(all_roots)
    traces = []
    for tid, roots in sorted(forest.items()):
        n_spans = 0
        stack = list(roots)
        while stack:
            node = stack.pop()
            stack.extend(node["children"])
            n_spans += 1
        dur = max((tracing.span_end(r) - r["t0"] for r in roots),
                  default=0.0)
        traces.append({"trace_id": tid, "n_roots": len(roots),
                       "n_spans": n_spans, "duration_s": dur,
                       "roots": [r["name"] for r in roots]})
    return {
        "n_records": len(records),
        "n_traces": len(forest),
        "n_spans": sum(t["n_spans"] for t in traces),
        "n_ticks_nested": n_ticks,
        "orphans": _count(forest, "orphan"),
        "unclosed": _count(forest, "unclosed"),
        "traces": traces,
        "critical_path": agg,
        "mean_critical_s": (agg["total_s"] / agg["n_traces"]
                            if agg["n_traces"] else 0.0),
        "_forest": forest,          # stripped before --json dump
    }


def render(report: dict, critical: bool = False) -> str:
    forest = report["_forest"]
    lines = [f"{report['n_traces']} traces, {report['n_spans']} spans "
             f"from {report['n_records']} records "
             f"({report['orphans']} orphan, {report['unclosed']} "
             f"unclosed, {report['n_ticks_nested']} ticks nested)"]
    for tid, roots in sorted(forest.items()):
        lines.append(f"trace {tid}")
        for i, root in enumerate(roots):
            lines.extend(render_tree(root, "", i == len(roots) - 1))
        if critical:
            for root in roots:
                path = tracing.critical_path(root)
                total = sum(e["self_s"] for e in path)
                lines.append(f"  critical path ({root['name']}, "
                             f"{total * 1e3:.3f}ms):")
                for e in path:
                    lines.append(f"    {e['name']:24s} "
                                 f"{e['self_s'] * 1e3:9.3f} ms")
    if critical:
        agg = report["critical_path"]
        lines.append(f"fleet critical-path breakdown over "
                     f"{agg['n_traces']} traces "
                     f"({agg['total_s'] * 1e3:.3f} ms total):")
        for name, slot in agg["by_name"].items():
            lines.append(f"  {name:24s} {slot['total_s'] * 1e3:9.3f} ms "
                         f"{slot['share'] * 100:6.1f}%  "
                         f"(n={slot['count']})")
    return "\n".join(lines)


def export_perfetto(report: dict, out_path: str,
                    timeline_path: str | None = None) -> int:
    """Chrome-trace JSON: one process lane per trace, spans as complete
    ('X') events at depth-stacked tids, merged with an existing engine
    timeline's events when one is given.  Trace spans are absolute
    monotonic microseconds; the timeline's own events keep their
    original (start-relative) stamps — Perfetto renders both tracks,
    alignment across the two is approximate by construction."""
    events: list[dict] = []
    if timeline_path is not None:
        events.extend(_read_timeline(timeline_path))
    forest = report["_forest"]
    t_min = min((r["t0"] for roots in forest.values() for r in roots),
                default=0.0)
    for i, (tid, roots) in enumerate(sorted(forest.items())):
        pid = 100000 + i
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": f"trace {tid[:12]}"}})
        stack = [(r, 0) for r in roots]
        while stack:
            node, depth = stack.pop()
            end = tracing.span_end(node)
            events.append({
                "name": node["name"], "ph": "X",
                "ts": (node["t0"] - t_min) * 1e6,
                "dur": max(end - node["t0"], 0.0) * 1e6,
                "pid": pid, "tid": depth,
                "args": {"span_id": node["span_id"],
                         "orphan": node["orphan"],
                         "unclosed": node["unclosed"],
                         **node["attrs"]},
            })
            stack.extend((ch, depth + 1) for ch in node["children"])
    with open(out_path, "w") as f:
        json.dump({"traceEvents": events}, f)
    return len(events)


def _read_timeline(path: str) -> list[dict]:
    """A Chrome-trace timeline file, tolerantly: a closed timeline is a
    JSON array; an unclosed one (writer still alive, or died) parses
    line-wise with trailing commas stripped."""
    with open(path) as f:
        text = f.read()
    try:
        data = json.loads(text)
        if isinstance(data, dict):
            data = data.get("traceEvents", [])
        return [e for e in data if isinstance(e, dict)]
    except json.JSONDecodeError:
        pass
    out = []
    for ln in text.splitlines():
        ln = ln.strip().rstrip(",").lstrip("[").rstrip("]")
        if not ln:
            continue
        try:
            e = json.loads(ln)
        except json.JSONDecodeError:
            continue
        if isinstance(e, dict):
            out.append(e)
    return out


def load_report(source: str) -> dict:
    """A saved ``--json`` report dump (or anything carrying the same
    ``critical_path`` aggregate)."""
    with open(source) as f:
        data = json.load(f)
    if "critical_path" not in data:
        raise SystemExit(f"{source}: not a trace report "
                         f"(no 'critical_path' key)")
    return data


def compare_reports(old: dict, new: dict,
                    threshold_pct: float = 10.0) -> list[dict]:
    """Critical-path composition diff rows.  REGRESSED when the mean
    critical-path seconds per trace grew more than ``threshold_pct``
    percent, or a span name's share of fleet critical-path time grew
    by more than ``threshold_pct`` percentage points."""
    rows = []
    o_mean = old.get("mean_critical_s", 0.0)
    n_mean = new.get("mean_critical_s", 0.0)
    pct = ((n_mean - o_mean) / o_mean * 100.0) if o_mean else 0.0
    rows.append({
        "metric": "mean_critical_ms",
        "old": o_mean * 1e3, "new": n_mean * 1e3, "delta_pct": pct,
        "regressed": pct > threshold_pct,
    })
    o_by = (old.get("critical_path") or {}).get("by_name", {})
    n_by = (new.get("critical_path") or {}).get("by_name", {})
    for name in sorted(set(o_by) | set(n_by)):
        o_share = (o_by.get(name) or {}).get("share", 0.0)
        n_share = (n_by.get(name) or {}).get("share", 0.0)
        delta_pts = (n_share - o_share) * 100.0
        rows.append({
            "metric": f"share:{name}",
            "old": o_share * 100.0, "new": n_share * 100.0,
            "delta_pct": delta_pts,
            "regressed": delta_pts > threshold_pct,
        })
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*",
                    help="JSONL event log path(s) with trace.span records")
    ap.add_argument("--scrape", metavar="URL",
                    help="fetch live spans from <URL>/traces instead")
    ap.add_argument("--trace", metavar="TRACE_ID",
                    help="only the trace(s) whose id starts with this")
    ap.add_argument("--critical-path", action="store_true",
                    help="per-trace + fleet-aggregate critical paths")
    ap.add_argument("--perfetto", metavar="OUT",
                    help="write a Chrome-trace JSON of the span forest")
    ap.add_argument("--timeline", metavar="FILE",
                    help="merge this engine timeline into --perfetto")
    ap.add_argument("--compare", nargs=2, metavar=("OLD", "NEW"),
                    help="diff two --json reports; exit 1 on regression")
    ap.add_argument("--threshold", type=float, default=10.0,
                    help="regression threshold (percent / share points)")
    ap.add_argument("--json", action="store_true",
                    help="dump the report (or comparison rows) as JSON")
    args = ap.parse_args(argv)

    if args.compare:
        if args.sources or args.scrape:
            ap.error("--compare takes no sources")
        rows = compare_reports(load_report(args.compare[0]),
                               load_report(args.compare[1]),
                               threshold_pct=args.threshold)
        if args.json:
            print(json.dumps(rows, indent=2))
        else:
            print(f"{'metric':30s} {'old':>10s} {'new':>10s} {'pct':>8s}")
            for r in rows:
                flag = "  << REGRESSED" if r["regressed"] else ""
                print(f"{r['metric']:30s} {r['old']:10.3f} "
                      f"{r['new']:10.3f} {r['delta_pct']:+7.1f}%{flag}")
        return 1 if any(r["regressed"] for r in rows) else 0

    if bool(args.sources) == bool(args.scrape):
        ap.error("give exactly one of: event-log source(s), or --scrape")
    records = (scrape_records(args.scrape) if args.scrape
               else load_records(args.sources))
    report = build_report(records, trace_id=args.trace)
    if args.perfetto:
        n = export_perfetto(report, args.perfetto,
                            timeline_path=args.timeline)
        print(f"wrote {n} events to {args.perfetto}", file=sys.stderr)
    if args.json:
        dump = {k: v for k, v in report.items() if k != "_forest"}
        print(json.dumps(dump, indent=2))
        return 0
    print(render(report, critical=args.critical_path))
    return 0


if __name__ == "__main__":
    sys.exit(main())
