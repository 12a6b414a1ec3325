"""Declarative alerting and capacity advice over the sampled series.

A copy of ``horovod_tpu/alerts.py`` for the PyTorch port (knob
``HVD_TORCH_ALERTS``); the rule table is the reference's, row for row.

The :class:`~horovod_tpu_torch.timeseries.MetricsSampler` remembers; this
module judges.  ``ALERT_RULES`` is the canonical rule table, a pure
literal like ``METRIC_HELP`` and ``ENV_KNOBS``, equal to the reference's
(``tests/test_torch_alerts.py``); ``python -m horovod_tpu_torch.alerts``
renders it as a Markdown table.

Rule kinds (the ``kind`` field picks the evaluator):

* ``burn_rate`` — the SRE-workbook multi-window method on the
  ``serve.goodput`` gauge (itself ``SLOWindow.goodput()`` from
  ``slo_report()``): the error-budget burn ``(1 - goodput) /
  (1 - objective)`` must exceed the threshold over BOTH the short and
  the long window before firing — the short window gives fast reset,
  the long window rejects blips.
* ``drift`` — a histogram's recent p99 against its own trailing
  baseline (the window just *before* the recent one), ratio-gated
  with an absolute floor so microsecond noise can't page.
* ``slope`` — least-squares slope of a gauge; fires when the
  projected time-to-zero falls inside the horizon (free-KV
  exhaustion).
* ``threshold`` — windowed mean of a gauge above a line (straggler
  skew).
* ``delta`` — a counter's windowed increment at or above a line
  (replica deaths, supervisor respawn flapping).

Every rule runs a firing/pending/resolved state machine with
hysteresis (``pending_s`` of sustained truth to fire, ``clear_s`` of
sustained falsehood to resolve) and dedup (a firing rule never
re-emits).  Transitions are stamped into the structured event log
(``alert.pending`` / ``alert.fire`` / ``alert.resolve`` /
``alert.cancel`` kinds) and onto ``alert.*`` counters.  A rule whose
metric has no samples in the window is *no-data*: it holds its current
state rather than flapping — a torn snapshot or a missing rank
degrades freshness, not correctness.

``time_scale`` multiplies every ``*_s`` rule parameter, so chaos
campaigns evaluate production-shaped rules against compressed
wall-clock storms without a parallel rule table.

:class:`CapacityAdvisor` folds the live series with the last
``serve_load_report.json`` knee (:mod:`~horovod_tpu_torch.loadgen`) into ``scale_up(n)`` /
``scale_down(n)`` / ``hold`` recommendation records with the evidence
attached — the input :class:`~horovod_tpu_torch.autoscaler.FleetAutoscaler`
wires to the supervisor's actuators.
"""

from __future__ import annotations

import collections
import json
import math
import os
import threading
import time
from typing import Any, Callable, Iterable, Sequence

from horovod_tpu_torch import metrics as metrics_mod
from horovod_tpu_torch import timeseries as timeseries_mod

# The canonical alert-rule table, a pure literal.  Every ``*_s`` field is in seconds and scales by the manager's
# ``time_scale``; ``pending_s`` 0 fires the moment the condition holds.
ALERT_RULES = (
    {"name": "goodput_burn_fast", "severity": "page",
     "kind": "burn_rate", "metric": "serve.goodput",
     "objective": 0.99, "burn": 10.0, "short_s": 30.0, "long_s": 300.0,
     "pending_s": 0.0, "clear_s": 60.0,
     "help": "Error budget burning >= 10x sustained over 30 s AND 5 m "
             "-- the fast page of the multi-window SLO pair."},
    {"name": "goodput_burn_slow", "severity": "ticket",
     "kind": "burn_rate", "metric": "serve.goodput",
     "objective": 0.99, "burn": 2.0, "short_s": 300.0, "long_s": 1800.0,
     "pending_s": 60.0, "clear_s": 300.0,
     "help": "Error budget burning >= 2x over 5 m AND 30 m -- the "
             "slow-leak ticket of the multi-window SLO pair."},
    {"name": "ttft_p99_drift", "severity": "ticket",
     "kind": "drift", "metric": "serve.ttft_s", "q": 0.99,
     "recent_s": 60.0, "baseline_s": 600.0, "ratio": 2.0,
     "floor": 0.001, "pending_s": 30.0, "clear_s": 120.0,
     "help": "Recent p99 TTFT at least 2x the trailing 10 m baseline "
             "(and above a 1 ms floor)."},
    {"name": "kv_exhaustion", "severity": "page",
     "kind": "slope", "metric": "kv.free_blocks",
     "window_s": 120.0, "horizon_s": 300.0,
     "pending_s": 0.0, "clear_s": 60.0,
     "help": "Free KV blocks trending to zero within 5 m at the "
             "current 2 m slope."},
    {"name": "straggler_skew", "severity": "ticket",
     "kind": "threshold", "metric": "hvd.step_skew_s",
     "above": 1.0, "window_s": 60.0,
     "pending_s": 30.0, "clear_s": 60.0,
     "help": "Mean slowest-minus-median rank step skew above 1 s "
             "over the last minute."},
    {"name": "replica_death", "severity": "page",
     "kind": "delta", "metric": "router.replica_deaths",
     "min_delta": 1.0, "window_s": 60.0,
     "pending_s": 0.0, "clear_s": 60.0,
     "help": "A replica transitioned healthy->dead within the last "
             "minute."},
    {"name": "replica_flap", "severity": "page",
     "kind": "delta", "metric": "supervisor.respawns",
     "min_delta": 3.0, "window_s": 300.0,
     "pending_s": 0.0, "clear_s": 300.0,
     "help": "Three or more supervisor respawns inside 5 m -- the "
             "fleet is flapping, not healing."},
    {"name": "autoscaler_flap", "severity": "ticket",
     "kind": "delta", "metric": "autoscaler.actions",
     "min_delta": 3.0, "window_s": 600.0,
     "pending_s": 0.0, "clear_s": 300.0,
     "help": "Three or more autoscaler actuations inside 10 m -- the "
             "fleet is resizing faster than demand can justify."},
    {"name": "device_hbm_exhaustion", "severity": "page",
     "kind": "threshold", "metric": "device.hbm_used_fraction",
     "above": 0.92, "window_s": 30.0,
     "pending_s": 10.0, "clear_s": 60.0,
     "help": "Device HBM use above 92% of bytes_limit sustained over "
             "30 s -- the next allocation spike OOMs the replica. "
             "Needs the device telemetry plane; CPU backends report "
             "no memory_stats, so the series is absent and the rule "
             "holds state."},
)


def rule_names() -> tuple[str, ...]:
    return tuple(r["name"] for r in ALERT_RULES)


def render_alert_table(rules: Sequence[dict] = ALERT_RULES) -> str:
    """The docs/observability.md alert table (paste verbatim on
    drift; regenerate with ``python -m horovod_tpu_torch.alerts``)."""
    lines = ["| Rule | Severity | Kind | Metric | Fire / clear | "
             "Meaning |", "| --- | --- | --- | --- | --- | --- |"]
    for r in rules:
        windows = ", ".join(
            f"{k}={r[k]:g}" for k in sorted(r)
            if k.endswith("_s") and k not in ("pending_s", "clear_s"))
        gate = (f"{windows}; pending {r['pending_s']:g} s / "
                f"clear {r['clear_s']:g} s")
        lines.append(
            f"| `{r['name']}` | {r['severity']} | `{r['kind']}` | "
            f"`{r['metric']}` | {gate} | {r['help']} |")
    return "\n".join(lines)


class AlertManager:
    """Evaluates ``ALERT_RULES`` over a sampler's series on ``tick()``.

    Ticked from the same loops as the sampler (engine step / router
    poll) — no threads.  ``eval_s`` gates evaluation cadence (default:
    the sampler's cadence); ``time_scale`` compresses every rule
    window for accelerated tests and chaos campaigns.
    """

    _GUARDED_BY_LOCK = ("_states", "_history", "_last_eval")

    def __init__(self, sampler: timeseries_mod.MetricsSampler, *,
                 rules: Sequence[dict] = ALERT_RULES,
                 registry: metrics_mod.MetricsRegistry | None = None,
                 eval_s: float | None = None, time_scale: float = 1.0,
                 history: int = 256,
                 clock: Callable[[], float] | None = None):
        self.sampler = sampler
        self.registry = (registry if registry is not None
                         else sampler.registry)
        self.rules = tuple(rules)
        self.eval_s = (eval_s if eval_s is not None
                       else sampler.sample_s)
        self.time_scale = time_scale
        self.clock = clock if clock is not None else sampler.clock
        self._lock = threading.Lock()
        self._states: dict[str, dict] = {
            r["name"]: {"state": "ok", "since": None, "last_true": None,
                        "value": None, "no_data": True,
                        "ever_true": False, "fired": 0, "resolved": 0}
            for r in self.rules}
        self._history: collections.deque[dict] = collections.deque(
            maxlen=history)
        self._last_eval = float("-inf")
        self._fired = self.registry.counter("alert.fired")
        self._resolved_c = self.registry.counter("alert.resolved")
        self._evals = self.registry.counter("alert.evals")
        self._firing_g = self.registry.gauge("alert.firing")
        self._pending_g = self.registry.gauge("alert.pending")

    def _s(self, rule: dict, key: str) -> float:
        return float(rule[key]) * self.time_scale

    # -- evaluation --------------------------------------------------------

    def tick(self, now: float | None = None) -> bool:
        now = self.clock() if now is None else now
        if now - self._last_eval < self.eval_s:
            return False
        self.evaluate(now)
        return True

    def evaluate(self, now: float | None = None) -> list[dict]:
        """Run every rule's condition and state machine; returns the
        transitions emitted this pass."""
        now = self.clock() if now is None else now
        transitions: list[dict] = []
        with self._lock:
            self._last_eval = now
            for rule in self.rules:
                cond, value = self._condition(rule, now)
                st = self._states[rule["name"]]
                st["no_data"] = cond is None
                if cond is None:
                    continue                   # hold state on no-data
                st["value"] = value
                if cond:
                    st["ever_true"] = True
                    st["last_true"] = now
                tr = self._advance(rule, st, cond, now)
                if tr is not None:
                    transitions.append(tr)
            firing = sum(1 for s in self._states.values()
                         if s["state"] == "firing")
            pending = sum(1 for s in self._states.values()
                          if s["state"] == "pending")
        self._evals.inc()
        self._firing_g.set(firing)
        self._pending_g.set(pending)
        for tr in transitions:
            if tr["to"] == "firing":
                self._fired.inc()
            elif tr["from"] == "firing":
                self._resolved_c.inc()
            self.registry.event(
                "alert." + tr["event"], rule=tr["rule"],
                severity=tr["severity"], state=tr["to"],
                value=tr["value"])
        return transitions

    def _advance(self, rule: dict, st: dict, cond: bool,
                 now: float) -> dict | None:
        state = st["state"]
        if state == "ok":
            if not cond:
                return None
            if self._s(rule, "pending_s") <= 0:
                return self._to_locked(rule, st, "firing", "fire", now)
            return self._to_locked(rule, st, "pending", "pending", now)
        if state == "pending":
            if not cond:
                return self._to_locked(rule, st, "ok", "cancel", now)
            if now - st["since"] >= self._s(rule, "pending_s"):
                return self._to_locked(rule, st, "firing", "fire", now)
            return None
        # firing: dedup — only the resolve transition emits.
        if cond:
            return None
        if (st["last_true"] is None
                or now - st["last_true"] >= self._s(rule, "clear_s")):
            return self._to_locked(rule, st, "ok", "resolve", now)
        return None

    def _to_locked(self, rule: dict, st: dict, to: str, event: str,
            now: float) -> dict:
        tr = {"t": now, "rule": rule["name"],
              "severity": rule["severity"], "from": st["state"],
              "to": to, "event": event, "value": st["value"]}
        st["state"] = to
        st["since"] = now
        if to == "firing":
            st["fired"] += 1
        elif event == "resolve":
            st["resolved"] += 1
        self._history.append(tr)
        return tr

    # -- rule conditions ---------------------------------------------------

    def _condition(self, rule: dict,
                   now: float) -> tuple[bool | None, Any]:
        """(condition, value) — condition None means no data."""
        kind = rule["kind"]
        s = self.sampler
        name = rule["metric"]
        if kind == "burn_rate":
            burns = []
            for key in ("short_s", "long_s"):
                g = s.gauge_stats(name, self._s(rule, key), now=now)
                if g["n"] == 0:
                    return None, None
                burns.append((1.0 - g["mean"])
                             / max(1.0 - rule["objective"], 1e-9))
            value = min(burns)
            return value >= rule["burn"], value
        if kind == "drift":
            recent_s = self._s(rule, "recent_s")
            cur = s.hist_percentile(name, recent_s, rule["q"], now=now)
            base = s.hist_percentile(
                name, self._s(rule, "baseline_s"), rule["q"],
                now=now, end_offset_s=recent_s)
            if cur is None or base is None:
                return None, None
            value = cur / base if base > 0 else math.inf
            return (cur >= rule["floor"]
                    and value >= rule["ratio"]), value
        if kind == "slope":
            window_s = self._s(rule, "window_s")
            slope = s.slope_per_s(name, window_s, now=now)
            if slope is None:
                return None, None
            if slope >= 0:
                return False, math.inf
            last = s.gauge_stats(name, window_s, now=now)["last"]
            tto = max(last, 0.0) / -slope
            return tto <= self._s(rule, "horizon_s"), tto
        if kind == "threshold":
            g = s.gauge_stats(name, self._s(rule, "window_s"), now=now)
            if g["n"] == 0:
                return None, None
            return g["mean"] > rule["above"], g["mean"]
        if kind == "delta":
            c = s.counter_rate(name, self._s(rule, "window_s"), now=now)
            if c["n"] == 0:
                return None, None
            return c["delta"] >= rule["min_delta"], c["delta"]
        return None, None

    # -- export ------------------------------------------------------------

    def firing(self) -> list[str]:
        with self._lock:
            return sorted(n for n, s in self._states.items()
                          if s["state"] == "firing")

    def states(self) -> dict[str, dict]:
        with self._lock:
            return {n: dict(s) for n, s in self._states.items()}

    def report(self) -> dict:
        """JSON-serializable alert state (the ``/alerts`` payload and
        the ``alerts`` section of ``metrics_snapshot()``)."""
        with self._lock:
            rules = []
            for r in self.rules:
                st = self._states[r["name"]]
                rules.append(dict(r, state=st["state"],
                                  since=st["since"],
                                  value=st["value"],
                                  no_data=st["no_data"],
                                  fired=st["fired"],
                                  resolved=st["resolved"]))
            return {
                "time_scale": self.time_scale,
                "eval_s": self.eval_s,
                "firing": sorted(n for n, s in self._states.items()
                                 if s["state"] == "firing"),
                "pending": sorted(n for n, s in self._states.items()
                                  if s["state"] == "pending"),
                "rules": rules,
                "history": list(self._history),
            }


class CapacityAdvisor:
    """Folds live series and the load-test knee into a scaling record.

    ``recommend()`` returns ``{"action": "scale_up" | "scale_down" |
    "hold", "n": int, "reason": str, "evidence": {...}, "t": float}``.
    Evidence carries every input the decision read, so an
    autoscaler (and a human reading ``state_dump()``) can audit it.

    The knee comes from ``load_report`` — per-replica sustainable
    goodput RPS, as a load test's report dict or the path of its JSON
    file; without one the advisor reads ``serve_load_report.json``
    under ``HVD_TORCH_BENCH_CACHE`` (else the working directory), where
    :func:`~horovod_tpu_torch.loadgen.measure_saturation`'s report is
    written.  Without any report the advisor still works from goodput,
    queue growth, and free-KV slope; it just can't size ``n`` from
    demand.
    """

    def __init__(self, sampler: timeseries_mod.MetricsSampler, *,
                 alerts: AlertManager | None = None,
                 registry: metrics_mod.MetricsRegistry | None = None,
                 load_report: dict | str | None = None,
                 window_s: float = 60.0, objective: float = 0.99,
                 headroom: float = 0.8, low_util: float = 0.3,
                 time_scale: float = 1.0, history: int = 64,
                 clock: Callable[[], float] | None = None):
        self.sampler = sampler
        self.alerts = alerts
        self.registry = (registry if registry is not None
                         else sampler.registry)
        self._load_report = load_report
        self.window_s = window_s * time_scale
        self.objective = objective
        self.headroom = headroom
        self.low_util = low_util
        self.clock = clock if clock is not None else sampler.clock
        self._lock = threading.Lock()
        self._history: collections.deque[dict] = collections.deque(
            maxlen=history)
        self._recs = self.registry.counter("advisor.recommendations")
        self._delta_g = self.registry.gauge("advisor.target_delta")

    def load_knee(self) -> dict | None:
        """The knee row from the configured load report: explicit dict,
        a path, or the load harness's default drop location
        (``serve_load_report.json`` under ``HVD_TORCH_BENCH_CACHE``, else
        the working directory)."""
        src = self._load_report
        if isinstance(src, dict):
            return src
        path = src
        if path is None:
            path = os.path.join(
                os.environ.get("HVD_TORCH_BENCH_CACHE") or ".",
                "serve_load_report.json")
        try:
            with open(path) as f:
                r = json.load(f)
        except (OSError, ValueError):
            return None
        return r if isinstance(r, dict) else None

    def recommend(self, now: float | None = None) -> dict:
        now = self.clock() if now is None else now
        s = self.sampler
        w = self.window_s
        goodput = s.gauge_stats("serve.goodput", w, now=now)
        replicas = s.gauge_stats("router.replicas_healthy", w,
                                 now=now)
        queue = s.slope_per_s("serve.queue_depth", w, now=now)
        kv_slope = s.slope_per_s("kv.free_blocks", w, now=now)
        done = s.counter_rate("serve.requests_completed", w, now=now)
        knee_report = self.load_knee()
        knee = None
        if knee_report:
            knee = knee_report.get("serve_load_knee_goodput_rps")
        n_replicas = int(replicas["last"]) if replicas["n"] else 1
        n_replicas = max(n_replicas, 1)
        firing = self.alerts.firing() if self.alerts else []
        evidence = {
            "goodput_mean": goodput["mean"] if goodput["n"] else None,
            "replicas_healthy": n_replicas,
            "queue_depth_slope": queue,
            "kv_free_blocks_slope": kv_slope,
            "completed_rps": done["rate"],
            "knee_goodput_rps": knee,
            "firing": firing,
            "window_s": w,
            "objective": self.objective,
            "headroom": self.headroom,
        }
        action, n, reason = self._decide(goodput, queue, kv_slope,
                                         done, knee, n_replicas,
                                         firing)
        rec = {"action": action, "n": n, "reason": reason,
               "evidence": evidence, "t": now}
        with self._lock:
            self._history.append(rec)
        self._recs.inc()
        self._delta_g.set(n if action == "scale_up"
                          else -n if action == "scale_down" else 0)
        return rec

    def _decide(self, goodput, queue, kv_slope, done, knee,
                n_replicas, firing) -> tuple[str, int, str]:
        if goodput["n"] == 0:
            return "hold", 0, "no goodput samples in window"
        sagging = goodput["mean"] < self.objective
        backlog = queue is not None and queue > 0
        draining_kv = kv_slope is not None and kv_slope < 0
        if sagging and (backlog or draining_kv or firing):
            n = 1
            if knee and knee > 0:
                # Demand-sized: replicas needed to serve the observed
                # completion rate at knee-with-headroom per replica.
                need = math.ceil(done["rate"]
                                 / (knee * self.headroom))
                n = max(need - n_replicas, 1)
            why = []
            if backlog:
                why.append("queue growing")
            if draining_kv:
                why.append("free KV draining")
            if firing:
                why.append("alerts firing: " + ",".join(firing))
            return ("scale_up", n,
                    f"goodput {goodput['mean']:.3f} < "
                    f"{self.objective:g} with " + "; ".join(why))
        if (not sagging and not firing and not backlog
                and n_replicas > 1 and knee and knee > 0
                and done["rate"] < knee * self.low_util
                * (n_replicas - 1)):
            # Demand-sized like scale_up: replicas the observed rate
            # actually needs at knee-with-headroom, never shrinking
            # past one survivor.
            need = max(math.ceil(done["rate"]
                                 / (knee * self.headroom)), 1)
            n = max(min(n_replicas - need, n_replicas - 1), 1)
            return ("scale_down", n,
                    f"goodput ok and {done['rate']:.2f} rps fits "
                    f"{need} replica(s) at {self.headroom:g} of "
                    f"{knee:g} rps knee")
        return "hold", 0, "within envelope"

    def report(self) -> dict:
        """Last recommendation plus bounded history (the ``/advice``
        payload renders ``recommend()`` fresh; this is the audit
        trail)."""
        with self._lock:
            hist = list(self._history)
        return {"window_s": self.window_s,
                "objective": self.objective,
                "last": hist[-1] if hist else None,
                "history": hist}


def maybe_alerts(sampler: timeseries_mod.MetricsSampler | None,
                 registry: metrics_mod.MetricsRegistry | None = None,
                 ) -> AlertManager | None:
    """An :class:`AlertManager` per the env contract: needs a live
    sampler, and ``HVD_TORCH_ALERTS`` (default on) not \"0\"."""
    if sampler is None:
        return None
    if os.environ.get("HVD_TORCH_ALERTS", "1") == "0":
        return None
    return AlertManager(sampler, registry=registry)


if __name__ == "__main__":
    print(render_alert_table())
