"""Deterministic chaos campaigns for the serving fleet: port of
``horovod_tpu/chaos.py``.

The :mod:`~horovod_tpu_torch.faults` registry made single faults
reproducible; this module makes *storms* reproducible.  A
:class:`ChaosSchedule` is a pure function of its seed — a set of
step-counted fault rules over the registry's named sites plus
replica-kill events — so a failing campaign is a one-integer bug
report: same seed, same workload → same faults, same recovery, same
bits.  No wall clock enters the schedule (kills and faults fire on hit
*counts*, the registry's own determinism contract); wall clock only
bounds the overall campaign.

:func:`run_campaign` drives one seeded storm against a live
router+supervisor fleet serving a canned workload, then checks the
**invariant oracles** that define "self-healing" for this codebase:

* ``bit_identical`` — every chaos-run request that terminated ``OK``
  produced exactly the fault-free reference tokens (greedy determinism
  must survive retry, failover, respawn, and journal replay).
* ``no_leaked_tickets`` — the router's ticket table is empty once
  every result is read and reaped: a storm must not strand bookkeeping.
* ``no_leaked_blocks`` — every surviving engine passes
  ``prefix.check_consistency()`` and every KV block is free or cached
  (reference counts drained to zero).
* ``metrics_monotonic`` — counters sampled across the campaign never
  decrease (a storm must not corrupt the observability plane).
* ``faults_logged`` — every fault the registry fired appears as a
  ``"fault"`` event in the structured event log: if chaos is
  invisible, postmortems are fiction.
* ``healed`` — after the storm, every replica a kill took down is
  routable again (the supervisor respawned it within its budget).
* ``alerts_covered`` (``alert_oracle=True`` campaigns) — the health
  plane saw the storm: every immediate alert rule whose condition ever
  held fired, every fired alert resolved after heal, and kills tripped
  ``replica_death``.  Alerting that misses a storm it watched is a
  broken pager.

:func:`run_autoscale_campaign` is the elastic-fleet variant: a
deterministic traffic step with scripted
:class:`~horovod_tpu_torch.autoscaler.FleetAutoscaler` actuations
interleaved — a faulted grow that must degrade to ``hold``, a real
grow whose replica must serve routed traffic, and a scale-down that
lands while a keyed wave is in flight, so the cordoned victim fails
open into journal/failover replay.  Its oracles add ``zero_dropped``
(every routed request terminates ``OK``), ``exactly_once``
(resubmitting every idempotency key after the epoch bump answers from
the journal without touching a replica), ``grew_and_served``, and
``drained_and_retired`` to the storm invariants above.

:func:`soak` repeats campaigns with consecutive seeds until a
wall-clock budget runs out (the long-haul mode); :func:`compare_campaigns`
is the JSON regression gate (the ``profile_report.py --compare``
contract: exit nonzero when recovery got worse).  The CLI lives in
``python -m horovod_tpu_torch.tools.chaos_run``; the bench arm
(:func:`measure_chaos_goodput`) reports goodput retention under a
canned storm versus the fault-free fleet.

One known difference from the reference: the port's
:func:`~horovod_tpu_torch.supervisor.clone_engine` keeps the dead
engine's device plane, sampler and alert rules, where the reference's
does not, so a respawned replica reports to the fleet's ``/device`` view
as before.  The campaigns build their replicas with ``sampler=False``,
so their reports do not differ by it.  A second: the autoscale campaign's
router has no sampler either (the reference's takes the env-driven one),
so no alert rule can page on its forced drain, whatever the host's speed.
"""

from __future__ import annotations

import dataclasses
import os
import random
import tempfile
import time
from typing import Any, Sequence

from horovod_tpu_torch import faults as faults_mod
from horovod_tpu_torch import metrics as metrics_mod
from horovod_tpu_torch.router import RouterServer
from horovod_tpu_torch.serving import OK, Request
from horovod_tpu_torch.supervisor import ReplicaSupervisor

#: Engine-internal sites a storm may hit freely: each is covered by a
#: recovery path (bounded retry, admission quarantine, cache
#: quarantine), so a firing rule must never corrupt *other* requests.
STORM_SITES = ("serve.prefill", "serve.tick", "serve.admit",
               "serve.cache")

#: The replica-kill site (the LocalReplica pump; key = replica name).
KILL_SITE = "serve.router"


@dataclasses.dataclass(frozen=True)
class ChaosRule:
    """One scheduled fault, in registry terms (see
    :meth:`~horovod_tpu_torch.faults.FaultRegistry.inject`)."""

    site: str
    on_hit: int
    count: int = 1
    key: Any = None

    def arm(self, fr: faults_mod.FaultRegistry) -> faults_mod.FaultRule:
        return fr.inject(self.site, on_hit=self.on_hit,
                         count=self.count, key=self.key)


class ChaosSchedule:
    """A seed-deterministic storm: engine-site fault rules plus
    replica kills.  ``generate`` guarantees site *coverage* — the
    first ``len(sites)`` rules cycle every storm site once, so any
    ``n_faults >= len(sites)`` exercises at least that many distinct
    sites — then spreads the rest randomly.  Kills are transient
    single-shot rules on the pump site keyed by replica name: the pump
    dies once at the scheduled hit, and the respawned replica's pump
    advances the same counter past the window instead of re-dying
    forever.  Kill hit windows are kept early (``kill_max_hit``): the
    pump's site-hit count tracks engine steps, which drift slightly
    with inbox batching, so a late window might never be reached —
    an early one always is."""

    def __init__(self, seed: int, rules: Sequence[ChaosRule],
                 kills: Sequence[ChaosRule]):
        self.seed = seed
        self.rules = tuple(rules)
        self.kills = tuple(kills)

    @staticmethod
    def generate(seed: int, *,
                 replica_names: Sequence[str],
                 sites: Sequence[str] = STORM_SITES,
                 n_faults: int = 6,
                 n_kills: int = 1,
                 max_hit: int = 12,
                 kill_min_hit: int = 2,
                 kill_max_hit: int = 8) -> "ChaosSchedule":
        rng = random.Random(seed)
        rules = []
        for i in range(n_faults):
            site = (sites[i % len(sites)] if i < len(sites)
                    else rng.choice(sites))
            rules.append(ChaosRule(site=site,
                                   on_hit=rng.randint(1, max_hit),
                                   count=rng.randint(1, 2)))
        kills = [ChaosRule(site=KILL_SITE,
                           on_hit=rng.randint(kill_min_hit,
                                              kill_max_hit),
                           key=rng.choice(list(replica_names)))
                 for _ in range(n_kills)]
        return ChaosSchedule(seed, rules, kills)

    def arm(self, fr: faults_mod.FaultRegistry) -> None:
        for rule in self.rules + self.kills:
            rule.arm(fr)

    def sites(self) -> list[str]:
        return sorted({r.site for r in self.rules}
                      | {k.site for k in self.kills})

    def to_json(self) -> dict:
        return {"seed": self.seed,
                "rules": [dataclasses.asdict(r) for r in self.rules],
                "kills": [dataclasses.asdict(k) for k in self.kills]}


def _workload(n_groups: int, waves: int, *, prefix_len: int = 16,
              suffix_len: int = 4, max_new_tokens: int = 6,
              ) -> list[Request]:
    """The router bench's prompt-family shape, chaos-sized: shared
    per-group prefixes keep the shadow index (and therefore warm
    respawn) meaningful."""
    out = []
    for w in range(waves):
        for g in range(n_groups):
            prefix = [(7 + 11 * g + i) % 89 + 2 for i in range(prefix_len)]
            suffix = [(31 + 5 * g + 3 * w + i) % 89 + 2
                      for i in range(suffix_len)]
            out.append(Request(prompt=prefix + suffix,
                               max_new_tokens=max_new_tokens))
    return out


def _counters_regressed(samples: Sequence[dict]) -> list[str]:
    """Counter names that ever decreased across ordered snapshots."""
    bad = []
    for prev, cur in zip(samples, samples[1:]):
        for name, v in prev.items():
            if cur.get(name, v) < v and name not in bad:
                bad.append(name)
    return bad


def run_campaign(params: dict, cfg: Any, *, seed: int = 0,
                 n_replicas: int = 3, n_groups: int = 4,
                 waves: int = 4, n_faults: int = 6, n_kills: int = 1,
                 n_slots: int = 2, max_len: int = 64, chunk: int = 8,
                 backoff_s: float = 0.01, max_restarts: int = 5,
                 event_log: str | None = None,
                 timeout_s: float = 300.0,
                 extra_rules: Sequence[ChaosRule] = (),
                 slo_window: int = 8,
                 sample_s: float = 0.005,
                 alert_time_scale: float = 0.01,
                 recovery_waves: int = 0,
                 alert_oracle: bool = False,
                 alert_drain_s: float = 10.0) -> dict:
    """One seeded chaos campaign; returns the oracle report (see the
    module docstring for the oracles).  ``report["ok"]`` is the AND of
    every oracle — the smoke test and the soak loop key off it.

    The campaign carries the health plane: a
    :class:`~horovod_tpu_torch.timeseries.MetricsSampler` (``sample_s``) and
    an :class:`~horovod_tpu_torch.alerts.AlertManager` whose production rule
    windows are compressed by ``alert_time_scale`` ride the router
    poller, so every report includes an ``alerts`` section and the
    event log carries the ``alert.*`` transitions.  With
    ``alert_oracle=True`` the campaign additionally serves
    ``recovery_waves`` clean waves after heal (their prompts repeat the
    storm workload, so the fault-free reference covers them), drains
    until no rule is firing (bounded by ``alert_drain_s``), and adds
    the ``alerts_covered`` oracle: every zero-``pending_s`` rule whose
    condition ever held must have FIRED, every fired rule must have
    RESOLVED, and a campaign with kills must have fired
    ``replica_death`` — alert coverage as a tested invariant.
    ``extra_rules`` appends deterministic
    :class:`ChaosRule`\\ s to the seeded schedule (the acceptance test
    forces a goodput dip with a consecutive-prefill-fault rule)."""
    from horovod_tpu_torch import alerts as alerts_mod
    from horovod_tpu_torch import timeseries as timeseries_mod
    from horovod_tpu_torch.serving_scheduler import ServeEngine

    workload = _workload(n_groups, waves)
    recovery = (_workload(n_groups, recovery_waves)
                if recovery_waves else [])
    names = [f"replica{i}" for i in range(n_replicas)]
    schedule = ChaosSchedule.generate(
        seed, replica_names=names, n_faults=n_faults, n_kills=n_kills)

    # Fault-free reference: one solo engine (routing never changes
    # tokens — the router bench asserts that — so a single engine's
    # greedy output IS the fleet's fault-free output).  Covers the
    # recovery waves too — same prompt generator, so OK bits must
    # match there as well.
    ref_engine = ServeEngine(params, cfg, n_slots=n_slots,
                             max_len=max_len, chunk=chunk,
                             prefix_cache=True, monitor=False,
                             metrics=metrics_mod.NULL)
    reference = ref_engine.run(workload + recovery)

    # The chaos fleet: engines, registry, storm, supervisor, journal-
    # free router (journal determinism has its own tests; the campaign
    # exercises engine faults + kills + respawn).  A small SLO window
    # lets fleet goodput both sag under the storm and recover within
    # the recovery waves.
    fr = faults_mod.FaultRegistry()
    schedule.arm(fr)
    for rule in extra_rules:
        rule.arm(fr)
    reg = metrics_mod.MetricsRegistry()
    engines = [ServeEngine(params, cfg, n_slots=n_slots,
                           max_len=max_len, chunk=chunk,
                           prefix_cache=True, monitor=False,
                           faults=fr, metrics=reg,
                           slo_window=slo_window, sampler=False)
               for _ in range(n_replicas)]
    if event_log is None:
        event_log = os.path.join(
            tempfile.mkdtemp(prefix="hvd-chaos-"),
            f"chaos-{seed}-{os.getpid()}.jsonl")
    prior_log = os.environ.get("HVD_TORCH_EVENT_LOG")
    os.environ["HVD_TORCH_EVENT_LOG"] = event_log
    router = None
    samples: list[dict] = []
    results: list[Any] = []
    deadline = time.monotonic() + timeout_s

    def _serve(wave: list[Request]) -> None:
        rids = [router.route(r) for r in wave]
        for rid in rids:
            while True:
                res = router.result(rid, timeout=0.05)
                if res is not None:
                    results.append(res)
                    break
                router.poll_now()
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"chaos campaign stalled (seed={seed})")

    try:
        sampler = timeseries_mod.MetricsSampler(
            reg, sample_s=sample_s, raw_points=4096)
        alerts = alerts_mod.AlertManager(sampler, registry=reg,
                                         time_scale=alert_time_scale)
        router = RouterServer(engines, policy="round_robin", registry=reg,
                              faults=fr, sampler=sampler, alerts=alerts)
        ReplicaSupervisor(router, max_restarts=max_restarts,
                          backoff_s=backoff_s, warm_prefixes=4)
        # The baseline sample, before the storm: a counter's first sample
        # carries no delta, so a replica death before it would never reach
        # the delta rules.  The reference takes its first sample at the
        # first poll, which its compile-slowed first steps push past the
        # kill; the port's eager steps can kill within milliseconds.
        sampler.tick()
        for w in range(waves):
            _serve(workload[w * n_groups:(w + 1) * n_groups])
            samples.append(dict(reg.snapshot()["counters"]))
        # Heal window: give the supervisor polls until every replica
        # is routable again (backoff is tiny; this is hit-bounded by
        # the wall-clock deadline, not by sleeps).
        while time.monotonic() < deadline:
            router.poll_now()
            _, health = router.health()
            if health["healthy"] == n_replicas:
                break
            time.sleep(backoff_s)
        # Clean recovery traffic: storm-window SLO failures only age
        # out of the per-engine goodput windows when fresh terminals
        # displace them — a gauge nobody writes never recovers.  Under
        # ``alert_oracle`` the waves interleave with the alert drain:
        # histogram-backed rules (drift) need fresh deltas while their
        # hysteresis clears, because a quiet histogram is "no data"
        # and no-data deliberately holds alert state.
        served = 0
        if alert_oracle:
            # Alert drain: keep polling (sampler + rules keep ticking)
            # until every firing rule has cleared its hysteresis, so
            # "resolved after heal" is observed, not assumed.
            drain_deadline = min(deadline,
                                 time.monotonic() + alert_drain_s)
            while (alerts.firing()
                   and time.monotonic() < drain_deadline):
                if served < recovery_waves:
                    _serve(recovery[served * n_groups:
                                    (served + 1) * n_groups])
                    served += 1
                router.poll_now()
                time.sleep(backoff_s)
        for w in range(served, recovery_waves):
            _serve(recovery[w * n_groups:(w + 1) * n_groups])
        samples.append(dict(reg.snapshot()["counters"]))
        router.reap_tickets(0)
        leaked_tickets = router.memory_report()["tickets"]
        leaked_blocks = 0
        block_errors: list[str] = []
        for r in router.replicas:
            eng = getattr(r, "engine", None)
            if eng is None:
                continue
            total = int(eng.pcache.k.shape[1]) - 1
            free = eng.free_block_count() + eng.cached_block_count()
            leaked_blocks += total - free
            if eng.prefix is not None:
                try:
                    eng.prefix.check_consistency()
                except AssertionError as e:
                    block_errors.append(f"{r.name}: {e}")
        _, health = router.health()
    finally:
        os.environ.pop("HVD_TORCH_EVENT_LOG", None)
        if prior_log is not None:
            os.environ["HVD_TORCH_EVENT_LOG"] = prior_log
        if router is not None:
            router.stop()

    fired = list(fr.log)
    logged = [(e.get("site"), e.get("key"), e.get("hit"))
              for e in metrics_mod.EventLog.read(event_log)
              if e.get("kind") == "fault"]
    missing = [f for f in fired if (f[0], f[1], f[2]) not in logged]
    regressed = _counters_regressed(samples)
    storm_results = results[:len(workload)]
    n_ok = sum(1 for r in storm_results if r.status == OK)
    mismatches = [i for i, (res, ref) in enumerate(zip(results,
                                                       reference))
                  if res.status == OK and list(res) != list(ref)]
    counters = samples[-1] if samples else {}
    kills_fired = sum(1 for s, _k, _h in fired if s == KILL_SITE)

    alert_states = alerts.states()
    immediate = {r["name"] for r in alerts.rules
                 if not float(r.get("pending_s", 0))}
    ever_true = {n for n, st in alert_states.items()
                 if st["ever_true"]}
    fired_rules = {n for n, st in alert_states.items()
                   if st["fired"]}
    resolved_rules = {n for n, st in alert_states.items()
                      if st["resolved"]}
    still_firing = alerts.firing()

    oracles = {
        "bit_identical": not mismatches,
        "no_leaked_tickets": leaked_tickets == 0,
        "no_leaked_blocks": leaked_blocks == 0 and not block_errors,
        "metrics_monotonic": not regressed,
        "faults_logged": not missing,
        "healed": health["healthy"] == n_replicas,
    }
    if alert_oracle:
        # Alert coverage: every immediate (zero-pending) rule whose
        # condition was ever observed true must have fired; every
        # fired rule must have resolved (nothing still firing after
        # the drain); and a storm with kills must have tripped
        # replica_death.
        oracles["alerts_covered"] = (
            (ever_true & immediate) <= fired_rules
            and fired_rules <= resolved_rules
            and not still_firing
            and (kills_fired == 0 or "replica_death" in fired_rules))
    return {
        "seed": seed,
        "schedule": schedule.to_json(),
        "sites_fired": sorted({s for s, _k, _h in fired}),
        "n_requests": len(workload),
        "n_ok": n_ok,
        "ok_fraction": n_ok / len(workload),
        "faults_fired": len(fired),
        "kills_fired": kills_fired,
        "respawns": counters.get("supervisor.respawns", 0),
        "permanent_deaths": counters.get(
            "supervisor.permanent_deaths", 0),
        "failovers": counters.get("router.failovers", 0),
        "leaked_tickets": leaked_tickets,
        "leaked_blocks": leaked_blocks,
        "block_errors": block_errors,
        "counter_regressions": regressed,
        "unlogged_faults": [list(f) for f in missing],
        "mismatched_requests": mismatches,
        "alerts": {
            "fired": sorted(fired_rules),
            "resolved": sorted(resolved_rules),
            "ever_true": sorted(ever_true),
            "still_firing": still_firing,
            "transitions": len(alerts.report()["history"]),
        },
        "event_log": event_log,
        "oracles": oracles,
        "ok": all(oracles.values()),
    }


def soak(params: dict, cfg: Any, *, seconds: float,
         start_seed: int = 0, **campaign_kw: Any) -> dict:
    """Run consecutive-seed campaigns until the wall-clock budget runs
    out (at least one always runs).  Returns the aggregate: campaign
    count, failing seeds with their broken oracles, total faults."""
    t0 = time.monotonic()
    seed = start_seed
    reports: list[dict] = []
    while not reports or time.monotonic() - t0 < seconds:
        reports.append(run_campaign(params, cfg, seed=seed,
                                    **campaign_kw))
        seed += 1
    failures = [{"seed": r["seed"],
                 "oracles": {k: v for k, v in r["oracles"].items()
                             if not v}}
                for r in reports if not r["ok"]]
    return {
        "campaigns": len(reports),
        "seconds": time.monotonic() - t0,
        "seeds": [r["seed"] for r in reports],
        "faults_fired": sum(r["faults_fired"] for r in reports),
        "kills_fired": sum(r["kills_fired"] for r in reports),
        "min_ok_fraction": min(r["ok_fraction"] for r in reports),
        "failures": failures,
        "ok": not failures,
    }


def compare_campaigns(old: dict, new: dict, *,
                      threshold: float = 0.1) -> tuple[bool, list[str]]:
    """The regression gate (``chaos_run.py --compare OLD NEW``): fail
    when any oracle that held in ``old`` broke in ``new``, or when the
    OK fraction dropped more than ``threshold`` absolute.  Accepts
    single-campaign or soak reports (a soak report gates on ``ok`` and
    ``min_ok_fraction``)."""
    problems: list[str] = []
    for name, held in old.get("oracles", {}).items():
        if held and not new.get("oracles", {}).get(name, True):
            problems.append(f"oracle {name}: held before, broken now")
    if old.get("ok", True) and not new.get("ok", True):
        if not problems:
            problems.append("campaign ok: passed before, fails now")
    for key in ("ok_fraction", "min_ok_fraction"):
        if key in old and key in new:
            drop = old[key] - new[key]
            if drop > threshold:
                problems.append(
                    f"{key} dropped {drop:.3f} "
                    f"({old[key]:.3f} -> {new[key]:.3f}, "
                    f"threshold {threshold})")
    return (not problems), problems


def measure_chaos_goodput(params: dict, cfg: Any, *, seed: int = 0,
                          **campaign_kw: Any) -> dict:
    """The ``serve_chaos_*`` bench arm: one seeded storm campaign,
    reporting what fraction of the workload still terminated ``OK``
    (the fault-free fleet completes everything, so OK fraction IS
    goodput retention) plus the storm's shape for context."""
    report = run_campaign(params, cfg, seed=seed, **campaign_kw)
    return {
        "serve_chaos_seed": seed,
        "serve_chaos_requests": report["n_requests"],
        "serve_chaos_faults_fired": report["faults_fired"],
        "serve_chaos_kills_fired": report["kills_fired"],
        "serve_chaos_respawns": report["respawns"],
        "serve_chaos_ok_fraction": report["ok_fraction"],
        "serve_chaos_goodput_retention": report["ok_fraction"],
        "serve_chaos_oracles_ok": report["ok"],
    }


def run_autoscale_campaign(params: dict, cfg: Any, *,
                           n_replicas: int = 2, n_groups: int = 3,
                           waves: int = 6, n_slots: int = 2,
                           max_len: int = 64, chunk: int = 8,
                           backoff_s: float = 0.01,
                           event_log: str | None = None,
                           journal: str | None = None,
                           timeout_s: float = 300.0,
                           drain_s: float = 0.0,
                           fault_first_grow: bool = True) -> dict:
    """One deterministic elastic-fleet campaign: a traffic step with
    scripted autoscaler actuations interleaved into live serving.

    The script (no randomness — every phase is a fixed function of the
    arguments, so a failure is exactly reproducible):

    1. **Calm**: the first third of the waves on the starting fleet.
    2. **Faulted grow** (``fault_first_grow``): a ``serve.autoscale``
       rule armed on the first actuation attempt must degrade the
       scale-up to ``hold`` — membership untouched, nothing dropped.
    3. **Grow**: the retry joins a fresh replica through the
       supervisor's factory seam (epoch bump #1).
    4. **Burst**: the middle third of the waves routed as one block —
       the traffic step the grow answered; the new replica must have
       served routed traffic by the end of it.
    5. **Shrink under load**: one wave is routed with idempotency keys
       and the scale-down is actuated while it is in flight.  With the
       default ``drain_s=0`` the cordoned victim fails open through
       the crash path: in-flight callbacks fire ``None`` and the
       router replays each request on a survivor, bit-identically.
       The drain converges to a retire (epoch bump #2).
    6. **Exactly-once probe**: every key from phase 5 is resubmitted
       after the epoch bump; the journal must answer all of them
       without a single new engine submission.
    7. **Tail**: the remaining waves on the shrunk fleet.

    The autoscaler runs with its organic advisor loop idle (no sampler
    in the fleet, so ``router.advisor`` is ``None``) and zeroed
    cooldown/stabilization guards — the campaign owns the decision
    sequence; the guards and the advisor loop have their own
    virtual-clock tests.  Returns an oracle report shaped like
    :func:`run_campaign`'s; ``report["ok"]`` is the AND of every
    oracle."""
    from horovod_tpu_torch.autoscaler import FleetAutoscaler
    from horovod_tpu_torch.serving_scheduler import ServeEngine

    if waves < 5:
        raise ValueError("the autoscale campaign needs waves >= 5 "
                         "(calm / burst / shrink / tail phases)")
    workload = _workload(n_groups, waves)
    calm = max(waves // 3, 1)
    burst = max(waves // 3, 1)

    # Fault-free reference: as in run_campaign, one solo engine's
    # greedy output IS the elastic fleet's expected output — joins,
    # cordons, forced drains, and journal dedup must not change bits.
    ref_engine = ServeEngine(params, cfg, n_slots=n_slots,
                             max_len=max_len, chunk=chunk,
                             prefix_cache=True, monitor=False,
                             metrics=metrics_mod.NULL)
    reference = ref_engine.run(workload)

    fr = faults_mod.FaultRegistry()
    if fault_first_grow:
        fr.inject("serve.autoscale", on_hit=1, count=1)
    reg = metrics_mod.MetricsRegistry()
    engines = [ServeEngine(params, cfg, n_slots=n_slots,
                           max_len=max_len, chunk=chunk,
                           prefix_cache=True, monitor=False,
                           faults=fr, metrics=reg, sampler=False)
               for _ in range(n_replicas)]
    tmpdir = (tempfile.mkdtemp(prefix="hvd-autoscale-")
              if event_log is None or journal is None else None)
    if event_log is None:
        event_log = os.path.join(tmpdir, "autoscale-events.jsonl")
    if journal is None:
        journal = os.path.join(tmpdir, "autoscale-journal.jsonl")
    prior_log = os.environ.get("HVD_TORCH_EVENT_LOG")
    os.environ["HVD_TORCH_EVENT_LOG"] = event_log
    router = None
    samples: list[dict] = []
    results: list[Any] = []
    decisions: dict[str, dict] = {}
    deadline = time.monotonic() + timeout_s

    def _collect(rids: list[int]) -> list[Any]:
        out = []
        for rid in rids:
            while True:
                res = router.result(rid, timeout=0.05)
                if res is not None:
                    out.append(res)
                    break
                router.poll_now()
                if time.monotonic() > deadline:
                    raise RuntimeError("autoscale campaign stalled")
        return out

    def _wave(w: int) -> list[Request]:
        return workload[w * n_groups:(w + 1) * n_groups]

    try:
        # No sampler, so no alert rules and no advisor: the campaign owns
        # every decision.  An env-driven sampler (HVD_TORCH_SAMPLE_S, 1 s)
        # would page ``replica_death`` on the forced drain whenever a run
        # outlasts one cadence after it, a verdict of the host's speed.
        router = RouterServer(engines, policy="round_robin", registry=reg,
                              faults=fr, journal=journal, sampler=False)
        sup = ReplicaSupervisor(router, backoff_s=backoff_s,
                                warm_prefixes=4)
        asc = FleetAutoscaler(router, supervisor=sup, enabled=True,
                              cooldown_s=0.0, stable_s=0.0,
                              min_replicas=1, max_replicas=n_replicas + 2,
                              step=1, drain_s=drain_s, faults=fr)
        for w in range(calm):
            results.extend(_collect([router.route(r)
                                     for r in _wave(w)]))
        samples.append(dict(reg.snapshot()["counters"]))

        if fault_first_grow:
            decisions["faulted_grow"] = asc.actuate(
                {"action": "scale_up", "n": 1,
                 "reason": "campaign traffic step"})
        with router._lock:
            size_after_fault = len(router.replicas)
        decisions["grow"] = asc.actuate(
            {"action": "scale_up", "n": 1,
             "reason": "campaign traffic step"})
        grown = list(decisions["grow"].get("replicas", []))
        with router._lock:
            grown_size = len(router.replicas)

        lo, hi = calm * n_groups, (calm + burst) * n_groups
        results.extend(_collect([router.route(r)
                                 for r in workload[lo:hi]]))
        with router._lock:
            routed_new = sum(router._routed.get(n, 0) for n in grown)
        samples.append(dict(reg.snapshot()["counters"]))

        # Shrink while the keyed wave is in flight: the cordon lands
        # between route and result, so the victim drains (or fails
        # open) under real load.
        drain_reqs = _wave(calm + burst)
        keys = [f"autoscale-{i}" for i in range(len(drain_reqs))]
        rids = [router.route(r, idempotency_key=k)
                for r, k in zip(drain_reqs, keys)]
        decisions["shrink"] = asc.actuate(
            {"action": "scale_down", "n": 1,
             "reason": "campaign step down"})
        drained = _collect(rids)
        results.extend(drained)
        while asc.draining() and time.monotonic() < deadline:
            router.poll_now()
            time.sleep(backoff_s)

        submitted_before = reg.snapshot()["counters"].get(
            "serve.requests_submitted", 0)
        dedups_before = reg.snapshot()["counters"].get(
            "router.journal_dedups", 0)
        dups = _collect([router.route(r, idempotency_key=k)
                         for r, k in zip(drain_reqs, keys)])
        counters_now = reg.snapshot()["counters"]
        new_submits = (counters_now.get("serve.requests_submitted", 0)
                       - submitted_before)
        new_dedups = (counters_now.get("router.journal_dedups", 0)
                      - dedups_before)

        for w in range(calm + burst + 1, waves):
            results.extend(_collect([router.route(r)
                                     for r in _wave(w)]))
        samples.append(dict(reg.snapshot()["counters"]))

        router.reap_tickets(0)
        leaked_tickets = router.memory_report()["tickets"]
        leaked_blocks = 0
        block_errors: list[str] = []
        with router._lock:
            survivors = list(router.replicas)
        for r in survivors:
            eng = getattr(r, "engine", None)
            if eng is None:
                continue
            total = int(eng.pcache.k.shape[1]) - 1
            free = eng.free_block_count() + eng.cached_block_count()
            leaked_blocks += total - free
            if eng.prefix is not None:
                try:
                    eng.prefix.check_consistency()
                except AssertionError as e:
                    block_errors.append(f"{r.name}: {e}")
        final_size = len(survivors)
        final_cordoned = router.cordoned()
        epoch = asc.epoch.snapshot()
    finally:
        os.environ.pop("HVD_TORCH_EVENT_LOG", None)
        if prior_log is not None:
            os.environ["HVD_TORCH_EVENT_LOG"] = prior_log
        if router is not None:
            router.stop()

    fired = list(fr.log)
    events = metrics_mod.EventLog.read(event_log)
    logged = [(e.get("site"), e.get("key"), e.get("hit"))
              for e in events if e.get("kind") == "fault"]
    missing = [f for f in fired if (f[0], f[1], f[2]) not in logged]
    drain_forced = any(e.get("kind") == "autoscaler.drain_force"
                       for e in events)
    regressed = _counters_regressed(samples)
    n_ok = sum(1 for r in results if r.status == OK)
    mismatches = [i for i, (res, ref) in enumerate(zip(results,
                                                       reference))
                  if list(res) != list(ref) or res.status != OK]
    dup_mismatches = [i for i, (dup, orig) in enumerate(zip(dups,
                                                            drained))
                      if dup.status != OK or list(dup) != list(orig)]
    faulted = decisions.get("faulted_grow")

    oracles = {
        "bit_identical": not mismatches,
        "zero_dropped": n_ok == len(workload),
        "exactly_once": (not dup_mismatches
                         and new_submits == 0
                         and new_dedups == len(keys)),
        "grew_and_served": (decisions["grow"]["action"] == "scale_up"
                            and grown_size == n_replicas + 1
                            and routed_new > 0),
        "drained_and_retired": (
            decisions["shrink"]["action"] == "scale_down"
            and final_size == n_replicas
            and not final_cordoned
            and epoch["generation"] >= 2),
        "fault_degraded_to_hold": (
            not fault_first_grow
            or (faulted is not None
                and faulted["action"] == "hold"
                and size_after_fault == n_replicas)),
        "no_leaked_tickets": leaked_tickets == 0,
        "no_leaked_blocks": leaked_blocks == 0 and not block_errors,
        "metrics_monotonic": not regressed,
        "faults_logged": not missing,
    }
    counters = samples[-1] if samples else {}
    return {
        "n_requests": len(workload),
        "n_ok": n_ok,
        "ok_fraction": n_ok / len(workload),
        "grown_replicas": grown,
        "routed_to_grown": routed_new,
        "drain_forced": drain_forced,
        "dedups": new_dedups,
        "epoch": epoch,
        "decisions": decisions,
        "scale_ups": counters.get("autoscaler.scale_ups", 0),
        "scale_downs": counters.get("autoscaler.scale_downs", 0),
        "hold_faults": counters.get("autoscaler.hold_faults", 0),
        "failovers": counters.get("router.failovers", 0),
        "leaked_tickets": leaked_tickets,
        "leaked_blocks": leaked_blocks,
        "block_errors": block_errors,
        "counter_regressions": regressed,
        "unlogged_faults": [list(f) for f in missing],
        "mismatched_requests": mismatches,
        "event_log": event_log,
        "oracles": oracles,
        "ok": all(oracles.values()),
    }
