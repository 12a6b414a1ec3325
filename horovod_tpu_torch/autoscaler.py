"""Elastic autoscaling for the router fleet: port of
``horovod_tpu/autoscaler.py``, closing the advisor → actuator loop.

The :class:`~horovod_tpu_torch.alerts.CapacityAdvisor` emits
evidence-carrying ``scale_up(n)`` / ``scale_down(n)`` / ``hold``
records; the supervisor respawns through a pluggable factory
(:func:`~horovod_tpu_torch.supervisor.clone_engine`, which shares the
weight tensors and allocates one more KV pool) and the router's journal
makes a drain fail open into bit-identical replay.  The
:class:`FleetAutoscaler` connects them.  It is host bookkeeping: it
launches nothing on the card.  It holds no thread of its
own: the router's existing poll pass ticks it (the supervisor/sampler
idiom), after the health plane so every decision actuates against
this pass's fresh views.

**Grow** spawns a brand-new replica through the supervisor's factory
seam (:meth:`~horovod_tpu_torch.supervisor.ReplicaSupervisor.spawn_replica`
— an explicit factory, or a clone of a live local replica pre-warmed
with the fleet's hot prefixes) and joins it with
:meth:`~horovod_tpu_torch.router.RouterServer.add_replica`.

**Shrink** is cordon → drain → retire, and drops zero requests by
construction: ``cordon_replica`` removes the victim from the routing
candidate set while its in-flight requests keep running; once its
inflight count reaches zero the victim is retired
(:meth:`~horovod_tpu_torch.router.RouterServer.retire_replica`).  A victim
that has not drained by the deadline is failed open instead of waited
on forever: it is killed through the same death path a crash takes,
so every in-flight request's callback fires ``None`` and the router
replays it on a survivor — greedy determinism makes the replay
bit-identical, and journaled idempotency keys stay exactly-once
because the dedup map and WAL survive the membership change.

Membership is explicit: a generation-numbered :class:`FleetEpoch`
bumps on every join and leave.  The bump is bookkeeping only — the
per-replica ``ShadowPrefixIndex`` objects, the advisor's history, and
the journal dedup map are deliberately NOT reset, which is what makes
scale-downs invisible to clients.

Victim selection is a pluggable :class:`VictimPolicy`.  The default,
:class:`LeastLocalityVictim`, retires the replica the prefix-affinity
plane values least: fewest shadow-index paths, ties broken by lowest
probed goodput, then by name for determinism.

Every actuation is guarded: a cooldown between actions, a
stabilization window of *sustained* shrink advice before any
scale-down starts (flap suppression), min/max replica bounds, and a
per-action step cap — all ``HVD_TORCH_AUTOSCALE_*`` knobs.  Each
actuation attempt checks the ``serve.autoscale`` fault site first
(key = action name): a firing rule degrades the action to ``hold`` —
counted in ``autoscaler.hold_faults``, evented, and crucially never
touching routing, so a faulted autoscaler can never drop a request.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Any, Callable, Sequence

from horovod_tpu_torch import faults as faults_mod
from horovod_tpu_torch.monitor import env_float


class FleetEpoch:
    """Generation-numbered fleet membership (the serving-side echo of
    ``elastic.py``'s commit step): every join/leave bumps the
    generation and records the member set, so any observer can name
    exactly which fleet a request was served by."""

    def __init__(self, members: Sequence[str] = (),
                 history: int = 64):
        self._gen = 0
        self._members = tuple(members)
        self._history: collections.deque[dict] = collections.deque(
            maxlen=history)

    @property
    def generation(self) -> int:
        return self._gen

    @property
    def members(self) -> tuple[str, ...]:
        return self._members

    def bump(self, members: Sequence[str], reason: str,
             t: float) -> int:
        self._gen += 1
        self._members = tuple(members)
        self._history.append({"generation": self._gen, "t": t,
                              "members": self._members,
                              "reason": reason})
        return self._gen

    def snapshot(self) -> dict:
        return {"generation": self._gen,
                "members": list(self._members),
                "history": list(self._history)}


class VictimPolicy:
    """Chooses which replica a scale-down retires.  ``candidates`` is
    the healthy, uncordoned name list; ``views`` the last-probed
    per-replica views; ``shadows`` the per-replica shadow prefix
    indexes (both read under the router lock by the caller)."""

    name = "victim"

    def choose(self, candidates: Sequence[str], views: dict,
               shadows: dict) -> str:
        raise NotImplementedError


class LeastLocalityVictim(VictimPolicy):
    """Retire the replica the prefix-affinity plane values least:
    fewest shadow-index paths (its cached prefixes are cheapest to
    lose), goodput-tiebroken (among equals, the one serving worst
    goes), then name for determinism."""

    name = "least_locality"

    def choose(self, candidates: Sequence[str], views: dict,
               shadows: dict) -> str:
        def key(n: str) -> tuple:
            shadow = shadows.get(n)
            paths = len(shadow) if shadow is not None else 0
            goodput = views.get(n, {}).get("goodput", 1.0)
            return (paths, goodput, n)
        return min(candidates, key=key)


class FleetAutoscaler:
    """Actuates :class:`~horovod_tpu_torch.alerts.CapacityAdvisor` records
    against one router; see the module docstring.

    Ticked by the router's poller (it sets ``router.autoscaler`` on
    construction, like the supervisor).  ``enabled=False`` keeps the
    full decision trail (``report()``, ``/autoscaler``) in advisory
    mode without ever touching membership; in-flight drains still
    converge, so disabling mid-scale-down cannot strand a cordon.
    """

    _GUARDED_BY_LOCK = ("_draining", "_history", "_last_decision")

    def __init__(self, router: Any, *,
                 supervisor: Any = None,
                 advisor: Any = None,
                 victim_policy: "VictimPolicy | None" = None,
                 enabled: "bool | None" = None,
                 cooldown_s: "float | None" = None,
                 stable_s: "float | None" = None,
                 min_replicas: "int | None" = None,
                 max_replicas: "int | None" = None,
                 step: "int | None" = None,
                 drain_s: "float | None" = None,
                 eval_s: "float | None" = None,
                 faults: "faults_mod.FaultRegistry | None" = None,
                 history: int = 64,
                 clock: Callable[[], float] = time.monotonic):
        self.router = router
        self._explicit_supervisor = supervisor
        self._explicit_advisor = advisor
        self.victim_policy = (victim_policy if victim_policy is not None
                              else LeastLocalityVictim())
        self.enabled = (enabled if enabled is not None else
                        os.environ.get("HVD_TORCH_AUTOSCALE", "0")
                        not in ("", "0"))
        self.cooldown_s = (cooldown_s if cooldown_s is not None else
                           env_float("HVD_TORCH_AUTOSCALE_COOLDOWN_S",
                                     30.0))
        self.stable_s = (stable_s if stable_s is not None else
                         env_float("HVD_TORCH_AUTOSCALE_STABLE_S", 60.0))
        self.min_replicas = max(1, int(
            min_replicas if min_replicas is not None else
            env_float("HVD_TORCH_AUTOSCALE_MIN_REPLICAS", 1)))
        self.max_replicas = int(
            max_replicas if max_replicas is not None else
            env_float("HVD_TORCH_AUTOSCALE_MAX_REPLICAS", 8))
        self.step = max(1, int(
            step if step is not None else
            env_float("HVD_TORCH_AUTOSCALE_STEP", 1)))
        # Per-victim drain deadline before failing open (the router's
        # shutdown-drain budget is the natural default).
        self.drain_s = (drain_s if drain_s is not None
                        else getattr(router, "drain_s", 5.0))
        sampler = getattr(router, "sampler", None)
        self.eval_s = (eval_s if eval_s is not None else
                       getattr(sampler, "sample_s", 1.0) or 1.0)
        self.faults = faults if faults is not None else router.faults
        self.metrics = router.metrics
        self.clock = clock
        self._lock = threading.Lock()
        self._history: collections.deque[dict] = collections.deque(
            maxlen=history)
        self._draining: dict[str, dict] = {}
        self._last_decision: "dict | None" = None
        self._last_eval = float("-inf")
        self._last_action_ts = float("-inf")
        self._shrink_since: "float | None" = None
        self._spawn_seq = 0
        with router._lock:
            members = [r.name for r in router.replicas]
        self.epoch = FleetEpoch(members)
        # Registered up front (literal names) so snapshots are
        # schema-stable.
        self.metrics.counter("autoscaler.actions")
        self.metrics.counter("autoscaler.scale_ups")
        self.metrics.counter("autoscaler.scale_downs")
        self.metrics.counter("autoscaler.holds")
        self.metrics.counter("autoscaler.hold_faults")
        self.metrics.counter("autoscaler.cordons")
        self.metrics.gauge("autoscaler.epoch").set(0)
        self.metrics.gauge("autoscaler.draining").set(0)
        self.metrics.gauge("autoscaler.replicas_target").set(
            len(members))
        router.autoscaler = self

    # -- wiring ------------------------------------------------------------

    @property
    def supervisor(self) -> Any:
        return (self._explicit_supervisor
                if self._explicit_supervisor is not None
                else getattr(self.router, "supervisor", None))

    @property
    def advisor(self) -> Any:
        return (self._explicit_advisor
                if self._explicit_advisor is not None
                else getattr(self.router, "advisor", None))

    # -- the decision loop -------------------------------------------------

    def tick(self, now: "float | None" = None) -> "dict | None":
        """One autoscaling pass (the router's poller calls this every
        poll): converge in-flight drains first, then — at the eval
        cadence, when enabled — consume one advisor recommendation
        and actuate it under the guards.  Returns the decision record
        when one was evaluated, else ``None``."""
        now = self.clock() if now is None else now
        self._advance_drains(now)
        if now - self._last_eval < self.eval_s:
            return None
        self._last_eval = now
        if not self.enabled:
            return None
        advisor = self.advisor
        if advisor is None:
            return None
        rec = advisor.recommend(now)
        return self.actuate(rec, now)

    def actuate(self, rec: dict, now: "float | None" = None) -> dict:
        """Actuate one recommendation record (``tick`` calls this with
        the advisor's; campaigns script their own).  Every path —
        including every guard — produces a decision record in the
        history, so ``report()`` explains inaction as well as
        action."""
        now = self.clock() if now is None else now
        action = rec.get("action", "hold")
        n = int(rec.get("n", 0) or 0)
        with self.router._lock:
            size = len(self.router.replicas)
            draining = len(self._draining)
        held = self._guard(action, n, size, draining, now)
        if held is None and action != "hold":
            try:
                self.faults.check("serve.autoscale", key=action)
            except Exception as e:
                self.metrics.counter("autoscaler.hold_faults").inc()
                held = f"actuation fault: {e}"
        if held is not None:
            decision = self._decide(now, rec, "hold", held)
        elif action == "scale_up":
            decision = self._grow(rec, n, size, now)
        elif action == "scale_down":
            decision = self._shrink(rec, n, size, now)
        else:
            # The advisor's own hold: the steady state.  Track it as
            # the last decision but keep it out of the history and
            # the event log — an idle fleet must not spam either.
            decision = self._decide(now, rec, "hold",
                                    rec.get("reason", "advisor hold"),
                                    record=False)
        if decision["action"] == "hold":
            self.metrics.counter("autoscaler.holds").inc()
        return decision

    def _guard(self, action: str, n: int, size: int, draining: int,
               now: float) -> "str | None":
        """The actuation guards; returns the hold reason, or ``None``
        to proceed.  Also drives the scale-down stabilization window:
        shrink advice must be *continuous* for ``stable_s`` before a
        cordon starts, and any other advice resets the window."""
        if action != "scale_down":
            self._shrink_since = None
        if action == "hold" or n <= 0:
            return None if action == "hold" else "empty recommendation"
        if draining:
            return "a scale-down is still draining"
        if now - self._last_action_ts < self.cooldown_s:
            return (f"cooldown: {now - self._last_action_ts:.2f}s "
                    f"since last action < {self.cooldown_s:g}s")
        if action == "scale_up":
            if size >= self.max_replicas:
                return f"at max_replicas={self.max_replicas}"
            return None
        # scale_down: stabilization window (flap suppression).
        if self._shrink_since is None:
            self._shrink_since = now
        if now - self._shrink_since < self.stable_s:
            return (f"stabilizing: shrink advice for "
                    f"{now - self._shrink_since:.2f}s < "
                    f"{self.stable_s:g}s")
        if size <= self.min_replicas:
            return f"at min_replicas={self.min_replicas}"
        return None

    # -- actuation ---------------------------------------------------------

    def _grow(self, rec: dict, n: int, size: int, now: float) -> dict:
        target = min(size + min(n, self.step), self.max_replicas)
        sup = self.supervisor
        if sup is None:
            return self._decide(now, rec, "hold",
                                "no supervisor factory seam to spawn "
                                "through")
        joined: list[str] = []
        for _ in range(target - size):
            name = self._fresh_name()
            try:
                handle = sup.spawn_replica(name)
            except Exception as e:
                self.metrics.counter("autoscaler.hold_faults").inc()
                self.metrics.event("autoscaler.spawn_failure",
                                   replica=name, error=str(e))
                break
            if handle is None:
                break       # out-of-band fleet: nothing to join here
            self.router.add_replica(handle)
            joined.append(name)
            self.metrics.counter("autoscaler.scale_ups").inc()
        if not joined:
            return self._decide(now, rec, "hold",
                                "grow produced no replica (factory "
                                "unavailable or failed)")
        gen = self._bump_epoch("scale_up", now)
        self._last_action_ts = now
        self.metrics.counter("autoscaler.actions").inc()
        self.metrics.gauge("autoscaler.replicas_target").set(target)
        for name in joined:
            self.metrics.event("autoscaler.scale_up", replica=name,
                               epoch=gen, reason=rec.get("reason"))
        return self._decide(now, rec, "scale_up",
                            f"joined {joined} at epoch {gen}",
                            replicas=joined, epoch=gen)

    def _shrink(self, rec: dict, n: int, size: int,
                now: float) -> dict:
        target = max(size - min(n, self.step), self.min_replicas)
        with self.router._lock:
            candidates = [r.name for r in self.router.replicas
                          if r.name not in self.router._dead
                          and r.name not in self.router._cordoned]
            views = dict(self.router._views)
            shadows = dict(self.router._shadows)
        victims: list[str] = []
        for _ in range(size - target):
            if len(candidates) <= 1:
                break       # never cordon the last live replica
            victim = self.victim_policy.choose(candidates, views,
                                               shadows)
            candidates.remove(victim)
            victims.append(victim)
        if not victims:
            return self._decide(now, rec, "hold",
                                "no cordonable victim")
        for victim in victims:
            self.router.cordon_replica(victim)
            self.metrics.counter("autoscaler.cordons").inc()
            with self._lock:
                self._draining[victim] = {"since": now,
                                          "forced": False}
            self.metrics.event("autoscaler.cordon", replica=victim,
                               policy=self.victim_policy.name,
                               reason=rec.get("reason"))
        self._last_action_ts = now
        self._shrink_since = None
        self.metrics.counter("autoscaler.actions").inc()
        self.metrics.gauge("autoscaler.replicas_target").set(target)
        self.metrics.gauge("autoscaler.draining").set(
            len(self._draining))
        return self._decide(now, rec, "scale_down",
                            f"cordoned {victims}; draining",
                            replicas=victims)

    def _advance_drains(self, now: float) -> None:
        """Converge cordoned victims: retire the drained, fail open
        the stuck.  Runs every tick, enabled or not."""
        with self._lock:
            draining = list(self._draining.items())
        if not draining:
            return
        for name, info in draining:
            with self.router._lock:
                present = any(r.name == name
                              for r in self.router.replicas)
                inflight = self.router._inflight.get(name, 0)
            if not present:
                with self._lock:
                    self._draining.pop(name, None)
            elif inflight == 0:
                self._retire(name, now)
            elif (not info["forced"]
                    and now - info["since"] >= self.drain_s):
                self._fail_open(name, now)
        self.metrics.gauge("autoscaler.draining").set(
            len(self._draining))

    def _retire(self, name: str, now: float) -> None:
        try:
            self.router.retire_replica(name)
        except (KeyError, ValueError) as e:
            # Raced a concurrent removal, or the fleet shrank to one
            # under us: un-cordon rather than strand the replica.
            self.router.uncordon_replica(name)
            self.metrics.event("autoscaler.retire_abandoned",
                               replica=name, error=str(e))
            with self._lock:
                self._draining.pop(name, None)
            return
        sup = self.supervisor
        if sup is not None and hasattr(sup, "forget"):
            sup.forget(name)
        with self._lock:
            self._draining.pop(name, None)
        gen = self._bump_epoch("scale_down", now)
        self.metrics.counter("autoscaler.scale_downs").inc()
        self.metrics.event("autoscaler.retire", replica=name,
                           epoch=gen)

    def _fail_open(self, name: str, now: float) -> None:
        """A victim still busy past the drain deadline is killed
        through the crash path instead of waited on forever: every
        in-flight callback fires ``None``, the router replays each
        request on a survivor (bit-identical by greedy determinism),
        and journaled accepts stay replayable — zero drops either
        way."""
        with self._lock:
            info = self._draining.get(name)
            if info is None:
                return
            info["forced"] = True
        self.metrics.event("autoscaler.drain_force", replica=name,
                           waited_s=now - info["since"])
        try:
            handle = self.router._handle(name)
        except KeyError:
            return
        die = getattr(handle, "_die", None)
        if callable(die):
            die()       # fires every in-flight callback with None
        else:
            self.router._mark_dead(name)

    # -- bookkeeping -------------------------------------------------------

    def _fresh_name(self) -> str:
        with self.router._lock:
            taken = {r.name for r in self.router.replicas}
        while True:
            name = f"auto{self._spawn_seq}"
            self._spawn_seq += 1
            if name not in taken:
                return name

    def _bump_epoch(self, reason: str, now: float) -> int:
        with self.router._lock:
            members = [r.name for r in self.router.replicas]
        gen = self.epoch.bump(members, reason, now)
        self.metrics.gauge("autoscaler.epoch").set(gen)
        return gen

    def _decide(self, now: float, rec: dict, action: str, why: str,
                record: bool = True, **extra: Any) -> dict:
        decision = {"t": now, "action": action, "why": why,
                    "advice": {k: rec.get(k)
                               for k in ("action", "n", "reason")},
                    **extra}
        with self._lock:
            self._last_decision = decision
            if record:
                self._history.append(decision)
        if record and action == "hold":
            self.metrics.event("autoscaler.hold", why=why,
                               advice=rec.get("action"))
        return decision

    # -- export ------------------------------------------------------------

    def draining(self) -> list[str]:
        with self._lock:
            return sorted(self._draining)

    def report(self) -> dict:
        """JSON-serializable autoscaler state (the ``/autoscaler``
        payload and the ``state_dump()`` line)."""
        with self.router._lock:
            size = len(self.router.replicas)
        with self._lock:
            draining = sorted(self._draining)
            history = list(self._history)
            last_decision = self._last_decision
        last_action = None
        for d in reversed(history):
            if d["action"] != "hold":
                last_action = d
                break
        return {
            "enabled": self.enabled,
            "size": size,
            "epoch": self.epoch.snapshot(),
            "cordoned": self.router.cordoned(),
            "draining": draining,
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "step": self.step,
            "cooldown_s": self.cooldown_s,
            "stable_s": self.stable_s,
            "drain_s": self.drain_s,
            "victim_policy": self.victim_policy.name,
            "last_action": last_action,
            "last_decision": last_decision,
            "history": history,
        }


def measure_autoscale_goodput(
        params: Any = None, cfg: Any = None, *,
        engines: "Sequence[Any] | None" = None,
        rate: float = 32.0, duration_s: float = 0.5,
        seed: int = 0, grow_n: int = 1,
        n_slots: int = 4, chunk: int = 16,
        max_len: "int | None" = None,
        timeout_s: float = 60.0) -> dict:
    """The ``serve_autoscale_*`` bench arm: goodput retention across a
    Bursty traffic step.

    Serves one seeded open-loop :class:`~horovod_tpu_torch.loadgen.Bursty`
    schedule against a single-replica fleet (the pre-step baseline),
    actuates a scripted ``scale_up(grow_n)`` through the live
    :class:`FleetAutoscaler` — supervisor factory seam, epoch bump and
    all — then serves the *same* schedule again on the grown fleet.
    ``retention = goodput_post / goodput_pre`` is the headline: how
    much of the burst's SLO-good work the grow won back.  The arm ends
    with a scripted scale-down so the zero-drop cordon → drain →
    retire path runs under the bench too; ``serve_autoscale_scale_ok``
    gates on the full round trip (grew, served on the new replica,
    retired back to one, epoch advanced twice).

    Pass ``engines`` to reuse an existing fleet seed-replica list
    (tests), or ``params``/``cfg`` to build one."""
    from horovod_tpu_torch import faults as faults_mod
    from horovod_tpu_torch.loadgen import (DEFAULT_TENANTS, Bursty,
                                     RequestMix, build_schedule,
                                     run_open_loop, summarize_rung)
    from horovod_tpu_torch.metrics import MetricsRegistry
    from horovod_tpu_torch.router import RouterServer
    from horovod_tpu_torch.serving import Request
    from horovod_tpu_torch.supervisor import ReplicaSupervisor

    mix = RequestMix(DEFAULT_TENANTS, seed)
    reg = MetricsRegistry()
    fr = faults_mod.FaultRegistry()
    if engines is None:
        from horovod_tpu_torch.serving_scheduler import ServeEngine
        if max_len is None:
            need = (max(t.prefix_len + t.prompt_len[1]
                        + t.new_tokens[1] for t in mix.tenants) + chunk)
            max_len = -(-need // chunk) * chunk      # block-aligned
        engines = [ServeEngine(params, cfg, n_slots=n_slots,
                               max_len=max_len, chunk=chunk,
                               prefix_cache=True, metrics=reg,
                               faults=fr)]
    for eng in engines:
        eng.run([Request(prompt=[1] * (eng.chunk + 1),
                         max_new_tokens=2)])
    router = RouterServer(engines, registry=reg, faults=fr)
    sup = ReplicaSupervisor(router, backoff_s=0.01, warm_prefixes=4)
    asc = FleetAutoscaler(router, supervisor=sup, enabled=True,
                          cooldown_s=0.0, stable_s=0.0,
                          min_replicas=1,
                          max_replicas=len(engines) + grow_n,
                          step=grow_n, drain_s=0.0, faults=fr)
    base_size = len(engines)
    sched = build_schedule(Bursty(rate, seed), mix, duration_s, seed)
    try:
        pre = summarize_rung(
            run_open_loop(router, sched, timeout_s=timeout_s),
            offered_rps=rate, duration_s=duration_s)
        grow = asc.actuate({"action": "scale_up", "n": grow_n,
                            "reason": "bench traffic step"})
        post = summarize_rung(
            run_open_loop(router, sched, timeout_s=timeout_s),
            offered_rps=rate, duration_s=duration_s)
        shrink = asc.actuate({"action": "scale_down", "n": grow_n,
                              "reason": "bench step over"})
        deadline = time.monotonic() + timeout_s
        while asc.draining() and time.monotonic() < deadline:
            router.poll_now()
            time.sleep(0.005)
        router.reap_tickets(0)
        leaked = router.memory_report()["tickets"]
        with router._lock:
            final_size = len(router.replicas)
        epoch = asc.epoch.generation
    finally:
        router.stop()
    grown = list(grow.get("replicas", []))
    scale_ok = (grow["action"] == "scale_up"
                and shrink["action"] == "scale_down"
                and final_size == base_size
                and epoch >= 2 and leaked == 0)
    retention = (post["goodput"] / pre["goodput"]
                 if pre["goodput"] > 0 else float(post["goodput"] > 0))
    return {
        "serve_autoscale_seed": seed,
        "serve_autoscale_rate_rps": rate,
        "serve_autoscale_duration_s": duration_s,
        "serve_autoscale_requests": pre["n"] + post["n"],
        "serve_autoscale_goodput_pre": pre["goodput"],
        "serve_autoscale_goodput_post": post["goodput"],
        "serve_autoscale_goodput_retention": retention,
        "serve_autoscale_p99_ttft_pre_ms": pre["p99_ttft_s"] * 1e3,
        "serve_autoscale_p99_ttft_post_ms": post["p99_ttft_s"] * 1e3,
        "serve_autoscale_grown_replicas": grown,
        "serve_autoscale_final_replicas": final_size,
        "serve_autoscale_epoch": epoch,
        "serve_autoscale_scale_ok": scale_ok,
    }


def maybe_autoscaler(router: Any) -> "FleetAutoscaler | None":
    """A :class:`FleetAutoscaler` per the env contract: needs
    ``HVD_TORCH_AUTOSCALE`` truthy AND a capacity advisor on the router
    (i.e. a live sampler).  Mirrors ``maybe_sampler``/``maybe_alerts``
    — unset means off, silently."""
    if os.environ.get("HVD_TORCH_AUTOSCALE", "0") in ("", "0"):
        return None
    if getattr(router, "advisor", None) is None:
        return None
    return FleetAutoscaler(router, enabled=True)
