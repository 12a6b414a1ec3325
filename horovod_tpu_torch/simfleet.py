"""Fleet-scale simulation harness: hundreds of replicas under chaos
through the REAL control plane.  Port of ``horovod_tpu/simfleet.py``; it
runs no framework code, so a seed's campaign report is the reference's,
field for field, apart from wall-clock times.

Every robustness mechanism in the serving stack — failover replay, the
crash-durable journal, supervisor respawn, cordon→drain→retire,
burn-rate alerts, the autoscaler's guards — runs unmodified here; only
the replicas are simulated.  A :class:`SimReplica` models prefill /
decode / queue latency from a measured :class:`PhaseProfile` (seeded
per-replica jitter, finite KV capacity, straggler and slow-start
modes) instead of running a model, and a :class:`SimFleet` driver advances
the router poll pass, sampler ticks, supervisor backoff clocks, and
alert hysteresis windows on one shared :class:`SimClock` — so a
campaign of 200+ replicas × 100k+ requests, with crash storms,
partition waves, straggler epidemics, and KV-exhaustion ramps, runs in
seconds of wall time and is bit-reproducible from its seed.

The split mirrors :mod:`horovod_tpu_torch.loadgen`'s ``VirtualClock`` (time
is synthetic, order is real): everything the control plane *computes*
— ticket stamps, reap TTLs, backoff deadlines, alert windows — reads
the injected clock, while the poll pass itself still costs real host
work (``router.poll_s`` measures that on the wall; the sub-linear
oracle keys off it).

Campaign oracles (:func:`run_sim_campaign`) extend the chaos set:
keyed requests stay exactly-once across crash storms and epoch bumps,
tickets and journal memory stay bounded, every fired alert resolves,
the autoscaler converges without flapping, the shadow-index union
respects the fleet byte ceiling, and the poll pass stays sub-linear
per replica as the fleet grows.  Reports share the
:func:`horovod_tpu_torch.chaos.compare_campaigns` gate shape, so
``python -m horovod_tpu_torch.tools.simfleet_run --compare`` reuses it
verbatim.
"""

from __future__ import annotations

import collections
import dataclasses
import heapq
import math
import random
import time
from typing import Any, Callable, Sequence

from horovod_tpu_torch import metrics as metrics_mod
from horovod_tpu_torch.loadgen import Poisson, RequestMix, TenantSpec, \
    build_schedule
from horovod_tpu_torch.monitor import env_float
from horovod_tpu_torch.router import ReplicaHandle, RouterServer
from horovod_tpu_torch.serving import FAILED, OK, REJECTED, Request, \
    RequestResult
from horovod_tpu_torch.supervisor import ReplicaSupervisor


class SimClock:
    """The shared virtual clock: a zero-arg callable (the shape every
    control-plane ``clock=`` seam takes) whose time only moves when the
    driver says so.  The whole fleet — router bookkeeping, supervisor
    backoff, sampler cadence, alert hysteresis — reads one instance, so
    a campaign's notion of "now" is a pure function of the step loop."""

    def __init__(self, start: float = 0.0) -> None:
        self.t = float(start)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


@dataclasses.dataclass(frozen=True)
class PhaseProfile:
    """Measured per-phase latency model (the serve profiler's report
    shape, collapsed to a linear fit): a request's service time is
    ``prefill_base_s + prefill_s_per_token * len(prompt) +
    decode_s_per_token * max_new_tokens``.  Defaults approximate the
    CPU rehearsal engine; campaigns can load real ``serve.phase.*``
    fits without touching the driver."""

    prefill_base_s: float = 0.012
    prefill_s_per_token: float = 0.0004
    decode_s_per_token: float = 0.009

    def service_s(self, prompt_tokens: int, new_tokens: int) -> float:
        return (self.prefill_base_s
                + self.prefill_s_per_token * prompt_tokens
                + self.decode_s_per_token * new_tokens)


def sim_tokens(req: Request) -> list[int]:
    """The simulated engine's deterministic output: a pure function of
    the request, so failover replay on a different SimReplica is
    bit-identical to the first attempt — the same greedy-determinism
    contract the real engine gives the router."""
    h = 0
    for tok in req.prompt:
        h = (h * 1000003 + int(tok) + 1) & 0xFFFFFFFF
    return [(h + i) % 50257 for i in range(req.max_new_tokens)]


class SimReplica(ReplicaHandle):
    """A latency-model replica behind the real handle interface.

    Single-threaded by contract: the driver owns submit / advance /
    probe (no pump thread, no locks), and completion callbacks fire
    inside :meth:`advance_to` — reentrantly safe against the router's
    failover path, which may submit back into another SimReplica from
    within a callback (the ``LocalReplica`` dead-on-arrival precedent).

    Chaos surface: :meth:`kill` (process loss — every in-flight and
    queued callback fires ``None``, the router's failover signal),
    :meth:`partition` (probes raise for a window; the replica keeps
    serving, modeling a healthy backend behind a broken health path),
    :meth:`set_slow` (straggler multiplier), and :meth:`leak_kv` /
    :meth:`heal_kv` (KV-exhaustion pressure: leaked blocks admit
    nothing until healed).  ``can_revive`` is True so a healed
    partition rejoins through probe revival, while a kill heals
    through the supervisor's factory respawn."""

    can_revive = True

    def __init__(self, name: str, clock: Callable[[], float], *,
                 profile: "PhaseProfile | None" = None, seed: int = 0,
                 n_slots: int = 4, kv_blocks: int = 64,
                 tokens_per_block: int = 16, jitter: float = 0.08,
                 slow_start_s: float = 0.0,
                 slow_start_factor: float = 3.0):
        self.name = name
        self.clock = clock
        self.profile = profile if profile is not None else PhaseProfile()
        self.block_size = tokens_per_block
        self.n_slots = n_slots
        self.kv_blocks = kv_blocks
        self.tokens_per_block = tokens_per_block
        self.jitter = jitter
        self.slow_start_s = slow_start_s
        self.slow_start_factor = slow_start_factor
        self.rng = random.Random(f"simreplica:{seed}:{name}")
        self.born_t = clock()
        self.slow_factor = 1.0
        self.dead = False
        self.completed = 0
        self.submitted = 0
        #: Fired with the request on every admission — the fleet's
        #: execution odometer (exactly-once accounting sees replays).
        self.on_execute: "Callable[[Request], None] | None" = None
        self._free = kv_blocks
        self._leaked = 0
        self._queue: collections.deque = collections.deque()
        self._running: list = []        # heap of (finish_t, seq, ...)
        self._seq = 0
        self._partition_until: "float | None" = None

    # -- handle interface --------------------------------------------------

    def submit(self, req: Request, done_cb: Callable) -> None:
        if self.dead:
            done_cb(None)       # dead on arrival: failover signal
            return
        self.submitted += 1
        if not req.prompt:
            # Poison request: the simulated engine load-sheds it the
            # way the real admission path does — terminal REJECTED,
            # no collateral damage.
            done_cb(RequestResult([], REJECTED))
            return
        self._queue.append((req, done_cb, self.clock()))
        self._admit(self.clock())

    def probe(self) -> dict:
        now = self.clock()
        if self._partition_until is not None:
            if now < self._partition_until:
                raise ConnectionError(
                    f"{self.name}: probe partitioned until "
                    f"{self._partition_until:g}")
            self._partition_until = None
        if self.dead:
            return {"healthy": False}
        return {
            "healthy": True,
            "inflight": len(self._running),
            "queue_depth": len(self._queue),
            "goodput": min(1.0, 1.0 / max(self._slow_mult(now), 1.0)),
            "free_kv_frac": max(self._free - self._leaked, 0)
            / max(self.kv_blocks, 1),
            "tp_size": 1,
        }

    def stop(self) -> None:
        # Retire/replace path: anything still on board fails over.
        self.kill()

    # -- the latency model -------------------------------------------------

    def _slow_mult(self, now: float) -> float:
        mult = self.slow_factor
        if self.slow_start_s > 0 and now - self.born_t < self.slow_start_s:
            mult *= self.slow_start_factor
        return mult

    def _blocks_for(self, req: Request) -> int:
        tokens = len(req.prompt) + req.max_new_tokens
        return max(math.ceil(tokens / max(self.tokens_per_block, 1)), 1)

    def _admit(self, now: float) -> None:
        while self._queue and len(self._running) < self.n_slots:
            req, cb, _t = self._queue[0]
            blocks = self._blocks_for(req)
            if blocks > self._free - self._leaked:
                break           # KV pressure: wait for frees (or heal)
            self._queue.popleft()
            self._free -= blocks
            service = (self.profile.service_s(len(req.prompt),
                                              req.max_new_tokens)
                       * self._slow_mult(now)
                       * self.rng.uniform(1.0 - self.jitter,
                                          1.0 + self.jitter))
            self._seq += 1
            heapq.heappush(self._running,
                           (now + service, self._seq, req, cb, blocks))
            if self.on_execute is not None:
                self.on_execute(req)

    def advance_to(self, now: float) -> int:
        """Fire every completion due by virtual ``now``, then admit
        from the queue; returns how many requests finished."""
        if self.dead:
            return 0
        fired = 0
        while self._running and self._running[0][0] <= now:
            _t, _seq, req, cb, blocks = heapq.heappop(self._running)
            self._free += blocks
            self.completed += 1
            fired += 1
            cb(RequestResult(sim_tokens(req), OK))
        if fired or self._queue:
            self._admit(now)
        return fired

    # -- chaos surface -----------------------------------------------------

    def kill(self) -> None:
        """Process loss: every accepted-but-unfinished request fires
        ``None`` so the router replays it on survivors.  Idempotent."""
        if self.dead:
            return
        self.dead = True
        pending = [cb for _t, _s, _r, cb, _b in self._running]
        pending.extend(cb for _r, cb, _t in self._queue)
        self._running = []
        self._queue.clear()
        self._free = self.kv_blocks
        self._leaked = 0
        for cb in pending:
            cb(None)

    def partition(self, duration_s: float) -> None:
        """Probes raise for ``duration_s`` of virtual time; serving
        continues underneath (the classic health-path partition)."""
        self._partition_until = self.clock() + duration_s

    def set_slow(self, factor: float) -> None:
        self.slow_factor = max(float(factor), 1.0)

    def leak_kv(self, frac: float) -> int:
        """Mark ``frac`` of this replica's TOTAL KV pool leaked —
        unavailable to admission until :meth:`heal_kv` — and return the
        leaked block count."""
        self._leaked = min(int(self.kv_blocks * frac), self.kv_blocks)
        return self._leaked

    def heal_kv(self) -> None:
        self._leaked = 0


class SimSupervisor(ReplicaSupervisor):
    """The supervisor with a whole-namespace factory seam: ANY dead
    replica respawns as (and any autoscaler grow spawns) a fresh
    :class:`SimReplica` from the owning fleet's template — the real
    respawn bookkeeping (budget, backoff, replace_replica) stays in
    charge; only handle construction is simulated."""

    def __init__(self, router: RouterServer, fleet: "SimFleet",
                 **kw: Any) -> None:
        super().__init__(router, **kw)
        self._fleet = fleet

    def _factory_for(self, handle: ReplicaHandle):
        return lambda: self._fleet.make_replica(handle.name)

    def spawn_replica(self, name: str,
                      template: "ReplicaHandle | None" = None,
                      ) -> "ReplicaHandle | None":
        return self._fleet.make_replica(name)


class SimFleet:
    """N simulated replicas behind one REAL router + supervisor +
    autoscaler + alert plane, all on a shared :class:`SimClock`.

    The driver is single-threaded: :meth:`run` interleaves chaos
    events, arrival submission, replica advancement, fleet-gauge
    refresh, and the router's ``poll_now`` pass per virtual step, then
    sweeps terminal tickets so the ticket table tracks true in-flight.
    Nothing sleeps; virtual seconds cost microseconds."""

    def __init__(self, n_replicas: int, *, seed: int = 0,
                 profile: "PhaseProfile | None" = None,
                 policy: str = "round_robin",
                 journal: "str | None" = None,
                 n_slots: int = 4, kv_blocks: int = 64,
                 tokens_per_block: int = 16, jitter: float = 0.08,
                 sample_s: float = 0.25,
                 alert_time_scale: float = 0.05,
                 poll_every: float = 0.2, probe_fails: int = 2,
                 shadow_max_bytes: "int | None" = None,
                 ticket_ttl_s: float = 600.0,
                 supervise_backoff_s: float = 0.25,
                 max_restarts: int = 4,
                 autoscale_cooldown_s: float = 2.0,
                 autoscale_drain_s: float = 5.0,
                 max_replicas: "int | None" = None,
                 knee_rps: "float | None" = None,
                 slo_window: int = 512):
        from horovod_tpu_torch import alerts as alerts_mod
        from horovod_tpu_torch import timeseries as timeseries_mod
        from horovod_tpu_torch.autoscaler import FleetAutoscaler

        self.seed = seed
        self.profile = profile if profile is not None else PhaseProfile()
        self.n_slots = n_slots
        self.kv_blocks = kv_blocks
        self.tokens_per_block = tokens_per_block
        self.jitter = jitter
        self.poll_every = poll_every
        self.clock = SimClock()
        self.registry = metrics_mod.MetricsRegistry()
        self.executions: collections.Counter = collections.Counter()
        #: Every SimReplica ever constructed — replaced handles must be
        #: reaped (see ``_kill_orphans``) or their callbacks leak.
        self._spawned: list[SimReplica] = []
        replicas = [self.make_replica(f"sim{i}")
                    for i in range(n_replicas)]
        self.sampler = timeseries_mod.MetricsSampler(
            self.registry, sample_s=sample_s, raw_points=4096,
            clock=self.clock)
        self.alerts = alerts_mod.AlertManager(
            self.sampler, registry=self.registry,
            time_scale=alert_time_scale, clock=self.clock)
        # None keeps the router's own shadow ceiling (the reference's
        # default, an argument here where the reference reads a knob)
        bound = ({} if shadow_max_bytes is None
                 else {"shadow_max_bytes": shadow_max_bytes})
        self.router = RouterServer(
            replicas, policy=policy, registry=self.registry,
            sampler=self.sampler, alerts=self.alerts, journal=journal,
            poll_s=poll_every, probe_fails=probe_fails,
            ticket_ttl_s=ticket_ttl_s, drain_s=0.0, clock=self.clock,
            **bound)
        if knee_rps is not None:
            # Demand-sized advisor over the same virtual clock: the
            # knee a real bench would have written.
            self.router.advisor = alerts_mod.CapacityAdvisor(
                self.sampler, alerts=self.alerts,
                registry=self.registry,
                load_report={"serve_load_knee_goodput_rps": knee_rps},
                window_s=10.0, clock=self.clock)
        self.supervisor = SimSupervisor(
            self.router, self, max_restarts=max_restarts,
            backoff_s=supervise_backoff_s, warm_prefixes=0,
            clock=self.clock)
        self.autoscaler = FleetAutoscaler(
            self.router, supervisor=self.supervisor, enabled=False,
            cooldown_s=autoscale_cooldown_s, stable_s=0.0,
            min_replicas=1,
            max_replicas=(max_replicas if max_replicas is not None
                          else n_replicas + 8),
            step=8, drain_s=autoscale_drain_s, clock=self.clock)
        # Windowed fleet SLO accounting behind the serve.* gauges the
        # advisor and burn-rate rules read.
        self._slo_window: collections.deque = collections.deque(
            maxlen=slo_window)
        self._completed_total = 0
        self._completed_gauged = 0
        self.outstanding: dict[int, dict] = {}
        self.stats = {"submitted": 0, "delivered": 0, "ok": 0,
                      "rejected": 0, "failed": 0, "mismatches": 0,
                      "steps": 0, "polls": 0}
        self.keyed_results: dict[str, tuple[str, tuple]] = {}

    # -- replica factory ---------------------------------------------------

    def make_replica(self, name: str) -> SimReplica:
        """Template factory for initial build, supervisor respawn, and
        autoscaler grow alike — a pure function of (fleet seed, name),
        so a respawned replica's jitter stream is reproducible."""
        r = SimReplica(name, self.clock, profile=self.profile,
                       seed=self.seed, n_slots=self.n_slots,
                       kv_blocks=self.kv_blocks,
                       tokens_per_block=self.tokens_per_block,
                       jitter=self.jitter)
        r.on_execute = self._on_execute
        self._spawned.append(r)
        return r

    def _on_execute(self, req: Request) -> None:
        self.executions[tuple(req.prompt)] += 1

    def sim_replicas(self) -> list[SimReplica]:
        return [r for r in list(self.router.replicas)
                if isinstance(r, SimReplica)]

    def _kill_orphans(self) -> None:
        """Kill any spawned handle the router no longer owns.  A real
        supervisor SIGKILLs the old process before committing a
        respawn, and the dying pump fires ``None`` for everything
        aboard; the sim equivalent is explicit — a replaced handle
        (e.g. a partitioned-but-alive replica the supervisor gave up
        on) must fail its passengers over or they hang forever."""
        current = {id(r): True for r in list(self.router.replicas)}
        survivors = []
        for r in self._spawned:
            if id(r) in current:
                survivors.append(r)
            elif not r.dead:
                r.kill()
        self._spawned = survivors

    # -- the step loop -----------------------------------------------------

    def submit(self, req: Request, *, arrival_t: float,
               key: "str | None" = None) -> int:
        rid = self.router.route(req, idempotency_key=key)
        self.stats["submitted"] += 1
        self.outstanding[rid] = {"t": arrival_t, "req": req, "key": key}
        return rid

    def _sweep(self, now: float) -> int:
        """Collect every terminal ticket (scoring SLO and bit-stability
        on the way) and reap it, so the ticket table only ever holds
        true in-flight work."""
        done = 0
        for rid in list(self.outstanding):
            res = self.router.result(rid, timeout=0)
            if res is None:
                continue
            rec = self.outstanding.pop(rid)
            done += 1
            self.stats["delivered"] += 1
            req = rec["req"]
            if res.status == OK:
                self.stats["ok"] += 1
                if list(res) != sim_tokens(req):
                    self.stats["mismatches"] += 1
                met = (req.slo_s is None
                       or now - rec["t"] <= req.slo_s)
                self._slo_window.append(1 if met else 0)
                self._completed_total += 1
            elif res.status == REJECTED:
                self.stats["rejected"] += 1
                self._slo_window.append(0)
            else:
                self.stats["failed"] += 1
                self._slo_window.append(0)
            if rec["key"] is not None:
                self.keyed_results[rec["key"]] = (res.status,
                                                  tuple(res))
        if done:
            self.router.reap_tickets(0.0)
        return done

    def _refresh_gauges(self) -> None:
        """Drive the fleet-level serve.* series the advisor and alert
        rules read — the aggregation the real fleet's engines feed."""
        reps = self.sim_replicas()
        queue = sum(len(r._queue) for r in reps)
        free = sum(max(r._free - r._leaked, 0) for r in reps)
        if self._slo_window:
            goodput = sum(self._slo_window) / len(self._slo_window)
        else:
            goodput = 1.0
        self.registry.gauge("serve.goodput").set(goodput)
        self.registry.gauge("serve.queue_depth").set(queue)
        self.registry.gauge("kv.free_blocks").set(free)
        delta = self._completed_total - self._completed_gauged
        if delta:
            self.registry.counter("serve.requests_completed").inc(delta)
            self._completed_gauged = self._completed_total

    def run(self, schedule: Sequence[Any], *,
            events: Sequence[tuple] = (), step_s: float = 0.05,
            key_every: int = 0, settle_s: float = 30.0,
            max_virtual_s: float = 600.0) -> dict:
        """Drive the whole offered ``schedule`` (loadgen ``Arrival``
        rows) plus chaos ``events`` (``(t, fn)`` pairs, ``fn(fleet)``)
        through the fleet, then settle: keep ticking until everything
        is terminal, no alert is firing, and no drain is in flight —
        so "every fired alert resolves" is observed, not assumed.
        ``key_every > 0`` gives every k-th arrival an idempotency key
        (requires a journaled router).  Returns the run stats."""
        arrivals = collections.deque(schedule)
        pending_events = collections.deque(
            sorted(events, key=lambda e: e[0]))
        traffic_end = schedule[-1].t if len(schedule) else 0.0
        next_poll = 0.0
        idx = 0
        wall0 = time.perf_counter()
        while True:
            now = self.clock()
            while pending_events and pending_events[0][0] <= now:
                _t, fn = pending_events.popleft()
                fn(self)
            while arrivals and arrivals[0].t <= now:
                a = arrivals.popleft()
                key = (f"sim-key-{idx}"
                       if key_every and idx % key_every == 0 else None)
                self.submit(a.req, arrival_t=a.t, key=key)
                idx += 1
            for r in self.sim_replicas():
                r.advance_to(now)
            self._refresh_gauges()
            if now >= next_poll:
                self.router.poll_now()
                self._kill_orphans()
                self.stats["polls"] += 1
                next_poll = now + self.poll_every
            self._sweep(now)
            self.stats["steps"] += 1
            if (not arrivals and not pending_events
                    and not self.outstanding
                    and now >= traffic_end + settle_s
                    and not self.alerts.firing()
                    and not self.autoscaler.draining()):
                break
            if now >= max_virtual_s:
                break       # stall backstop: oracles will tell
            self.clock.advance(step_s)
        out = dict(self.stats)
        out["virtual_s"] = self.clock()
        out["wall_s"] = time.perf_counter() - wall0
        return out

    def close(self) -> None:
        self.router.stop()


# -- chaos-at-scale scenario builders --------------------------------------


def crash_storm(seed: int, *, n_kills: int, t0: float,
                t1: float) -> list[tuple]:
    """Seeded kill schedule: ``n_kills`` process losses at uniform
    times in ``[t0, t1)``, each victim drawn at fire time from the
    then-alive simulated replicas (so a respawned replica is back in
    the blast radius — the production property)."""
    rng = random.Random(f"sim-crash:{seed}")
    times = sorted(rng.uniform(t0, t1) for _ in range(n_kills))

    def _kill(fleet: SimFleet) -> None:
        alive = [r for r in fleet.sim_replicas() if not r.dead]
        if alive:
            rng.choice(alive).kill()

    return [(t, _kill) for t in times]


def partition_wave(seed: int, *, t: float, frac: float,
                   duration_s: float) -> list[tuple]:
    """Correlated probe-failure injection: a contiguous ``frac`` of
    the fleet (a rack, a switch) answers no health probes for
    ``duration_s`` while still serving — the router must debounce,
    fail over routing, and revive them on heal."""
    rng = random.Random(f"sim-partition:{seed}")

    def _partition(fleet: SimFleet) -> None:
        reps = [r for r in fleet.sim_replicas() if not r.dead]
        if not reps:
            return
        n = max(int(len(reps) * frac), 1)
        start = rng.randrange(len(reps))
        for i in range(n):
            reps[(start + i) % len(reps)].partition(duration_s)

    return [(t, _partition)]


def straggler_epidemic(seed: int, *, t: float, frac: float,
                       factor: float, duration_s: float) -> list[tuple]:
    """A random subset of replicas slows by ``factor`` for
    ``duration_s`` — SLO misses accumulate, goodput sags, the
    burn-rate pair gets something to fire on — then recovers."""
    rng = random.Random(f"sim-straggler:{seed}")
    sick: list[SimReplica] = []

    def _infect(fleet: SimFleet) -> None:
        reps = [r for r in fleet.sim_replicas() if not r.dead]
        if not reps:
            return
        n = max(int(len(reps) * frac), 1)
        sick.extend(rng.sample(reps, min(n, len(reps))))
        for r in sick:
            r.set_slow(factor)

    def _recover(fleet: SimFleet) -> None:
        for r in sick:
            r.set_slow(1.0)

    return [(t, _infect), (t + duration_s, _recover)]


def kv_exhaustion(seed: int, *, t: float, frac: float,
                  duration_s: float, ramp_steps: int = 5,
                  leak_to: float = 0.95) -> list[tuple]:
    """A gradual KV leak across ``frac`` of the fleet: free blocks
    ramp down over ``ramp_steps`` events (a believable slope for the
    ``kv_exhaustion`` time-to-empty alert), pin near exhaustion, then
    heal at ``t + duration_s``."""
    rng = random.Random(f"sim-kv:{seed}")
    leaking: list[SimReplica] = []

    def _start(fleet: SimFleet) -> None:
        reps = [r for r in fleet.sim_replicas() if not r.dead]
        if not reps:
            return
        n = max(int(len(reps) * frac), 1)
        leaking.extend(rng.sample(reps, min(n, len(reps))))

    def _leak(step: int) -> Callable:
        def _fn(fleet: SimFleet) -> None:
            for r in leaking:
                if not r.dead:
                    r.leak_kv(leak_to * (step + 1) / ramp_steps)
        return _fn

    def _heal(fleet: SimFleet) -> None:
        for r in leaking:
            r.heal_kv()

    ramp_span = duration_s * 0.6
    events: list[tuple] = [(t, _start)]
    events.extend((t + ramp_span * (i + 1) / ramp_steps, _leak(i))
                  for i in range(ramp_steps))
    events.append((t + duration_s, _heal))
    return events


def scripted_scale(t: float, action: str, n: int) -> list[tuple]:
    """A scripted autoscaler actuation (epoch bump under load): grow
    spawns fresh SimReplicas through the supervisor seam, shrink
    cordons a victim into the real drain→retire path."""

    def _actuate(fleet: SimFleet) -> None:
        fleet.autoscaler.actuate(
            {"action": action, "n": n,
             "reason": f"sim campaign scripted {action}"})

    return [(t, _actuate)]


# -- the campaign ----------------------------------------------------------

#: The campaign's two-tenant offered mix: the loadgen default shape
#: minus deadlines (virtual time would expire wall deadlines wrongly).
SIM_TENANTS: tuple = (
    TenantSpec("interactive", weight=3.0, prompt_len=(4, 12),
               new_tokens=(4, 8), shared_prefixes=4, prefix_len=16,
               slo_s=2.0),
    TenantSpec("batch", weight=1.0, prompt_len=(16, 40),
               new_tokens=(8, 16), slo_s=10.0),
)


def measure_poll_scaling(*, seed: int = 0, n_small: int = 50,
                         n_big: int = 200, polls: int = 20) -> dict:
    """Median wall cost of one idle ``poll_now`` pass at two fleet
    sizes.  The oracle wants per-replica cost roughly flat (an O(N²)
    regression shows up as the ratio approaching N_big/N_small); the
    pass is timed on the wall because the poll's host work is exactly
    what virtual time cannot compress."""
    costs = {}
    for n in (n_small, n_big):
        fleet = SimFleet(n, seed=seed)
        try:
            samples = []
            for _ in range(polls):
                t0 = time.perf_counter()
                fleet.router.poll_now()
                samples.append(time.perf_counter() - t0)
                fleet.clock.advance(fleet.poll_every)
            samples.sort()
            costs[n] = samples[len(samples) // 2]
        finally:
            fleet.close()
    per_small = costs[n_small] / n_small
    per_big = costs[n_big] / n_big
    ratio = per_big / per_small if per_small > 0 else float("inf")
    return {"n_small": n_small, "n_big": n_big,
            "poll_s_small": costs[n_small], "poll_s_big": costs[n_big],
            "per_replica_ratio": ratio,
            "sublinear": ratio <= 2.5}


def run_sim_campaign(*, seed: "int | None" = None,
                     n_replicas: "int | None" = None,
                     n_requests: "int | None" = None,
                     journal: "str | None" = None,
                     key_every: int = 100,
                     utilization: float = 0.45,
                     shadow_max_bytes: int = 256 * 1024,
                     poll_scaling: bool = True,
                     step_s: float = 0.05) -> dict:
    """One full fleet-scale chaos campaign through the real control
    plane, bit-reproducible from ``seed``: a Poisson workload sized to
    ``utilization`` of fleet capacity, overlaid with a crash storm,
    a partition wave, a straggler epidemic, a KV-exhaustion ramp, and
    two scripted autoscaler epoch bumps — then the invariant oracles.

    Defaults come from the env knobs (``HVD_TORCH_SIM_SEED`` /
    ``HVD_TORCH_SIM_REPLICAS`` / ``HVD_TORCH_SIM_REQUESTS``); the report
    shares :func:`horovod_tpu_torch.chaos.compare_campaigns`'s gate shape
    (``oracles`` / ``ok`` / ``ok_fraction``)."""
    import tempfile

    if seed is None:
        seed = int(env_float("HVD_TORCH_SIM_SEED", 0))
    if n_replicas is None:
        n_replicas = int(env_float("HVD_TORCH_SIM_REPLICAS", 200))
    if n_requests is None:
        n_requests = int(env_float("HVD_TORCH_SIM_REQUESTS", 100000))
    if journal is None:
        journal = tempfile.mktemp(prefix=f"hvd-simfleet-{seed}-",
                                  suffix=".jsonl")

    profile = PhaseProfile()
    mean_service = profile.service_s(25, 8)
    capacity_rps = 4 * n_replicas / mean_service
    offered_rps = capacity_rps * utilization
    duration_s = 1.04 * n_requests / offered_rps

    # The two scripted epoch bumps sit 0.45*duration apart; the
    # cooldown guard must scale with the (request-count-dependent)
    # campaign duration or a short run silently holds the scale_down.
    fleet = SimFleet(n_replicas, seed=seed, profile=profile,
                     journal=journal,
                     shadow_max_bytes=shadow_max_bytes,
                     autoscale_cooldown_s=min(2.0, 0.1 * duration_s))
    mix = RequestMix(SIM_TENANTS, seed=seed)
    schedule = build_schedule(Poisson(offered_rps, seed), mix,
                              duration_s, seed)

    d = duration_s
    events: list[tuple] = []
    events += crash_storm(seed, n_kills=max(n_replicas // 10, 4),
                          t0=0.10 * d, t1=0.70 * d)
    events += partition_wave(seed, t=0.30 * d, frac=0.10,
                             duration_s=0.08 * d)
    events += straggler_epidemic(seed, t=0.45 * d, frac=0.15,
                                 factor=8.0, duration_s=0.15 * d)
    events += kv_exhaustion(seed, t=0.55 * d, frac=0.60,
                            duration_s=0.20 * d)
    events += scripted_scale(0.35 * d, "scale_up", 4)
    events += scripted_scale(0.80 * d, "scale_down", 2)

    try:
        stats = fleet.run(schedule, events=events, step_s=step_s,
                          key_every=key_every,
                          settle_s=max(0.8 * d, 20.0),
                          max_virtual_s=4.0 * d + 120.0)

        # Exactly-once probe: after every keyed original is terminal,
        # re-issue each key and demand the journaled answer — same
        # status, same bits, zero replica executions.
        router = fleet.router
        dedups_before = router.metrics.counter(
            "router.journal_dedups").value
        dup_mismatches = 0
        keyed = sorted(fleet.keyed_results.items())
        for key, (status, tokens) in keyed:
            rid = router.route(
                Request(prompt=list(range(3)), max_new_tokens=1),
                idempotency_key=key)
            dup = router.result(rid, timeout=0)
            if (dup is None or dup.status != status
                    or tuple(dup) != tokens):
                dup_mismatches += 1
        router.reap_tickets(0.0)
        dedups = (router.metrics.counter("router.journal_dedups").value
                  - dedups_before)

        leaked_tickets = router.memory_report()["tickets"]
        journal_results = len(router._journal_results)
        journal_inflight = len(router._journal_inflight)
        shadow_bytes = router._shadow_bytes()
        evictions = router.metrics.counter(
            "router.shadow_evictions").value
        _code, health = router.health()
        alert_states = fleet.alerts.states()
        fired_rules = sorted(n for n, st in alert_states.items()
                             if st["fired"])
        unresolved = sorted(n for n, st in alert_states.items()
                            if st["fired"] and st["state"] != "ok")
        asc_report = fleet.autoscaler.report()
        actions = [h for h in asc_report["history"]
                   if h.get("action") in ("scale_up", "scale_down")]
        flaps = [(a, b) for a, b in zip(actions, actions[1:])
                 if a["action"] != b["action"]
                 and b["t"] - a["t"] < fleet.autoscaler.cooldown_s]

        scaling = (measure_poll_scaling(seed=seed)
                   if poll_scaling else None)

        oracles = {
            "all_terminal": (stats["delivered"] == stats["submitted"]
                             and not fleet.outstanding),
            "bit_stable": stats["mismatches"] == 0
            and dup_mismatches == 0,
            "exactly_once": (dup_mismatches == 0
                             and dedups >= len(keyed)),
            "no_leaked_tickets": leaked_tickets == 0,
            "journal_bounded": (journal_results <= router.journal_keys
                                and journal_inflight == 0),
            "alerts_resolve": not unresolved,
            "alerts_exercised": len(fired_rules) > 0,
            "no_autoscaler_flap": (not flaps
                                   and not fleet.autoscaler.draining()),
            "epoch_advanced": asc_report["epoch"]["generation"] >= 2,
            "healed": health["healthy"] == health["replicas"],
            "shadow_bounded": (shadow_max_bytes <= 0
                               or shadow_bytes <= shadow_max_bytes),
        }
        if scaling is not None:
            oracles["poll_sublinear"] = scaling["sublinear"]
        report = {
            "seed": seed,
            "n_replicas": n_replicas,
            "n_requests": stats["submitted"],
            "n_ok": stats["ok"],
            "ok_fraction": (stats["ok"] / stats["submitted"]
                            if stats["submitted"] else 0.0),
            "delivered": stats["delivered"],
            "rejected": stats["rejected"],
            "failed": stats["failed"],
            "virtual_s": stats["virtual_s"],
            "wall_s": stats["wall_s"],
            "steps": stats["steps"],
            "polls": stats["polls"],
            "keyed": len(keyed),
            "journal_dedups": dedups,
            "failovers": int(router.metrics.counter(
                "router.failovers").value),
            "replica_deaths": int(router.metrics.counter(
                "router.replica_deaths").value),
            "respawns": int(router.metrics.counter(
                "supervisor.respawns").value),
            "shadow_bytes": shadow_bytes,
            "shadow_evictions": int(evictions),
            "alerts": {"fired": fired_rules, "unresolved": unresolved},
            "epoch": asc_report["epoch"]["generation"],
            "poll_scaling": scaling,
            "oracles": oracles,
            "ok": all(oracles.values()),
        }
        return report
    finally:
        fleet.close()


def measure_simfleet(*, seed: "int | None" = None,
                     n_replicas: "int | None" = None,
                     n_requests: "int | None" = None) -> dict:
    """The ``serve_simfleet_*`` bench arm: one seeded campaign at the
    configured scale, reporting throughput-in-virtual-time, goodput
    retention, and the oracle verdict (the gate key)."""
    report = run_sim_campaign(seed=seed, n_replicas=n_replicas,
                              n_requests=n_requests)
    return {
        "serve_simfleet_seed": report["seed"],
        "serve_simfleet_replicas": report["n_replicas"],
        "serve_simfleet_requests": report["n_requests"],
        "serve_simfleet_virtual_s": report["virtual_s"],
        "serve_simfleet_wall_s": report["wall_s"],
        "serve_simfleet_virtual_rps": (
            report["n_requests"] / report["virtual_s"]
            if report["virtual_s"] else 0.0),
        "serve_simfleet_ok_fraction": report["ok_fraction"],
        "serve_simfleet_failovers": report["failovers"],
        "serve_simfleet_respawns": report["respawns"],
        "serve_simfleet_oracles_ok": report["ok"],
    }
