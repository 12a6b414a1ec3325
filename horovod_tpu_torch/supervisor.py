"""Self-healing for the router fleet: port of ``horovod_tpu/supervisor.py``.

:class:`~horovod_tpu_torch.router.RouterServer` survives a replica's death
(its in-flight requests replay on survivors) but cannot heal it: a dead
:class:`~horovod_tpu_torch.router.LocalReplica` (its pump thread gone) is
lost.  :class:`ReplicaSupervisor` rides the router's poll pass
(:meth:`~horovod_tpu_torch.router.RouterServer.poll_now` ticks it) and for
each dead replica:

1. **Backoff**: a respawn is tried only after an exponential delay
   (``backoff_s``, doubling per restart).
2. **Budget**: after ``max_restarts`` respawns the
   replica is circuit-broken to permanent-dead
   (``supervisor.permanent_deaths``) and never tried again.
3. **Respawn**: a factory builds the replacement.  A local replica's
   default is :func:`clone_engine`: a fresh
   :class:`~horovod_tpu_torch.serving_scheduler.ServeEngine` with the dead
   engine's configuration that shares its weight tensors on the card, so a
   respawn costs one KV pool, not a second copy of the model; greedy
   determinism then makes its tokens those of the original.  A factory may
   return ``None`` for an out-of-band respawn (an
   :class:`~horovod_tpu_torch.router.HttpReplica` revives through probes);
   the attempt still costs budget.
4. **Warm-up**: the hottest recently routed prompts that the dead
   replica's shadow index knew are replayed through the fresh engine, so it
   re-enters prefix-affinity routing warm.
5. **Commit**: :meth:`~horovod_tpu_torch.router.RouterServer.replace_replica`
   swaps the handle in and returns the name to the candidate set.

Every attempt checks the ``serve.supervisor`` fault site (key = replica
name) first; a firing rule fails the attempt, burning budget and advancing
the backoff.  The supervisor has no thread of its own; its state lives
behind its own small lock.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable

from horovod_tpu_torch import faults as faults_mod
from horovod_tpu_torch.router import LocalReplica, ReplicaHandle, RouterServer
from horovod_tpu_torch.serving import Request


def clone_engine(eng: Any) -> Any:
    """A fresh :class:`~horovod_tpu_torch.serving_scheduler.ServeEngine`
    with ``eng``'s exact configuration: same params/config/geometry/
    policy/faults/metrics and measurement planes, empty state.  The clone holds ``eng.params``
    itself, the same tensors on the card, so it adds one KV pool and no
    second copy of the weights.  Greedy determinism makes the clone
    token-identical to the original for any request, which is what lets
    a respawned replica transparently serve replays."""
    from horovod_tpu_torch.serving_scheduler import ServeEngine

    return ServeEngine(
        eng.params, eng.cfg,
        n_slots=eng.n_slots, max_len=eng.max_len, chunk=eng.chunk,
        block_size=eng.block_size,
        # The paged cache's axis-1 extent IS n_blocks (trash block
        # included), so the clone's KV geometry matches bit-for-bit.
        n_blocks=int(eng.pcache.k.shape[1]),
        tp_size=eng.tp_size,
        timeline=eng.timeline,
        preempt_after=eng.preempt_after,
        max_retries=eng.max_retries,
        watchdog_steps=eng.watchdog_steps,
        faults=eng.faults,
        metrics=eng.metrics,
        prefix_cache=eng.prefix is not None,
        monitor=False,
        slo_window=eng.slo._traces.maxlen,
        slo_e2e_s=eng.slo.slo_e2e_s,
        profile=eng.prof is not None,
        spec=eng.spec,
        draft_k=eng.draft_k,
        policy=eng.policy,
        # The measurement planes as the replica had them: its own device
        # plane anew, and its sampler and alert rules themselves (the dead
        # engine no longer ticks them, and they read the shared registry).
        device_telemetry=eng.device_telemetry is not None,
        sampler=eng.sampler if eng.sampler is not None else False,
        alerts=eng.alerts if eng.alerts is not None else False,
    )


class _ReplicaRecord:
    """Per-replica supervision state (guarded by the supervisor lock)."""

    __slots__ = ("restarts", "next_ts", "permanent_dead", "history")

    def __init__(self) -> None:
        self.restarts = 0               # respawn attempts consumed
        self.next_ts = 0.0              # monotonic: earliest next try
        self.permanent_dead = False     # circuit-broken
        self.history: list[dict] = []   # [{"ok": bool, "error": ...}]


class ReplicaSupervisor:
    """Respawns dead replicas for one router; see the module docstring.

    ``factories`` maps replica name → zero-arg callable returning a
    replacement :class:`~horovod_tpu_torch.router.ReplicaHandle` (or ``None``
    for out-of-band respawn).  Replicas without a factory get the
    default: local replicas are cloned via :func:`clone_engine`;
    anything else (HTTP replicas already revive through probes) is left
    alone entirely — no budget, no backoff.

    ``warm_prefixes`` bounds how many recently-routed prompts are
    replayed into a fresh local engine before it rejoins (0 = cold
    respawn).  The candidate prompts come from the supervisor's own
    bounded ring, fed by the router's ``on_route`` hook; only prompts
    the dead replica's shadow index recognises are replayed
    (``supervisor.warm_prefixes`` counts them).
    """

    _GUARDED_BY_LOCK = ("_records", "_recent")

    def __init__(self, router: RouterServer, *,
                 max_restarts: int = 3,
                 backoff_s: float = 0.5,
                 factories: "dict[str, Callable[[], ReplicaHandle | None]] | None" = None,  # noqa: E501
                 warm_prefixes: int = 8,
                 recent_prompts: int = 64,
                 faults: "faults_mod.FaultRegistry | None" = None,
                 clock: Callable[[], float] = time.monotonic):
        self.router = router
        self.max_restarts = int(max_restarts)
        self.backoff_s = backoff_s
        self.factories = dict(factories or {})
        self.warm_prefixes = warm_prefixes
        self.faults = faults if faults is not None else router.faults
        self.metrics = router.metrics
        self.clock = clock
        self._lock = threading.Lock()
        self._records: dict[str, _ReplicaRecord] = {}
        # Recently routed prompts, newest last — the warm-up feed.
        self._recent: collections.deque = collections.deque(
            maxlen=max(recent_prompts, 1))
        # Registered up front (literal names).
        self.metrics.counter("supervisor.respawns")
        self.metrics.counter("supervisor.respawn_failures")
        self.metrics.counter("supervisor.permanent_deaths")
        self.metrics.counter("supervisor.warm_prefixes")
        router.supervisor = self
        if router.on_route is None:
            router.on_route = self._observe_route

    # -- feeds -------------------------------------------------------------

    def _observe_route(self, name: str, req: Request) -> None:
        with self._lock:
            self._recent.append(tuple(req.prompt))

    # -- state for health()/state_dump() -----------------------------------

    def _record_locked(self, name: str) -> _ReplicaRecord:
        rec = self._records.get(name)
        if rec is None:
            rec = self._records[name] = _ReplicaRecord()
        return rec

    def state(self) -> dict[str, dict]:
        """Per-replica restart state: ``restarts`` consumed,
        ``max_restarts``, ``permanent_dead``, next-attempt delay, and
        the attempt ``history`` (newest last)."""
        with self._lock:
            now = self.clock()
            return {name: {
                "restarts": rec.restarts,
                "max_restarts": self.max_restarts,
                "permanent_dead": rec.permanent_dead,
                "next_attempt_in_s": max(rec.next_ts - now, 0.0),
                "history": list(rec.history),
            } for name, rec in self._records.items()}

    def degraded(self) -> bool:
        """True while any replica is running on its restart budget —
        the fleet serves, but not at full redundancy headroom."""
        with self._lock:
            return any(rec.restarts > 0 or rec.permanent_dead
                       for rec in self._records.values())

    # -- the respawn loop --------------------------------------------------

    def tick(self) -> int:
        """One supervision pass (the router's poller calls this every
        poll): attempt a respawn for every dead, budgeted, backed-off
        replica.  Returns how many replicas rejoined."""
        with self.router._lock:
            # A cordoned replica is being drained out of the fleet by
            # the autoscaler: if it dies mid-drain its in-flight work
            # fails over, but respawning it would fight the retire.
            dead = [r for r in self.router.replicas
                    if r.name in self.router._dead
                    and r.name not in self.router._cordoned]
        rejoined = 0
        for handle in dead:
            if self._respawn(handle):
                rejoined += 1
        return rejoined

    def _factory_for(self, handle: ReplicaHandle) -> \
            "Callable[[], ReplicaHandle | None] | None":
        fac = self.factories.get(handle.name)
        if fac is not None:
            return fac
        if isinstance(handle, LocalReplica):
            return lambda: self._default_local_factory(handle)
        return None     # HTTP replicas heal through probes

    def _respawn(self, handle: ReplicaHandle) -> bool:
        name = handle.name
        factory = self._factory_for(handle)
        if factory is None:
            return False
        now = self.clock()
        with self._lock:
            rec = self._record_locked(name)
            if rec.permanent_dead or now < rec.next_ts:
                return False
            if rec.restarts >= self.max_restarts:
                rec.permanent_dead = True
                self.metrics.counter(
                    "supervisor.permanent_deaths").inc()
                self.metrics.event("supervisor.permanent_death",
                                   replica=name,
                                   restarts=rec.restarts)
                return False
            # Burn the budget up front: a factory that crashes (or a
            # firing serve.supervisor fault) must still advance the
            # backoff, or a broken factory hot-loops every tick.
            rec.restarts += 1
            rec.next_ts = now + self.backoff_s * (2 ** (rec.restarts - 1))
        try:
            self.faults.check("serve.supervisor", key=name)
            replacement = factory()
        except Exception as e:
            self.metrics.counter("supervisor.respawn_failures").inc()
            self.metrics.event("supervisor.respawn_failure",
                               replica=name, error=str(e))
            with self._lock:
                self._records[name].history.append(
                    {"ok": False, "error": str(e)})
            return False
        with self._lock:
            rec = self._records[name]
            rec.history.append({"ok": True, "error": None})
            restarts = rec.restarts
        self.metrics.counter("supervisor.respawns").inc()
        self.metrics.event("supervisor.respawn", replica=name,
                           restarts=restarts,
                           out_of_band=replacement is None)
        if replacement is None:
            return False    # out-of-band: probes will revive the handle
        self.router.replace_replica(name, replacement)
        return True

    # -- elastic membership (the autoscaler's factory seam) ----------------

    def spawn_replica(self, name: str,
                      template: "ReplicaHandle | None" = None,
                      ) -> "ReplicaHandle | None":
        """Build a brand-new replica handle for the autoscaler's grow
        path, through the same pluggable factory seam respawn uses: an
        explicit ``factories[name]`` entry wins; otherwise a live
        local replica (``template``, or the first healthy
        :class:`~horovod_tpu_torch.router.LocalReplica`) is cloned via
        :func:`clone_engine` and pre-warmed with its hot prompts.
        Returns ``None`` when no factory applies (an all-HTTP fleet
        grows out-of-band)."""
        fac = self.factories.get(name)
        if fac is not None:
            return fac()
        if template is None:
            with self.router._lock:
                live = [r for r in self.router.replicas
                        if r.name not in self.router._dead
                        and isinstance(r, LocalReplica)]
            template = live[0] if live else None
        if not isinstance(template, LocalReplica):
            return None
        eng = clone_engine(template.engine)
        # Warm from the template's shadow: the newcomer inherits the
        # fleet's hot prefixes instead of joining with a cold radix.
        self._warm(eng, template.name)
        return LocalReplica(eng, name=name, faults=template.faults)

    def forget(self, name: str) -> None:
        """Drop a retired replica's restart record so a future replica
        reusing the name starts with a full budget (the autoscaler
        calls this after :meth:`~horovod_tpu_torch.router.RouterServer.retire_replica`)."""  # noqa: E501
        with self._lock:
            self._records.pop(name, None)

    # -- warm respawn ------------------------------------------------------

    def _default_local_factory(self,
                               dead: LocalReplica) -> ReplicaHandle:
        eng = clone_engine(dead.engine)
        self._warm(eng, dead.name)
        return LocalReplica(eng, name=dead.name, faults=dead.faults)

    def _warm_candidates(self, name: str) -> "list[tuple[int, ...]]":
        """Recently routed prompts the dead replica's shadow index
        recognises, newest first, deduped, bounded by
        ``warm_prefixes``."""
        if self.warm_prefixes <= 0:
            return []
        with self.router._lock:
            shadow = self.router._shadows.get(name)
        with self._lock:
            recent = list(self._recent)
        out: list[tuple[int, ...]] = []
        seen: set[tuple[int, ...]] = set()
        for prompt in reversed(recent):
            if prompt in seen:
                continue
            seen.add(prompt)
            if shadow is not None and shadow.match_tokens(prompt) > 0:
                out.append(prompt)
                if len(out) >= self.warm_prefixes:
                    break
        return out

    def _warm(self, eng: Any, name: str) -> None:
        """Best-effort prefix-cache rewarm: run each hot prompt for one
        token so its chunks land in the fresh radix.  Failures are
        swallowed — warm-up is an optimization, never a respawn
        blocker."""
        if getattr(eng, "prefix", None) is None:
            return
        for prompt in self._warm_candidates(name):
            try:
                eng.run([Request(prompt=list(prompt), max_new_tokens=1)])
                self.metrics.counter("supervisor.warm_prefixes").inc()
            except Exception:
                continue    # one bad prompt must not cold-start the rest


def supervise(router: RouterServer,
              **kwargs: Any) -> ReplicaSupervisor:
    """Attach a :class:`ReplicaSupervisor` to ``router`` (convenience
    constructor mirroring ``maybe_start_router``'s shape)."""
    return ReplicaSupervisor(router, **kwargs)
