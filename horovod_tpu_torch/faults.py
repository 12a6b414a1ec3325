"""Deterministic fault injection for the serving/data stack.

A copy of ``horovod_tpu/faults.py`` for the PyTorch port, which may not
import the JAX package (its ``__init__`` pulls in jax); environment
knobs are ``HVD_TORCH_*`` here.  Names of modules the port does not
have yet (the router, the monitor, tracing, ...) are the reference's.

Production fault tolerance is untestable without reproducible faults:
a "sometimes the device step raises" bug report is useless, and
sleep-based chaos harnesses make CI flaky.  This registry is the
step-counted alternative — every named **site** in the codebase calls
:meth:`FaultRegistry.check` on each pass, and test-installed rules fire
on the k-th hit of a site (optionally scoped to one request key,
optionally transient), so a fault schedule is a pure function of the
engine's step sequence: same schedule, same workload → same faults,
bit-for-bit.  No wall clock, no randomness.

Named sites currently wired:

=================  ========================================================
``serve.prefill``  per prefill window, per slot (key = request id) —
                   :class:`~horovod_tpu_torch.serving_scheduler.ServeEngine`
``serve.tick``     per decode-tick readback, per decoding row (key =
                   request id)
``serve.admit``    per admission attempt (key = request id)
``serve.cache``    per prefix-cache lookup during admission (key =
                   request id) — fires BEFORE the radix match takes
                   any block references, so a fault quarantines to the
                   one request while every shared block stays intact
``serve.draft``    per drafting row per spec tick (key = request id) —
                   a firing drafter degrades that row to plain decode
                   for the round; drafting is an optimization, so the
                   request itself never fails or retries
``serve.router``   per replica pump iteration in the
                   :class:`~horovod_tpu.router.RouterServer` fleet
                   (key = replica name) — a firing rule kills that
                   replica; the router re-enqueues its in-flight
                   requests to survivors (replay keeps outputs
                   bit-identical)
``serve.supervisor``  per respawn attempt in the
                   :class:`~horovod_tpu.supervisor.ReplicaSupervisor`
                   (key = replica name) — a firing rule fails that
                   attempt, burning one unit of the replica's restart
                   budget and advancing its backoff
``serve.autoscale``  per actuation attempt in the
                   :class:`~horovod_tpu.autoscaler.FleetAutoscaler`
                   (key = action name) — a firing rule degrades that
                   actuation to ``hold``; routing and in-flight
                   requests are untouched, so a faulted autoscaler
                   never drops a request
``router.journal``  per append to the router's request-journal WAL
                   (key = record kind) — a firing rule loses that
                   record (the request is still served; durability
                   degrades, counted in ``router.journal_errors``)
``data.producer``  per batch assembled by the
                   :class:`~horovod_tpu_torch.data.ShardedLoader` prefetch
                   thread (key = batch index)
=================  ========================================================

Rules raise :class:`TransientFault` (the consumer may retry — the
engine's bounded-retry-with-backoff path) or :class:`PermanentFault`
(retrying is pointless; fail the implicated request immediately).  A
transient rule stops firing after ``count`` hits, modeling a fault that
clears (a dropped RPC, a transient readback error); a permanent rule
fires on every matching hit from ``on_hit`` onward.

Engines take an explicit ``faults=`` registry (tests own their
schedules); module-level sites with no natural plumbing (the data
producer thread) check the shared :data:`DEFAULT` registry, which is
empty — and therefore free — unless a test arms it.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any

from horovod_tpu_torch import metrics as metrics_mod


class FaultError(RuntimeError):
    """Base class for injected faults; carries the site, the matched
    request key, and which hit of the site fired."""

    def __init__(self, site: str, key: Any, hit: int):
        super().__init__(
            f"injected fault at site {site!r} (key={key!r}, hit {hit})")
        self.site = site
        self.key = key
        self.hit = hit


class TransientFault(FaultError):
    """A fault that is expected to clear — consumers may retry."""


class PermanentFault(FaultError):
    """A fault that will not clear — consumers must not retry."""


@dataclasses.dataclass
class FaultRule:
    """One scheduled fault: fire at the ``on_hit``-th matching hit of
    ``site`` (1-based, counted per rule over hits whose key matches).

    ``count``: how many consecutive matching hits fire (transient rules
    only — a rule with ``permanent=True`` fires on every hit from
    ``on_hit`` onward).  ``key=None`` matches every hit of the site;
    otherwise only hits carrying exactly this key count toward (and
    trigger) the rule.
    """

    site: str
    on_hit: int = 1
    count: int = 1
    permanent: bool = False
    key: Any = None
    seen: int = 0       # matching hits observed so far
    fired: int = 0      # times this rule raised

    def matches(self, site: str, key: Any) -> bool:
        return self.site == site and (self.key is None or self.key == key)

    def should_fire(self) -> bool:
        if self.permanent:
            return self.seen >= self.on_hit
        return self.on_hit <= self.seen < self.on_hit + self.count


class FaultRegistry:
    """A set of :class:`FaultRule` plus per-site hit counters and a log
    of fired faults.  Thread-safe: the data-producer site checks from a
    background thread while the test thread reads the log."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.rules: list[FaultRule] = []
        self.log: list[tuple[str, Any, int]] = []   # (site, key, hit)
        self._hits: dict[str, int] = {}

    def inject(self, site: str, *, on_hit: int = 1, count: int = 1,
               permanent: bool = False, key: Any = None) -> FaultRule:
        """Arm a rule; returns it (its ``seen``/``fired`` counters are
        live, so tests can assert exactly when it triggered)."""
        if on_hit < 1:
            raise ValueError("on_hit is 1-based and must be >= 1")
        if count < 1:
            raise ValueError("count must be >= 1")
        rule = FaultRule(site=site, on_hit=on_hit, count=count,
                         permanent=permanent, key=key)
        with self._lock:
            self.rules.append(rule)
        return rule

    def check(self, site: str, key: Any = None) -> None:
        """Record one hit of ``site``; raise if an armed rule fires.

        The first matching rule that fires wins; every matching rule's
        ``seen`` counter advances regardless, so schedules compose
        (e.g. a transient fault on hit 2 and a permanent one on hit 5).
        """
        with self._lock:
            self._hits[site] = self._hits.get(site, 0) + 1
            firing: FaultRule | None = None
            for rule in self.rules:
                if not rule.matches(site, key):
                    continue
                rule.seen += 1
                if firing is None and rule.should_fire():
                    firing = rule
            if firing is None:
                return
            firing.fired += 1
            self.log.append((site, key, firing.seen))
            exc = PermanentFault if firing.permanent else TransientFault
        # Outside the lock: the shared event log / counter have their own
        # locks, and a fired fault is rare enough to afford the stamps.
        metrics_mod.DEFAULT.counter(f"faults.fired.{site}").inc()
        metrics_mod.DEFAULT.event(
            "fault", site=site, key=key, hit=firing.seen,
            permanent=firing.permanent)
        raise exc(site, key, firing.seen)

    def hits(self, site: str) -> int:
        with self._lock:
            return self._hits.get(site, 0)

    def clear(self) -> None:
        """Drop every rule, counter, and log entry (test teardown)."""
        with self._lock:
            self.rules.clear()
            self.log.clear()
            self._hits.clear()


#: Shared registry for sites with no explicit plumbing (``data.producer``).
#: Empty — and therefore a cheap no-op — unless a test arms it; tests
#: that do MUST :func:`clear` it on teardown.
DEFAULT = FaultRegistry()


def inject(site: str, **kwargs: Any) -> FaultRule:
    """Arm a rule on the shared :data:`DEFAULT` registry."""
    return DEFAULT.inject(site, **kwargs)


def check(site: str, key: Any = None) -> None:
    """Check the shared :data:`DEFAULT` registry (module-level sites)."""
    DEFAULT.check(site, key)


def clear() -> None:
    """Reset the shared :data:`DEFAULT` registry."""
    DEFAULT.clear()
