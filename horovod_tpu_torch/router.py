"""Multi-replica serving front door: port of ``horovod_tpu/router.py``.

Many engines, one door.  A stdlib HTTP server (:class:`RouterServer`, the
``monitor.py`` threading-HTTP pattern) fronts a fleet of replica backends,
each a :class:`~horovod_tpu_torch.serving_scheduler.ServeEngine` on the
card, and decides per request which replica serves it:

* **Pluggable routing** through :class:`RoutingPolicy`: policies see
  read-only fleet state and return a choice.  :class:`RoundRobinPolicy`
  cycles, :class:`LeastLoadedPolicy` picks the emptiest replica (fewest in
  flight, best goodput), and :class:`PrefixAffinityPolicy` routes by cache
  locality (SGLang's): the router keeps a :class:`ShadowPrefixIndex` per
  replica, a bounded set of radix path digests fed by its own routing
  decisions and by each replica's ``prefix.key_digest()`` summary, and
  sends each request to the replica sharing the longest cached prefix,
  falling back to least-loaded past the ``imbalance`` argument.  No
  token leaves a replica: digests are blake2b chunk hashes
  (:func:`~horovod_tpu_torch.prefix_cache.chunk_path_digests`).
* **Admission control**: a poller probes each replica (the in-process
  :class:`LocalReplica` view, or ``/snapshot`` + ``/healthz`` of an
  :class:`HttpReplica`); below the ``min_goodput`` / ``min_free_kv``
  floors new work is shed as ``REJECTED``,
  the engine's own terminal status for a shed.
* **Failover by replay**: a replica death (the ``serve.router`` fault site
  in the :class:`LocalReplica` pump, or ``probe_fails``
  failed probes in a row of an HTTP replica) re-enqueues its in-flight
  requests on survivors from the full prompt.  Greedy decode is
  deterministic, so the tokens are the same as an uninterrupted run's; the
  loss shows only in ``router.failovers``.  Replays per request are capped
  (``max_failovers``).
* **Crash durability**: ``HVD_TORCH_ROUTER_JOURNAL=<path>`` arms an
  append-only JSONL request journal (an
  :class:`~horovod_tpu_torch.metrics.EventLog`): an ``accept`` record as a
  request is placed, a ``terminal`` record as it finishes.  A restarted
  router replays every accept with no terminal
  (:meth:`RouterServer.replay_journal`), and an idempotency key makes a
  retry exactly-once.  :meth:`RouterServer.stop` drains for up to
  ``drain_s`` seconds.  Respawning a dead replica is
  :class:`~horovod_tpu_torch.supervisor.ReplicaSupervisor`'s job.
* **Measurement planes** over the router's own registry: the time series,
  alert rules and capacity advisor, causal-tracing spans
  (``router.request`` → ``replica.attempt``, a failover's replay the child
  of the attempt it replaced), and the fleet's ``/device`` view over each
  local engine's ``device_telemetry``.

* **Elastic membership**: a
  :class:`~horovod_tpu_torch.autoscaler.FleetAutoscaler`
  (``HVD_TORCH_AUTOSCALE=1`` or ``autoscaler=True``) rides the
  poll pass after the health plane and actuates the advisor's records
  through ``add_replica`` / ``cordon_replica`` / ``retire_replica`` and the
  supervisor's ``spawn_replica``; ``GET /autoscaler`` reports it.

The router itself is host bookkeeping: it allocates nothing on the card.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
import warnings
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Sequence

from horovod_tpu_torch import faults as faults_mod
from horovod_tpu_torch import metrics as metrics_mod
from horovod_tpu_torch import alerts as alerts_mod
from horovod_tpu_torch import timeseries as timeseries_mod
from horovod_tpu_torch import tracing as tracing_mod
from horovod_tpu_torch.monitor import env_float
from horovod_tpu_torch.prefix_cache import chunk_path_digests
from horovod_tpu_torch.serving import (FAILED, REJECTED, Request,
                                 RequestResult)

# ---------------------------------------------------------------------------
# Shadow prefix index: what the router believes each replica has cached.
# ---------------------------------------------------------------------------


class ShadowPrefixIndex:
    """A bounded, token-free mirror of one replica's radix index.

    Holds hex digests of root-to-node chunk paths
    (:func:`~horovod_tpu_torch.prefix_cache.chunk_path_digests` encoding).
    Two feeds keep it warm: :meth:`observe` digests every prompt the
    router sends to the replica (optimistic — the replica will cache it
    on retirement), and :meth:`load` merges the replica's own
    ``key_digest()`` summary from ``/snapshot`` (authoritative for what
    actually survived admission and eviction).  Matching walks a
    prompt's digests shallow-to-deep and stops at the first absent one,
    so a match is always a *contiguous* cached prefix — exactly what
    the engine's longest-prefix admission can reuse.

    The index is bounded FIFO at ``max_paths`` digests; staleness is
    benign in both directions (a phantom path costs one suboptimal
    route, a missing one costs one missed affinity hit).  Instances are
    mutated only under the owning router's lock — no lock of their own.
    """

    def __init__(self, block_size: int = 0, max_paths: int = 4096):
        self.block_size = block_size
        self.max_paths = max_paths
        self._digests: set[str] = set()
        self._order: collections.deque[str] = collections.deque()

    def _add(self, digest: str) -> None:
        if digest in self._digests:
            return
        self._digests.add(digest)
        self._order.append(digest)
        while len(self._order) > self.max_paths:
            self._digests.discard(self._order.popleft())

    def observe(self, tokens: Sequence[int]) -> None:
        """Optimistically index a prompt the router just routed here."""
        if self.block_size < 1:
            return
        for d in chunk_path_digests(tokens, self.block_size):
            self._add(d)

    def load(self, summary: dict | None) -> None:
        """Merge a replica ``key_digest()`` summary (adopts its
        ``block_size`` when the shadow doesn't know one yet)."""
        if not summary:
            return
        bs = summary.get("block_size", 0)
        if self.block_size < 1 and bs >= 1:
            self.block_size = bs
        for d in summary.get("paths", ()):
            self._add(d)

    def evict_oldest(self, n: int) -> int:
        """Drop up to ``n`` oldest digests (the router's fleet-wide
        byte-ceiling eviction hook — same FIFO order as the
        ``max_paths`` bound); returns how many were dropped."""
        dropped = 0
        while self._order and dropped < n:
            self._digests.discard(self._order.popleft())
            dropped += 1
        if dropped:
            # Set/deque tables never shrink in place, so the sizeof-based
            # footprint would floor at the high-water mark and the byte
            # ceiling could become unreachable; rebuild at current size.
            self._digests = set(self._digests)
            self._order = collections.deque(self._order)
        return dropped

    def match_tokens(self, tokens: Sequence[int]) -> int:
        """Tokens of the longest contiguous cached prefix of
        ``tokens`` this shadow knows about (0 without a block size)."""
        if self.block_size < 1:
            return 0
        depth = 0
        for d in chunk_path_digests(tokens, self.block_size):
            if d not in self._digests:
                break
            depth += 1
        return depth * self.block_size

    def __len__(self) -> int:
        return len(self._digests)

    def approx_footprint_bytes(self) -> int:
        """Shallow host-bytes estimate (the same leak-trend-line role
        as the radix index's ``approx_footprint_bytes``)."""
        total = sys.getsizeof(self._digests) + sys.getsizeof(self._order)
        for d in self._digests:
            total += 2 * sys.getsizeof(d)       # set entry + deque entry
        return total


# ---------------------------------------------------------------------------
# Routing policies (the SchedulerPolicy seam shape, one layer up).
# ---------------------------------------------------------------------------


class RoutingPolicy:
    """Per-request replica choice.

    ``choose(candidates, req, ctx)`` picks one name from the non-empty
    ``candidates`` list (healthy replicas, router order) and returns
    ``(name, info)`` where ``info`` may carry ``affinity_hit_tokens``
    and ``fallback`` for the router's metrics.  ``ctx`` is a read-only
    :class:`RoutingContext`; policies never mutate router state."""

    name = "base"

    def choose(self, candidates: Sequence[str], req: Request,
               ctx: "RoutingContext") -> tuple[str, dict]:
        raise NotImplementedError


class RoutingContext:
    """What a policy may look at: per-replica ``views`` (the poller's
    last probe dicts), ``shadows`` (per-replica
    :class:`ShadowPrefixIndex`), and ``inflight`` (requests routed but
    not yet terminal, per replica — live, not poll-delayed)."""

    def __init__(self, views: dict, shadows: dict, inflight: dict,
                 imbalance: float):
        self.views = views
        self.shadows = shadows
        self.inflight = inflight
        self.imbalance = imbalance

    def load(self, name: str) -> tuple:
        """Sort key: emptier and healthier first, stable by name."""
        v = self.views.get(name, {})
        return (self.inflight.get(name, 0),
                -v.get("goodput", 1.0), name)


class RoundRobinPolicy(RoutingPolicy):
    """Cycle the healthy set in order — the baseline every affinity
    claim is measured against."""

    name = "round_robin"

    def __init__(self) -> None:
        self._next = 0

    def choose(self, candidates: Sequence[str], req: Request,
               ctx: RoutingContext) -> tuple[str, dict]:
        name = candidates[self._next % len(candidates)]
        self._next += 1
        return name, {}


class LeastLoadedPolicy(RoutingPolicy):
    """Fewest in-flight requests wins; goodput breaks ties (a replica
    missing its SLOs is effectively fuller than its queue says)."""

    name = "least_loaded"

    def choose(self, candidates: Sequence[str], req: Request,
               ctx: RoutingContext) -> tuple[str, dict]:
        return min(candidates, key=ctx.load), {}


class PrefixAffinityPolicy(RoutingPolicy):
    """Longest shared cached prefix wins (RadixAttention locality,
    router-side): route to the replica whose shadow index matches the
    most prompt tokens, so the engine's longest-prefix admission skips
    the most prefill.  Ties — including the no-match cold start — fall
    to least-loaded.  When the affinity choice is already
    ``imbalance`` in-flight requests deeper than the emptiest healthy
    replica, locality loses to load and the router falls back to
    least-loaded (``info["fallback"]``), keeping one hot prefix from
    starving the fleet."""

    name = "prefix_affinity"

    def choose(self, candidates: Sequence[str], req: Request,
               ctx: RoutingContext) -> tuple[str, dict]:
        matches = {n: ctx.shadows[n].match_tokens(req.prompt)
                   for n in candidates if n in ctx.shadows}
        best = max(matches.values(), default=0)
        if best <= 0:
            return min(candidates, key=ctx.load), {
                "affinity_hit_tokens": 0, "fallback": False}
        pick = min((n for n in candidates if matches.get(n, 0) == best),
                   key=ctx.load)
        emptiest = min(candidates, key=ctx.load)
        gap = (ctx.inflight.get(pick, 0)
               - ctx.inflight.get(emptiest, 0))
        if gap > ctx.imbalance:
            return emptiest, {
                "affinity_hit_tokens": matches.get(emptiest, 0),
                "fallback": True}
        return pick, {"affinity_hit_tokens": best, "fallback": False}


ROUTING_POLICIES: dict[str, type[RoutingPolicy]] = {
    "round_robin": RoundRobinPolicy,
    "least_loaded": LeastLoadedPolicy,
    "prefix_affinity": PrefixAffinityPolicy,
}


def resolve_routing_policy(
    policy: "RoutingPolicy | str | None" = None,
) -> RoutingPolicy:
    """An instance passes through; a name constructs; ``None`` reads
    ``HVD_TORCH_ROUTER_POLICY`` (unset/empty → ``prefix_affinity``)."""
    if isinstance(policy, RoutingPolicy):
        return policy
    name = (policy or os.environ.get("HVD_TORCH_ROUTER_POLICY", "")
            or "prefix_affinity")
    cls = ROUTING_POLICIES.get(name)
    if cls is None:
        raise ValueError(
            f"unknown routing policy {name!r}; choose from "
            f"{sorted(ROUTING_POLICIES)}")
    return cls()


# ---------------------------------------------------------------------------
# Replica handles: how the router talks to a backend.
# ---------------------------------------------------------------------------


#: A submission's completion callback.  Called exactly once per
#: submission with the terminal :class:`RequestResult`, or ``None``
#: when the replica died first — ``None`` is the router's failover
#: signal, never a client-visible outcome.
DoneCallback = Callable[["RequestResult | None"], None]


class ReplicaHandle:
    """One backend the router can route to.  Implementations must make
    ``submit`` safe from any thread and guarantee the callback fires
    exactly once (result or ``None``-on-death) for every accepted
    submission."""

    name = "replica"
    block_size = 0      # 0 = unknown / no prefix cache
    #: Whether a dead replica may rejoin routing when probes turn
    #: healthy again.  False for in-process replicas (a dead pump
    #: thread never comes back); True for HTTP replicas (the remote
    #: process can restart, or the probe failure was transient).
    can_revive = False

    def submit(self, req: Request, done_cb: DoneCallback) -> None:
        raise NotImplementedError

    def probe(self) -> dict:
        """Poller view: ``healthy``, ``inflight``, ``queue_depth``,
        ``goodput``, ``free_kv_frac``, ``tp_size`` (chips behind this
        replica — capacity accounting for multi-chip replicas; its
        ``free_kv_frac`` is a fraction of an N-chip logical pool), and
        optionally ``prefix`` (a ``key_digest()`` summary)."""
        raise NotImplementedError

    def stop(self) -> None:
        pass


class LocalReplica(ReplicaHandle):
    """An in-process :class:`~horovod_tpu_torch.serving_scheduler.ServeEngine`
    behind the handle interface, driven by one daemon **pump** thread
    that owns the engine exclusively: submissions from router handler
    threads land in an inbox; the pump drains it into
    ``engine.submit`` and calls ``engine.step`` while work is pending,
    dispatching completion callbacks as requests retire.

    The pump checks the ``serve.router`` fault site (key = replica
    name) before every engine step; a firing rule — transient or
    permanent, the site models process loss either way — kills the
    replica: the pump marks it dead, notifies the router, and fires
    every in-flight callback with ``None`` so the router re-enqueues
    those requests on survivors.  Because replay from the full prompt
    is bit-identical (greedy determinism), the death point never shows
    in any output."""

    _GUARDED_BY_LOCK = ("_inbox", "_cbs", "_dead", "_view", "_stop")

    # Which thread runs what: the one pump
    # daemon owns the engine; everything else — router handler
    # threads, the poller's probes, supervisor stop — calls in through
    # the public surface and touches shared state only under _lock.
    _THREAD_ROLES = {
        "pump": ["_pump"],
        "callers": ["submit", "probe", "stop"],
    }

    def __init__(self, engine: Any, name: str = "local",
                 faults: "faults_mod.FaultRegistry | None" = None,
                 on_death: "Callable[[LocalReplica], None] | None" = None):
        self.engine = engine
        self.name = name
        self.block_size = (engine.block_size
                           if getattr(engine, "prefix", None) is not None
                           else 0)
        self.faults = faults if faults is not None \
            else faults_mod.FaultRegistry()
        self.on_death = on_death
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._inbox: list[tuple[Request, DoneCallback]] = []
        self._cbs: dict[int, DoneCallback] = {}
        self._dead = False
        self._stop = False
        self._view: dict = {"healthy": True, "inflight": 0,
                            "queue_depth": 0, "goodput": 1.0,
                            "free_kv_frac": 1.0,
                            "tp_size": getattr(engine, "tp_size", 1),
                            "prefix": None}
        self._thread = threading.Thread(
            target=self._pump, name=f"hvd-replica-{name}", daemon=True)
        self._thread.start()

    # -- handle interface --------------------------------------------------

    def submit(self, req: Request, done_cb: DoneCallback) -> None:
        with self._lock:
            if not self._dead and not self._stop:
                self._inbox.append((req, done_cb))
                self._wake.set()
                return
        done_cb(None)       # dead on arrival: immediate failover signal

    def probe(self) -> dict:
        with self._lock:
            return dict(self._view)

    def stop(self) -> None:
        with self._lock:
            self._stop = True
        self._wake.set()
        self._thread.join(timeout=10)

    # -- the pump thread ---------------------------------------------------

    def _refresh_view_locked(self) -> None:
        eng = self.engine
        total = max(eng.pcache.k.shape[1] - 1, 1)
        free = eng.free_block_count() + eng.cached_block_count()
        self._view = {
            "healthy": not self._dead,
            "inflight": len(self._cbs),
            "queue_depth": len(self._cbs),
            "goodput": eng.slo.goodput(),
            "free_kv_frac": free / total,
            "tp_size": getattr(eng, "tp_size", 1),
            "prefix": (eng.prefix.key_digest()
                       if eng.prefix is not None else None),
        }

    def _pump(self) -> None:
        eng = self.engine
        while True:
            with self._lock:
                if self._stop:
                    return
                batch, self._inbox = self._inbox, []
            for k, (req, cb) in enumerate(batch):
                try:
                    rid = eng.submit(req)
                except (TypeError, ValueError) as e:
                    # Engine-side validation, including TypeError from
                    # lifecycle-field arithmetic on a malformed request:
                    # surface as a terminal REJECTED rather than killing
                    # a well-behaved fleet over one bad request.
                    cb(RequestResult([], REJECTED, e))
                    continue
                except BaseException:
                    for _req3, cb3 in batch[k:]:
                        cb3(None)
                    self._die()
                    return
                if rid in eng.results:      # rejected-on-submit
                    cb(eng.results[rid])
                else:
                    with self._lock:
                        self._cbs[rid] = cb
            stepped = False
            finished: dict[int, RequestResult] = {}
            try:
                if eng.pending():
                    self.faults.check("serve.router", key=self.name)
                    finished = eng.step()
                    stepped = True
            except BaseException:
                self._die()
                return
            for rid, res in finished.items():
                with self._lock:
                    cb2 = self._cbs.pop(rid, None)
                if cb2 is not None:
                    cb2(res)
            try:
                with self._lock:
                    self._refresh_view_locked()
            except BaseException:
                self._die()
                return
            if not stepped:
                self._wake.wait(0.005)
                self._wake.clear()

    def _die(self) -> None:
        """Mark dead, then hand every in-flight request back to the
        router (callbacks fire OUTSIDE the replica lock: they re-enter
        the router, which may call ``submit`` on other replicas)."""
        with self._lock:
            self._dead = True
            self._view = dict(self._view, healthy=False, goodput=0.0)
            orphans = list(self._cbs.values())
            self._cbs.clear()
            pending = list(self._inbox)
            self._inbox.clear()
        if self.on_death is not None:
            self.on_death(self)
        for cb in orphans:
            cb(None)
        for _req, cb in pending:
            cb(None)


class HttpReplica(ReplicaHandle):
    """A backend reached over HTTP: submissions POST to a remote
    ``/v1/generate`` door (typically a single-replica
    :class:`RouterServer` co-located with the engine), health and
    digests come from its monitor's ``/snapshot`` + ``/healthz``.
    Each submission runs in a short-lived daemon thread so the router
    never blocks on the network; a connection error or non-2xx reply
    fires the callback with ``None`` — the same failover signal a
    local pump death produces.  A socket *timeout* is different: the
    backend may be slow but alive and still decoding, so replaying
    the request elsewhere would silently duplicate the work — it
    terminates the request ``FAILED`` instead (and the per-request
    wire budget stretches past ``deadline_s`` when one is set, so an
    engine-side ``TIMEOUT`` always beats the socket to it)."""

    can_revive = True

    def __init__(self, name: str, generate_url: str,
                 monitor_url: str | None = None,
                 block_size: int = 0, timeout_s: float = 30.0):
        self.name = name
        self.generate_url = generate_url.rstrip("/")
        self.monitor_url = (monitor_url.rstrip("/")
                            if monitor_url else None)
        self.block_size = block_size
        self.timeout_s = timeout_s

    def _request_timeout_s(self, req: Request) -> float:
        """Wire budget for one submission: a deadline-carrying request
        gets its own deadline plus the configured margin, so the
        backend's deadline-expiry reply (``TIMEOUT``, tokens-so-far)
        always arrives before the socket gives up."""
        if req.deadline_s is None:
            return self.timeout_s
        return max(self.timeout_s, req.deadline_s + self.timeout_s)

    def submit(self, req: Request, done_cb: DoneCallback) -> None:
        payload = request_to_json(req)
        timeout_s = self._request_timeout_s(req)

        def _post() -> None:
            import socket
            import urllib.error
            import urllib.request
            try:
                http_req = urllib.request.Request(
                    self.generate_url + "/v1/generate",
                    data=json.dumps(payload).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(
                        http_req, timeout=timeout_s) as resp:
                    body = json.loads(resp.read().decode())
                res = RequestResult(body.get("tokens", []),
                                    body.get("status", FAILED))
                tr = body.get("trace")
                if isinstance(tr, dict):
                    # Remote trace dict (remote clock domain): pass it
                    # through so attribution still sees the *_s spans.
                    res.trace = tr
                done_cb(res)
            except (TimeoutError, socket.timeout) as e:
                # Slow-but-alive backend: fail, don't duplicate.
                done_cb(RequestResult([], FAILED, e))
            except urllib.error.URLError as e:
                if isinstance(getattr(e, "reason", None),
                              (TimeoutError, socket.timeout)):
                    done_cb(RequestResult([], FAILED, e))
                else:
                    done_cb(None)   # refused / reset / non-2xx: failover
            except Exception:
                done_cb(None)

        threading.Thread(target=_post, daemon=True,
                         name=f"hvd-router-post-{self.name}").start()

    def _get_json(self, url: str) -> tuple[int, dict]:
        import urllib.request
        with urllib.request.urlopen(url, timeout=self.timeout_s) as resp:
            return resp.status, json.loads(resp.read().decode())

    def probe(self) -> dict:
        view: dict[str, Any] = {"healthy": False, "inflight": 0,
                                "queue_depth": 0, "goodput": 1.0,
                                "free_kv_frac": 1.0, "tp_size": 1,
                                "prefix": None}
        if self.monitor_url is None:
            view["healthy"] = True      # no monitor: assume alive
            return view
        try:
            code, _ = self._get_json(self.monitor_url + "/healthz")
            view["healthy"] = code == 200
            _, snap = self._get_json(self.monitor_url + "/snapshot")
        except Exception:
            return view
        g = snap.get("gauges", {})
        view["queue_depth"] = int(g.get("serve.queue_depth", 0))
        view["inflight"] = int(g.get("serve.queue_depth", 0)
                               + g.get("serve.decoding", 0)
                               + g.get("serve.prefilling", 0))
        view["goodput"] = snap.get("slo", {}).get("goodput", 1.0)
        total = (g.get("kv.free_blocks", 0)
                 + g.get("kv.referenced_blocks", 0)
                 + g.get("kv.cached_blocks", 0))
        if total > 0:
            view["free_kv_frac"] = (g.get("kv.free_blocks", 0)
                                    + g.get("kv.cached_blocks", 0)) / total
        view["tp_size"] = int(g.get("tp.size", 1)) or 1
        view["prefix"] = snap.get("prefix")
        return view


def request_to_json(req: Request) -> dict:
    """The ``POST /v1/generate`` wire form of a :class:`Request`
    (greedy serving fields only — the router is greedy-only, like
    :class:`ServeEngine`)."""
    out = {"prompt": list(req.prompt),
           "max_new_tokens": req.max_new_tokens,
           "eos_id": req.eos_id,
           "deadline_s": req.deadline_s,
           "max_queue_steps": req.max_queue_steps,
           "slo_s": req.slo_s,
           "priority": req.priority}
    ctx = getattr(req, "trace_ctx", None)
    if ctx is not None:
        # Optional causal-trace context: HttpReplica serializes the
        # request at submit time, AFTER the router stamped the current
        # attempt's span — so the remote hop parents under this hop.
        out["trace"] = ctx.to_dict()
    return out


def _opt_number(payload: dict, field: str) -> "float | None":
    v = payload.get(field)
    if v is not None and (isinstance(v, bool)
                          or not isinstance(v, (int, float))):
        raise ValueError(f"{field} must be a number or null")
    return v


def _opt_int(payload: dict, field: str) -> "int | None":
    v = payload.get(field)
    if v is not None and (isinstance(v, bool) or not isinstance(v, int)):
        raise ValueError(f"{field} must be an int or null")
    return v


def request_from_json(payload: dict) -> Request:
    """Parse the wire form back; raises ``ValueError`` on junk (the
    handler maps that to HTTP 400).  EVERY field is type-checked here
    — the lifecycle fields too, not just prompt/budget: an unchecked
    string ``deadline_s`` would only explode later, inside
    ``ServeEngine.submit``/``step`` arithmetic on a pump thread, where
    the router reads the crash as a replica death and replays the same
    poisoned request onto each survivor in turn."""
    if not isinstance(payload, dict):
        raise ValueError("body must be a JSON object")
    prompt = payload.get("prompt")
    if not isinstance(prompt, list) or \
            not all(isinstance(t, int) for t in prompt):
        raise ValueError("prompt must be a list of token ids")
    mnt = payload.get("max_new_tokens")
    if not isinstance(mnt, int):
        raise ValueError("max_new_tokens must be an int")
    return Request(prompt=prompt, max_new_tokens=mnt,
                   eos_id=_opt_int(payload, "eos_id"),
                   deadline_s=_opt_number(payload, "deadline_s"),
                   max_queue_steps=_opt_int(payload, "max_queue_steps"),
                   slo_s=_opt_number(payload, "slo_s"),
                   priority=_opt_int(payload, "priority") or 0,
                   # Malformed trace dicts degrade to None (untraced),
                   # never 400 — tracing must not fail a request.
                   trace_ctx=tracing_mod.TraceContext.from_dict(
                       payload.get("trace")))


# ---------------------------------------------------------------------------
# Crash-durable request journal (the WAL a restarted router recovers from).
# ---------------------------------------------------------------------------


def load_journal(path: str) -> "tuple[list[dict], dict[str, dict]]":
    """Parse a request-journal WAL into recovery state: a list of
    *incomplete* accept records (accepted, no terminal — these must be
    replayed) and the terminal records of every keyed request (the
    idempotency dedup map).

    The file is plain :class:`~horovod_tpu_torch.metrics.EventLog` JSONL, so
    the torn-line-tolerant ``EventLog.read`` does the parsing: a crash
    mid-append costs at most the half-written last line, never the
    records before it.  Accept/terminal pairs match on the
    ``(pid, rid)`` the EventLog stamps automatically — rids restart at
    0 in every router incarnation, and the pid disambiguates
    incarnations sharing one journal file.  A ``router.replayed``
    marker retires an accept the same way a terminal does: the
    replaying incarnation routed the request under its own fresh
    accept record, so the original must not replay again on the
    restart after next.  A key replayed across several crashes may
    leave several incomplete accepts; one replay suffices, and a key
    that ever reached a terminal needs none."""
    if not path or not os.path.exists(path):
        return [], {}
    accepts: dict[tuple, dict] = {}
    results: dict[str, dict] = {}
    for rec in metrics_mod.EventLog.read(path):
        ident = (rec.get("pid"), rec.get("rid"))
        kind = rec.get("kind")
        if kind == "router.accept":
            accepts[ident] = rec
        elif kind == "router.terminal":
            accepts.pop(ident, None)
            if rec.get("key") is not None:
                # Pop-then-insert so dict order is latest-terminal
                # order — the router's LRU bound keeps the NEWEST
                # keys, so a re-terminated key must move to the back.
                results.pop(rec["key"], None)
                results[rec["key"]] = rec
        elif kind == "router.replayed":
            accepts.pop(ident, None)
    incomplete: list[dict] = []
    seen_keys: set[str] = set()
    for rec in accepts.values():
        key = rec.get("key")
        if key is not None:
            if key in results or key in seen_keys:
                continue
            seen_keys.add(key)
        incomplete.append(rec)
    return incomplete, results


def compact_journal(path: str, keep: "Sequence[dict]") -> None:
    """Rewrite the WAL to just ``keep`` (the records recovery still
    needs: unpaired accepts and the keyed terminals that seed the
    dedup map).  Without this every restart would re-read — and the
    file would forever carry — each paired accept/terminal of every
    request ever served.  Records are written back verbatim (their
    original ``pid``/``rid``/``ts`` intact, so cross-incarnation
    pairing still works) via a temp file + ``os.replace``: a crash
    mid-compaction leaves either the old journal or the new one,
    never a half-written file."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        for rec in keep:
            f.write(json.dumps(rec) + "\n")
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# The router itself.
# ---------------------------------------------------------------------------


class _Ticket:
    """One routed request's lifecycle inside the router: which replica
    holds it, whether it was shed, and its terminal result.  All fields
    are mutated under the owning router's lock; ``done`` is the only
    cross-thread wait point.

    The ``*_ts`` / ``*_s`` span fields are the router-side half of
    end-to-end latency attribution (:meth:`RouterServer.request_trace`):
    receive → admission → route decision → journal append → submit,
    all on the owning router's clock (``time.monotonic`` by default)
    so they join the engine :class:`~horovod_tpu_torch.metrics.Trace` stamps
    exactly (same process, same clock)."""

    __slots__ = ("rid", "req", "replica", "shed", "failovers",
                 "result", "done", "done_ts", "policy", "key",
                 "journaled", "recv_ts", "submit_ts", "admission_s",
                 "route_decision_s", "journal_s", "tctx", "tparent",
                 "attempt_ctx", "attempt_parent", "attempt_t0")

    def __init__(self, rid: int, req: Request,
                 now: "float | None" = None):
        self.rid = rid
        self.req = req
        self.replica: str | None = None
        self.shed: str | None = None        # shed reason, when shed
        self.failovers = 0
        self.result: RequestResult | None = None
        self.done = threading.Event()
        self.done_ts = 0.0                  # router clock, for TTL reaping
        self.policy = ""
        self.key: str | None = None         # idempotency key, if any
        self.journaled = False              # has an accept WAL record
        self.recv_ts = (time.monotonic()    # front-door arrival
                        if now is None else now)
        self.submit_ts = 0.0                # first replica submit
        self.admission_s = 0.0              # admission-control check
        self.route_decision_s = 0.0         # policy choose + booking
        self.journal_s = 0.0                # accept WAL append
        # Causal-trace state (None/unsampled on most tickets): the
        # router.request span context, its propagated parent span id,
        # and the CURRENT delivery attempt's span — each failover
        # replay becomes a child of the attempt it replaced, so a
        # multi-hop request renders as one chain in one tree.
        self.tctx: "tracing_mod.TraceContext | None" = None
        self.tparent: str | None = None
        self.attempt_ctx: "tracing_mod.TraceContext | None" = None
        self.attempt_parent: str | None = None
        self.attempt_t0 = 0.0


class _RouterHandler(BaseHTTPRequestHandler):
    """Routes one front-door HTTP request (the monitor ``_Handler``
    pattern: short, lock-free, every touched surface thread-safe)."""

    server: "RouterServer._Server"  # type: ignore[assignment]

    protocol_version = "HTTP/1.1"

    def _reply(self, code: int, body: str, ctype: str) -> None:
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        router = self.server.router
        router._scrapes.inc()
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                self._reply(200, router.metrics.to_prometheus(),
                            "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/replicas":
                self._reply(200, json.dumps(router.replicas_report()),
                            "application/json")
            elif path == "/snapshot":
                snap = router.metrics.snapshot()
                snap["replicas"] = router.replicas_report()
                if router.sampler is not None:
                    snap["timeseries"] = router.sampler.report(
                        points=16)
                if router.alerts is not None:
                    snap["alerts"] = router.alerts.report()
                self._reply(200, json.dumps(snap), "application/json")
            elif path == "/healthz":
                code, body = router.health()
                self._reply(code, json.dumps(body), "application/json")
            elif path == "/state":
                self._reply(200, router.state_dump(), "text/plain")
            elif path == "/timeseries":
                if router.sampler is None:
                    self._reply(404, "no sampler attached; set "
                                     "HVD_TORCH_SAMPLE_S or pass "
                                     "sampler=...\n", "text/plain")
                else:
                    self._reply(200,
                                json.dumps(router.sampler.report()),
                                "application/json")
            elif path == "/alerts":
                if router.alerts is None:
                    self._reply(404, "no alert manager attached "
                                     "(HVD_TORCH_ALERTS)\n",
                                "text/plain")
                else:
                    self._reply(200,
                                json.dumps(router.alerts.report()),
                                "application/json")
            elif path == "/advice":
                if router.advisor is None:
                    self._reply(404, "no capacity advisor attached\n",
                                "text/plain")
                else:
                    router.advisor.recommend()
                    self._reply(200,
                                json.dumps(router.advisor.report()),
                                "application/json")
            elif path == "/device":
                rep = router.device_report()
                if not rep["replicas"]:
                    self._reply(404, "no replica exposes device "
                                     "telemetry; construct engines "
                                     "with device_telemetry=True or "
                                     "set HVD_TORCH_DEVICE_TELEMETRY=1"
                                     "\n", "text/plain")
                else:
                    self._reply(200, json.dumps(rep),
                                "application/json")
            elif path == "/autoscaler":
                if router.autoscaler is None:
                    self._reply(404, "no autoscaler attached "
                                     "(HVD_TORCH_AUTOSCALE)\n",
                                "text/plain")
                else:
                    self._reply(200,
                                json.dumps(router.autoscaler.report()),
                                "application/json")
            elif path == "/traces":
                self._reply(200, json.dumps(router.tracer.recent()),
                            "application/json")
            else:
                self._reply(404, "unknown path; try /v1/generate "
                                 "/replicas /snapshot /healthz "
                                 "/metrics /state /device "
                                 "/timeseries /alerts /advice "
                                 "/autoscaler /traces\n",
                            "text/plain")
        except BrokenPipeError:
            pass

    def do_POST(self) -> None:  # noqa: N802 (http.server API)
        router = self.server.router
        path = self.path.split("?", 1)[0]
        try:
            if path != "/v1/generate":
                self._reply(404, "unknown path; POST /v1/generate\n",
                            "text/plain")
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(n).decode())
                req = request_from_json(payload)
                if req.trace_ctx is None:
                    # W3C traceparent-style header — the JSON "trace"
                    # field wins when both arrive (same trust domain,
                    # and HttpReplica hops only send the field).
                    req.trace_ctx = tracing_mod.TraceContext.from_header(
                        self.headers.get("traceparent"))
                key = payload.get("idempotency_key")
                if key is not None and not isinstance(key, str):
                    raise ValueError(
                        "idempotency_key must be a string or null")
            except (ValueError, json.JSONDecodeError) as e:
                self._reply(400, json.dumps({"error": str(e)}),
                            "application/json")
                return
            code, body = router.handle_generate(req, key)
            self._reply(code, json.dumps(body), "application/json")
        except BrokenPipeError:
            pass

    def log_message(self, fmt: str, *args: Any) -> None:
        pass        # requests must not spam the job's stderr


class RouterServer:
    """The fleet front door: routes, sheds, fails over, and reports.

    ``replicas`` is a list of :class:`ReplicaHandle`; in-process
    engines wrap in :class:`LocalReplica` automatically when you pass
    bare engines.  The HTTP server binds at construction (``port=0``
    picks an ephemeral port — read ``.port``) and serves after
    :meth:`start`; the programmatic surface (:meth:`route` /
    :meth:`result`) works without ever starting HTTP, which is how the
    bench arm and most tests drive it.

    Thread model: handler threads call :meth:`route`/:meth:`result`,
    replica pump/POST threads call the completion callbacks, one
    poller thread refreshes views — all cross-thread state lives
    behind ``_lock`` (see ``_GUARDED_BY_LOCK``).  Lock order is
    router → replica; replica callbacks always fire with no replica
    lock held, so the reverse edge never forms."""

    _GUARDED_BY_LOCK = ("_tickets", "_views", "_shadows", "_inflight",
                        "_routed", "_dead", "_cordoned", "_probe_fails",
                        "_next_rid", "_journal_results",
                        "_journal_inflight", "_journal_waiters")

    # Which thread runs what.  The poller
    # entries include the membership mutators because supervisor/
    # autoscaler call replace/add/retire/cordon from inside poll_now's
    # tick; "lifecycle" is the owning (main/test) thread, which also
    # drives membership during setup and drain.
    _THREAD_ROLES = {
        "http": ["handle_generate", "route", "result", "request_trace",
                 "health", "state_dump", "replicas_report",
                 "memory_report", "cordoned"],
        "poller": ["_poll_loop", "poll_now", "reap_tickets",
                   "_shadow_bytes", "_enforce_shadow_bound",
                   "replace_replica", "add_replica",
                   "retire_replica", "cordon_replica",
                   "uncordon_replica"],
        "replica-callback": ["_on_done", "_on_replica_death",
                             "_emit_ticket_spans"],
        "lifecycle": ["start", "stop", "replay_journal",
                      "add_replica", "retire_replica"],
    }

    class _Server(ThreadingHTTPServer):
        daemon_threads = True
        router: "RouterServer"

    def __init__(self, replicas: Sequence[Any], *,
                 policy: "RoutingPolicy | str | None" = None,
                 registry: "metrics_mod.MetricsRegistry | None" = None,
                 faults: "faults_mod.FaultRegistry | None" = None,
                 port: int = 0, host: str = "127.0.0.1",
                 min_goodput: float = 0.0,
                 min_free_kv: float = 0.0,
                 imbalance: float = 4.0,
                 poll_s: float | None = None,
                 max_failovers: int = 3,
                 probe_fails: int = 3,
                 ticket_ttl_s: float = 600.0,
                 shadow_max_paths: int = 4096,
                 shadow_max_bytes: int = 64 * 1024 * 1024,
                 journal: str | None = None,
                 journal_keys: int = 4096,
                 drain_s: float = 5.0,
                 sampler: "Any | bool | None" = None,
                 alerts: "Any | bool | None" = None,
                 autoscaler: bool | None = None,
                 clock: Callable[[], float] = time.monotonic):
        if not replicas:
            raise ValueError("router needs at least one replica")
        self.replicas: list[ReplicaHandle] = []
        names = set()
        for i, r in enumerate(replicas):
            if not isinstance(r, ReplicaHandle):
                r = LocalReplica(r, name=f"replica{i}", faults=faults)
            if r.name in names:
                raise ValueError(f"duplicate replica name {r.name!r}")
            names.add(r.name)
            if isinstance(r, LocalReplica) and r.on_death is None:
                r.on_death = self._on_replica_death
            self.replicas.append(r)
        self.policy = resolve_routing_policy(policy)
        self.metrics = (registry if registry is not None
                        else metrics_mod.MetricsRegistry())
        self.min_goodput = min_goodput
        self.min_free_kv = min_free_kv
        self.imbalance = imbalance
        self.poll_s = (poll_s if poll_s is not None else
                       env_float("HVD_TORCH_ROUTER_POLL_S", 0.05))
        # Replays allowed per request before it fails terminally — the
        # backstop that keeps a poison request (one that kills every
        # pump it touches) from cascading through the whole fleet.
        self.max_failovers = int(max_failovers)
        # Consecutive failed probes before a revivable (HTTP) replica
        # is marked dead; one blip or a still-starting backend must not
        # permanently shrink the fleet.
        self.probe_fails = max(1, int(probe_fails))
        self.ticket_ttl_s = ticket_ttl_s
        self.drain_s = drain_s
        self.faults = (faults if faults is not None
                       else faults_mod.FaultRegistry())
        #: Every router timestamp — ticket stamps, reap TTLs, drain
        #: deadlines, e2e spans — reads this clock, so a virtual clock
        #: (the simfleet driver) advances the whole bookkeeping plane
        #: without sleeping.  Default is the wall ``time.monotonic``;
        #: real waits (stop's drain sleep, the poller's cadence) stay
        #: on wall time regardless.
        self.clock = clock
        # Causal tracing plane: spans persist through this registry's
        # event sink; the sampler decision is pure (seed, rid) — see
        # horovod_tpu_torch.tracing.  Fraction 0 (the default) costs one
        # attribute test per request.
        self.tracer = tracing_mod.Tracer(self.metrics)
        self._trace_fraction = tracing_mod.env_sample_fraction()
        self._trace_seed = tracing_mod.env_trace_seed()

        self._lock = threading.Lock()
        self._next_rid = 0
        self._tickets: dict[int, _Ticket] = {}
        self.shadow_max_paths = shadow_max_paths
        # Fleet-wide shadow-index byte ceiling: the per-replica
        # max_paths bound caps each index, but at hundreds of replicas
        # the UNION is the leak — past the ceiling the poller evicts
        # oldest digests from the fattest indexes (<= 0 = unbounded).
        self.shadow_max_bytes = int(shadow_max_bytes)
        self._probe_fails: dict[str, int] = {r.name: 0
                                             for r in self.replicas}
        self._views: dict[str, dict] = {}
        self._shadows: dict[str, ShadowPrefixIndex] = {
            r.name: ShadowPrefixIndex(r.block_size, shadow_max_paths)
            for r in self.replicas}
        self._inflight: dict[str, int] = {r.name: 0
                                          for r in self.replicas}
        self._routed: dict[str, int] = {r.name: 0 for r in self.replicas}
        self._dead: set[str] = set()
        # Cordoned replicas stay healthy and keep draining their
        # in-flight work but receive no new placements — the
        # autoscaler's scale-down staging area.
        self._cordoned: set[str] = set()

        # Crash-durable request journal (off unless a path is set).
        # Recovery happens HERE, before any routing: incomplete accepts
        # from a previous incarnation park in _journal_pending until
        # start() (or an explicit replay_journal()) re-submits them, and
        # journaled terminals seed the idempotency dedup map.
        self.journal_path = (journal if journal is not None else
                            os.environ.get("HVD_TORCH_ROUTER_JOURNAL", "")) \
            or None
        # Keyed terminal results kept for idempotency dedup, LRU by
        # terminal/dedup-hit time.  Past the bound, exactly-once
        # degrades to at-least-once (an evicted key's duplicate
        # re-runs) — the price of a router whose memory and WAL don't
        # grow with lifetime traffic.
        self.journal_keys = max(1, int(journal_keys))
        self._journal: metrics_mod.EventLog | None = None
        self._journal_results: dict[str, RequestResult] = {}
        self._journal_inflight: dict[str, int] = {}     # key -> live rid
        self._journal_waiters: dict[str, list[_Ticket]] = {}
        self._journal_pending: list[dict] = []          # setup-only
        if self.journal_path:
            pending, terms = load_journal(self.journal_path)
            self._journal_pending = pending
            # File order is terminal order, so the newest keys win the
            # bound; compaction drops everything recovery no longer
            # needs (paired records, evicted keys) from the file too.
            kept = list(terms.items())[-self.journal_keys:]
            for key, rec in kept:
                self._journal_results[key] = RequestResult(
                    rec.get("tokens") or [], rec.get("status", FAILED))
            compact_journal(self.journal_path,
                            pending + [rec for _, rec in kept])
            self._journal = metrics_mod.EventLog(self.journal_path)

        #: A :class:`~horovod_tpu_torch.supervisor.ReplicaSupervisor`, once
        #: attached — ticked by the poller, reported by health().
        self.supervisor: Any = None
        #: Optional ``(replica_name, request)`` observer fired after
        #: each placement, outside the lock — the supervisor's
        #: warm-prompt feed.
        self.on_route: "Callable[[str, Request], None] | None" = None

        # Registered up front (literal names) so
        # router snapshots are schema-stable from request 0; the
        # per-decision bump composes "router.routed." + policy.name.
        self.metrics.counter("router.routed.round_robin")
        self.metrics.counter("router.routed.least_loaded")
        self.metrics.counter("router.routed.prefix_affinity")
        self.metrics.counter("router.requests")
        self.metrics.counter("router.sheds")
        self.metrics.counter("router.failovers")
        self.metrics.counter("router.replica_deaths")
        self.metrics.counter("router.replica_revives")
        self.metrics.counter("router.affinity_fallbacks")
        self.metrics.counter("router.journal_appends")
        self.metrics.counter("router.journal_errors")
        self.metrics.counter("router.journal_replays")
        self.metrics.counter("router.journal_dedups")
        self.metrics.counter("router.shadow_evictions")
        self.metrics.histogram("router.affinity_hit_tokens")
        self.metrics.histogram("router.poll_s")
        self.metrics.histogram("router.route_decision_s")
        self.metrics.histogram("router.admission_s")
        self.metrics.histogram("router.journal_append_s")
        self.metrics.histogram("router.replica_queue_s")
        self.metrics.histogram("router.e2e_s")
        self.metrics.histogram("router.failover_hops")
        self.metrics.gauge("router.replicas_healthy").set(
            len(self.replicas))
        self.metrics.gauge("router.fleet_size").set(len(self.replicas))
        self.metrics.gauge("router.inflight").set(0)
        self.metrics.gauge("router.shadow_index_bytes").set(0)
        # Scrape odometer off the shared generation cell (the monitor
        # trick) so idle /metrics scrapes stay render-cached.
        self._scrapes = self.metrics.counter("monitor.scrapes")
        self._scrapes._gen = metrics_mod._Gen()

        # Health plane over the router's own registry, ticked by the
        # poller (no extra threads): sampler -> alert rules -> capacity
        # advisor.  Same contract as ServeEngine: None = env-driven,
        # False = off, an instance is used as-is.
        if sampler is False:
            self.sampler = None
        elif sampler is None:
            self.sampler = timeseries_mod.maybe_sampler(self.metrics)
        else:
            self.sampler = sampler
        if alerts is False or self.sampler is None:
            self.alerts = None
        elif alerts is None:
            self.alerts = alerts_mod.maybe_alerts(
                self.sampler, self.metrics)
        else:
            self.alerts = alerts
        self.advisor = (alerts_mod.CapacityAdvisor(
            self.sampler, alerts=self.alerts, registry=self.metrics)
            if self.sampler is not None else None)
        #: A :class:`~horovod_tpu_torch.autoscaler.FleetAutoscaler`, once
        #: attached: ticked by the poller after the health plane, so it
        #: actuates against this pass's fresh views.  As in the
        #: reference, ``maybe_autoscaler`` attaches one when
        #: ``HVD_TORCH_AUTOSCALE`` is set (and the advisor is live);
        #: ``autoscaler=True`` attaches one whatever the knob says, its
        #: guards from the ``HVD_TORCH_AUTOSCALE_*`` knobs.  A
        #: ``FleetAutoscaler(router, ...)`` built later attaches itself
        #: the same way, with its own arguments.
        from horovod_tpu_torch import autoscaler as autoscaler_mod
        if autoscaler not in (None, True):
            raise ValueError(f"autoscaler must be None or True, "
                             f"got {autoscaler!r}")
        self.autoscaler: Any = None
        if autoscaler:
            autoscaler_mod.FleetAutoscaler(self, enabled=True)
        else:
            autoscaler_mod.maybe_autoscaler(self)

        self._httpd = RouterServer._Server((host, port), _RouterHandler)
        self._httpd.router = self
        self.host, self.port = self._httpd.server_address[:2]
        self._http_thread: threading.Thread | None = None
        self._poll_stop = threading.Event()
        self._poll_thread: threading.Thread | None = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "RouterServer":
        """Serve HTTP and start the replica poller (idempotent)."""
        if self._http_thread is None:
            self._http_thread = threading.Thread(
                target=self._httpd.serve_forever,
                name=f"hvd-router-:{self.port}", daemon=True)
            self._http_thread.start()
        if self._poll_thread is None:
            self._poll_thread = threading.Thread(
                target=self._poll_loop, name="hvd-router-poll",
                daemon=True)
            self._poll_thread.start()
        self.replay_journal()
        return self

    def stop(self, stop_replicas: bool = True,
             drain_s: float | None = None) -> None:
        """Drain, then shut down.  The drain phase waits up to
        ``drain_s`` (default: the constructor's ``drain_s``) for in-flight
        requests to finish instead of abandoning pump threads with
        work queued; a request still live at the deadline is failed
        terminally — unblocking its waiters — but a journaled one
        skips its terminal WAL record, so a restarted router replays
        it rather than losing it."""
        drain = self.drain_s if drain_s is None else drain_s
        deadline = time.monotonic() + max(drain, 0.0)
        while time.monotonic() < deadline:
            with self._lock:
                busy = sum(self._inflight.values())
            if busy == 0:
                break
            time.sleep(0.005)
        undrained: list[_Ticket] = []
        with self._lock:
            for t in self._tickets.values():
                if t.replica is not None and not t.done.is_set():
                    t.journaled = False     # keep the accept unpaired
                    t.result = RequestResult([], FAILED, RuntimeError(
                        "router shut down before completion"))
                    t.done_ts = self.clock()
                    undrained.append(t)
            # Parked idempotency duplicates have replica=None, so the
            # scan above misses them — and the original they wait on
            # was just failed WITHOUT a _journal_terminal (its accept
            # must stay unpaired for replay), so nothing will ever
            # release them.  Fail them here or their handle_generate
            # threads block forever on done.wait().
            for waiters in self._journal_waiters.values():
                for w in waiters:
                    if not w.done.is_set():
                        w.result = RequestResult([], FAILED, RuntimeError(
                            "router shut down before completion"))
                        w.done_ts = self.clock()
                        undrained.append(w)
            self._journal_waiters.clear()
            self._journal_inflight.clear()
        if undrained:
            self.metrics.event("router.drain_abandoned",
                               count=len(undrained),
                               journaled=self._journal is not None)
        for t in undrained:
            t.done.set()
        self._poll_stop.set()
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=5)
            self._poll_thread = None
        if self._http_thread is not None:
            self._httpd.shutdown()
            self._http_thread.join(timeout=5)
            self._http_thread = None
        self._httpd.server_close()
        if stop_replicas:
            for r in self.replicas:
                r.stop()
        if self._journal is not None:
            self._journal.close()

    # -- routing -----------------------------------------------------------

    def route(self, req: Request, *,
              idempotency_key: str | None = None) -> int:
        """Admit-or-shed, choose a replica, submit.  Returns the router
        request id (poll :meth:`result`); a shed request gets a
        terminal ``REJECTED`` result immediately.

        ``idempotency_key`` (journaled routers only) makes the request
        exactly-once across client retries and router restarts: a key
        whose terminal result is journaled answers from the journal
        without touching a replica; a key still in flight shares the
        original's outcome instead of running twice."""
        return self._route(req, idempotency_key).rid

    def _route(self, req: Request,
               idempotency_key: str | None = None) -> _Ticket:
        self.metrics.counter("router.requests").inc()
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            ticket = _Ticket(rid, req, self.clock())
            ticket.key = idempotency_key
            self._tickets[rid] = ticket
            in_ctx = getattr(req, "trace_ctx", None)
            if in_ctx is not None:
                # Propagated context (client header/field, or a journal
                # replay's original span): this hop is its child.
                ticket.tctx = in_ctx.child("router.request")
                ticket.tparent = in_ctx.span_id
            elif self._trace_fraction > 0.0:
                # Router-origin root, head-sampled on the request id —
                # pure (seed, rid), so simfleet replays sample
                # identically.
                ticket.tctx = tracing_mod.TraceContext.root(
                    f"router:{rid}", "router.request",
                    self._trace_fraction, self._trace_seed)
                if ticket.tctx is not None:
                    tracing_mod.count_sampled(self.metrics)
            if self._journal is not None and idempotency_key is not None:
                prior = self._journal_results.pop(idempotency_key, None)
                if prior is not None:
                    # Exactly-once: the journaled terminal IS the
                    # answer; the duplicate never reaches a replica.
                    # Re-insert to refresh LRU recency — a key still
                    # being retried is the last one to evict.
                    self._journal_results[idempotency_key] = prior
                    ticket.result = prior
                    ticket.done_ts = self.clock()
                    self.metrics.counter("router.journal_dedups").inc()
                elif idempotency_key in self._journal_inflight:
                    # Original still running: park on its outcome.
                    self._journal_waiters.setdefault(
                        idempotency_key, []).append(ticket)
                    self.metrics.counter("router.journal_dedups").inc()
                    return ticket
            if ticket.result is None:
                t0 = self.clock()
                shed = self._admission_locked()
                ticket.admission_s = self.clock() - t0
                if shed is not None:
                    self._shed_locked(ticket, shed)
                    return ticket
                if self._journal is not None:
                    ticket.journaled = True
                    if idempotency_key is not None:
                        self._journal_inflight[idempotency_key] = rid
                t0 = self.clock()
                handle, info = self._place_locked(ticket)
                ticket.route_decision_s = self.clock() - t0
        if ticket.result is not None:       # journal dedup hit
            ticket.done.set()
            return ticket
        if ticket.journaled:
            # Accept is durable BEFORE the submit: a crash between the
            # append and the callback replays the request on restart.
            t0 = self.clock()
            self._journal_append(
                "router.accept", rid=rid, key=idempotency_key,
                req=request_to_json(req),
                # The router.request span context rides the accept
                # record so a crash-recovery replay rejoins the SAME
                # trace as a child of this span (one tree across
                # incarnations).
                trace=(ticket.tctx.to_dict()
                       if ticket.tctx is not None else None))
            ticket.journal_s = self.clock() - t0
            self.metrics.histogram("router.journal_append_s").observe(
                ticket.journal_s)
        self.metrics.histogram("router.admission_s").observe(
            ticket.admission_s)
        self.metrics.histogram("router.route_decision_s").observe(
            ticket.route_decision_s)
        self.metrics.event("router.route", rid=rid, replica=handle.name,
                           policy=ticket.policy, **info)
        if self.on_route is not None:
            self.on_route(handle.name, req)
        ticket.submit_ts = self.clock()
        if ticket.tctx is not None:
            # First delivery attempt: the engine (or remote hop) will
            # parent its serve.request span under this attempt, so the
            # request object carries the attempt context from here on.
            ticket.attempt_ctx = ticket.tctx.child("replica.attempt")
            ticket.attempt_parent = ticket.tctx.span_id
            ticket.attempt_t0 = ticket.submit_ts
            req.trace_ctx = ticket.attempt_ctx
        handle.submit(req, lambda res, t=ticket: self._on_done(t, res))
        return ticket

    def result(self, rid: int,
               timeout: float | None = None) -> RequestResult | None:
        """Block for a routed request's terminal result (``None`` on
        timeout — the request is still in flight somewhere)."""
        with self._lock:
            ticket = self._tickets.get(rid)
        if ticket is None:
            raise KeyError(f"unknown router rid {rid}")
        if not ticket.done.wait(timeout):
            return None
        return ticket.result

    def request_trace(self, rid: int) -> "dict | None":
        """The merged end-to-end latency trace for a finished rid:
        the engine-side :class:`~horovod_tpu_torch.metrics.Trace` fields
        (queue wait, TTFT, decode cadence) plus a ``router`` sub-dict
        of front-door spans (receive → admission → route decision →
        journal append → submit → done).  ``None`` while the request
        is still in flight; ``KeyError`` for an unknown/reaped rid —
        read it before the ticket TTL, like :meth:`result`."""
        with self._lock:
            ticket = self._tickets.get(rid)
        if ticket is None:
            raise KeyError(f"unknown router rid {rid}")
        if not ticket.done.is_set():
            return None
        return self._merged_trace(ticket)

    def _merged_trace(self, ticket: _Ticket) -> dict:
        """Join the engine trace with router-side spans.  All stamps
        are ``time.monotonic`` in THIS process, so local-replica engine
        stamps subtract cleanly from router stamps; an HTTP replica's
        trace arrives as a dict in the remote clock domain and is
        passed through untouched (its ``*_s`` durations still join)."""
        base: dict = {}
        res = ticket.result
        tr = getattr(res, "trace", None)
        if hasattr(tr, "to_dict"):
            base = tr.to_dict()
        elif isinstance(tr, dict):
            base = {k: v for k, v in tr.items() if k != "router"}
        router: dict = {
            "recv_ts": ticket.recv_ts,
            "submit_ts": ticket.submit_ts or None,
            "done_ts": ticket.done_ts or None,
            "route_decision_s": ticket.route_decision_s,
            "admission_s": ticket.admission_s,
            "journal_append_s": ticket.journal_s,
            "accept_to_submit_s": (ticket.submit_ts - ticket.recv_ts
                                   if ticket.submit_ts > 0 else None),
            "failovers": ticket.failovers,
            "replica": ticket.replica,
            "shed": ticket.shed,
            # Sampled requests carry their trace identity out to the
            # client (and loadgen's attribution records) so a slow
            # reply links straight to its reconstructable span tree.
            "trace_id": (ticket.tctx.trace_id
                         if ticket.tctx is not None else None),
            "span_id": (ticket.tctx.span_id
                        if ticket.tctx is not None else None),
        }
        if ticket.done_ts > 0:
            router["e2e_s"] = ticket.done_ts - ticket.recv_ts
        enq = getattr(tr, "enqueue_ts", None)
        if ticket.submit_ts > 0 and enq is not None:
            router["replica_queue_s"] = max(enq - ticket.submit_ts, 0.0)
        term = getattr(tr, "terminal_ts", None)
        if term is not None and ticket.done_ts > 0:
            router["finish_s"] = max(ticket.done_ts - term, 0.0)
        base["router"] = router
        return base

    def _emit_ticket_spans(self, ticket: _Ticket, res: Any,
                           attempt_done: bool = False) -> None:
        """Post-hoc span emission for a finished sampled ticket — all
        stamps come from the ticket (the injectable router clock), so
        virtual-time drivers trace without wall reads.  The front-door
        sub-spans (admission → route decision → journal append) tile
        sequentially from the receive stamp; ``attempt_done`` skips the
        final attempt span when the failover path already closed it."""
        tctx = ticket.tctx
        cur = ticket.recv_ts
        for name, dur in (("router.admission", ticket.admission_s),
                          ("router.route_decision",
                           ticket.route_decision_s),
                          ("router.journal_append", ticket.journal_s)):
            if dur > 0.0:
                self.tracer.span(tctx.child(name), name, cur, cur + dur,
                                 parent_id=tctx.span_id)
                cur += dur
        if ticket.attempt_ctx is not None and not attempt_done:
            self.tracer.span(
                ticket.attempt_ctx, "replica.attempt",
                ticket.attempt_t0, ticket.done_ts,
                parent_id=ticket.attempt_parent, rid=ticket.rid,
                replica=ticket.replica,
                status=getattr(res, "status", None))
        self.tracer.span(
            tctx, "router.request", ticket.recv_ts, ticket.done_ts,
            parent_id=ticket.tparent, rid=ticket.rid,
            replica=ticket.replica, failovers=ticket.failovers,
            policy=ticket.policy, shed=ticket.shed,
            status=getattr(res, "status", None))

    def reap_tickets(self, older_than_s: float | None = None) -> int:
        """Drop tickets whose terminal result has been readable for at
        least ``older_than_s`` seconds (default ``ticket_ttl_s``);
        returns how many were dropped.  The poller runs this every
        pass and ``handle_generate`` pops its own ticket with the HTTP
        reply, so the ticket table stays bounded under an indefinite
        request stream.  Programmatic :meth:`route`/:meth:`result`
        users must read a result within the TTL — :meth:`result`
        raises ``KeyError`` for a reaped rid."""
        ttl = self.ticket_ttl_s if older_than_s is None else older_than_s
        now = self.clock()
        with self._lock:
            dead = [rid for rid, t in self._tickets.items()
                    if t.done.is_set() and now - t.done_ts >= ttl]
            for rid in dead:
                del self._tickets[rid]
        return len(dead)

    def handle_generate(self, req: Request,
                        idempotency_key: str | None = None,
                        ) -> tuple[int, dict]:
        """The ``POST /v1/generate`` body: route, wait, and shape the
        JSON reply.  Shed requests answer 429 (back off and retry is
        the right client response to load shedding); every other
        terminal status is a 200 whose ``status`` field speaks."""
        ticket = self._route(req, idempotency_key)
        ticket.done.wait()
        with self._lock:
            # Claim the ticket with the reply: the HTTP reply is its
            # only reader, and a front door that never forgets a
            # finished request leaks prompt+result tokens without
            # bound.  The claim must come AFTER the wait — a ticket
            # popped at entry is invisible to stop()'s undrained scan,
            # which would leave this handler thread blocked forever on
            # a shutdown-abandoned request.
            self._tickets.pop(ticket.rid, None)
        res = ticket.result
        body = {"rid": ticket.rid, "status": res.status,
                "tokens": list(res),
                "replica": ticket.replica,
                "failovers": ticket.failovers,
                "trace": self._merged_trace(ticket)}
        if ticket.shed is not None:
            body["shed"] = ticket.shed
        if res.error is not None:
            body["error"] = str(res.error)
        code = 429 if ticket.shed is not None else 200
        return code, body

    def _admission_locked(self) -> str | None:
        """Shed reason, or ``None`` to admit.  Fleet goodput / free-KV
        are means over the healthy replicas' last-polled views; a
        never-polled replica counts as healthy and empty (no evidence
        of badness — exactly the SLO window's empty-window stance)."""
        healthy = [r.name for r in self.replicas
                   if r.name not in self._dead
                   and r.name not in self._cordoned]
        if not healthy:
            # A fully-cordoned-but-alive fleet still serves (the
            # cordon is advisory scale-down staging, not an outage);
            # only a fleet with no live replica at all sheds.
            healthy = [r.name for r in self.replicas
                       if r.name not in self._dead]
        if not healthy:
            return "no_replicas"
        if self.min_goodput > 0:
            vals = [self._views.get(n, {}).get("goodput", 1.0)
                    for n in healthy]
            if sum(vals) / len(vals) < self.min_goodput:
                return "goodput"
        if self.min_free_kv > 0:
            vals = [self._views.get(n, {}).get("free_kv_frac", 1.0)
                    for n in healthy]
            if sum(vals) / len(vals) < self.min_free_kv:
                return "free_kv"
        return None

    def _shed_locked(self, ticket: _Ticket, reason: str) -> None:
        ticket.shed = reason
        ticket.result = RequestResult([], REJECTED)
        self.metrics.counter("router.sheds").inc()
        self.metrics.event("router.shed", rid=ticket.rid, reason=reason)
        ticket.done_ts = self.clock()
        ticket.done.set()

    def _place_locked(
            self, ticket: _Ticket) -> tuple[ReplicaHandle, dict]:
        """Pick a healthy replica with the policy and book the ticket
        onto it (caller submits outside the lock); returns the handle
        plus the policy's info dict for the ``router.route`` event."""
        candidates = [r.name for r in self.replicas
                      if r.name not in self._dead
                      and r.name not in self._cordoned]
        if not candidates:
            # Never fail a request over a cordon: if every live
            # replica is cordoned (mid-drain fleet at the min bound,
            # or a failover racing a scale-down), place on a live
            # cordoned replica rather than dropping.
            candidates = [r.name for r in self.replicas
                          if r.name not in self._dead]
        ctx = RoutingContext(self._views, self._shadows, self._inflight,
                             self.imbalance)
        name, info = self.policy.choose(candidates, ticket.req, ctx)
        ticket.replica = name
        ticket.policy = self.policy.name
        self._routed[name] = self._routed.get(name, 0) + 1
        self._inflight[name] = self._inflight.get(name, 0) + 1
        self.metrics.counter("router.routed." + self.policy.name).inc()
        self.metrics.gauge("router.inflight").set(
            sum(self._inflight.values()))
        if "affinity_hit_tokens" in info:
            self.metrics.histogram("router.affinity_hit_tokens").observe(
                info["affinity_hit_tokens"])
        if info.get("fallback"):
            self.metrics.counter("router.affinity_fallbacks").inc()
        self._shadows[name].observe(ticket.req.prompt)
        return self._handle(name), info

    def _handle(self, name: str) -> ReplicaHandle:
        for r in self.replicas:
            if r.name == name:
                return r
        raise KeyError(name)

    # -- completion + failover ---------------------------------------------

    def _on_done(self, ticket: _Ticket,
                 res: "RequestResult | None") -> None:
        """Completion callback from a replica thread.  A real result is
        terminal; ``None`` means the replica died with this request in
        flight — re-enqueue it on a survivor (replay from the full
        prompt is bit-identical) or fail it when the fleet is gone."""
        if res is not None:
            with self._lock:
                if ticket.done.is_set():
                    return
                ticket.result = res
                if ticket.replica is not None:
                    n = self._inflight.get(ticket.replica, 1)
                    self._inflight[ticket.replica] = max(n - 1, 0)
                self.metrics.gauge("router.inflight").set(
                    sum(self._inflight.values()))
                ticket.done_ts = self.clock()
            self.metrics.histogram("router.e2e_s").observe(
                ticket.done_ts - ticket.recv_ts,
                # OpenMetrics-style exemplar: the p99 bucket links
                # straight to a reconstructable trace.
                exemplar=(ticket.tctx.trace_id
                          if ticket.tctx is not None else None))
            self.metrics.histogram("router.failover_hops").observe(
                float(ticket.failovers))
            tr = getattr(res, "trace", None)
            if (ticket.submit_ts > 0
                    and getattr(tr, "enqueue_ts", None) is not None):
                # Same-process monotonic clocks: the engine enqueue
                # stamp joins the router submit stamp directly.
                self.metrics.histogram("router.replica_queue_s").observe(
                    max(tr.enqueue_ts - ticket.submit_ts, 0.0))
            if ticket.tctx is not None:
                self._emit_ticket_spans(ticket, res)
            ticket.done.set()
            if ticket.journaled:
                self._journal_terminal(ticket, res)
            return
        with self._lock:
            if ticket.done.is_set():
                return
            old = ticket.replica
            if old is not None:
                n = self._inflight.get(old, 1)
                self._inflight[old] = max(n - 1, 0)
            err: RuntimeError | None = None
            if all(r.name in self._dead for r in self.replicas):
                err = RuntimeError("no healthy replicas for failover")
            elif ticket.failovers >= self.max_failovers:
                # A request that kills every replica it lands on would
                # otherwise walk the whole fleet dead; stop replaying
                # after max_failovers and fail THIS request instead.
                err = RuntimeError(
                    f"request failed over {ticket.failovers} times "
                    f"(max_failovers={self.max_failovers}); not "
                    "replaying again")
            if err is not None:
                ticket.result = RequestResult([], FAILED, err)
                self.metrics.gauge("router.inflight").set(
                    sum(self._inflight.values()))
                ticket.done_ts = self.clock()
            else:
                ticket.failovers += 1
                self.metrics.counter("router.failovers").inc()
                handle, info = self._place_locked(ticket)
            failed_attempt = None
            if ticket.tctx is not None and ticket.attempt_ctx is not None:
                # Close the failed attempt's span and (on replay) chain
                # the next attempt as its CHILD — the failover replay
                # renders under the hop it replaced, one tree.
                now = self.clock()
                failed_attempt = (ticket.attempt_ctx,
                                  ticket.attempt_parent,
                                  ticket.attempt_t0, now, old)
                if err is None:
                    ticket.attempt_parent = ticket.attempt_ctx.span_id
                    ticket.attempt_ctx = ticket.attempt_ctx.child(
                        "replica.attempt", seq=ticket.failovers)
                    ticket.attempt_t0 = now
                    ticket.req.trace_ctx = ticket.attempt_ctx
        if failed_attempt is not None:
            ctx, parent, t0, t1, replica = failed_attempt
            self.tracer.span(ctx, "replica.attempt", t0, t1,
                             parent_id=parent, rid=ticket.rid,
                             replica=replica,
                             status="failover" if err is None
                             else "failed")
        if err is not None:
            if ticket.tctx is not None:
                self._emit_ticket_spans(ticket, ticket.result,
                                        attempt_done=failed_attempt
                                        is not None)
            ticket.done.set()
            if ticket.journaled:
                self._journal_terminal(ticket, ticket.result)
            return
        self.metrics.event("router.failover", rid=ticket.rid,
                           src=old, dst=handle.name, **info)
        if self.on_route is not None:
            self.on_route(handle.name, ticket.req)
        handle.submit(ticket.req,
                      lambda res2, t=ticket: self._on_done(t, res2))

    def _on_replica_death(self, replica: ReplicaHandle) -> None:
        self._mark_dead(replica.name)

    def _mark_dead(self, name: str) -> None:
        with self._lock:
            if name in self._dead:
                return
            self._dead.add(name)
            healthy = len(self.replicas) - len(self._dead)
        self.metrics.counter("router.replica_deaths").inc()
        self.metrics.gauge("router.replicas_healthy").set(healthy)
        self.metrics.event("router.replica_death", replica=name)

    def _mark_alive(self, name: str) -> None:
        """Return a revived replica to the candidate set (poll path
        only, for ``can_revive`` handles whose probes turned healthy)."""
        with self._lock:
            if name not in self._dead:
                return
            self._dead.discard(name)
            healthy = len(self.replicas) - len(self._dead)
        self.metrics.counter("router.replica_revives").inc()
        self.metrics.gauge("router.replicas_healthy").set(healthy)
        self.metrics.event("router.replica_revive", replica=name)

    def replace_replica(self, name: str, handle: ReplicaHandle) -> None:
        """Swap a (dead) replica's handle for a fresh one under the
        same name and return it to the candidate set — the
        supervisor's respawn commit point.  The shadow index survives
        the swap: its paths are phantoms for the fresh engine's empty
        cache (benign — one suboptimal route each) until warm replay
        and the poller's digest feed repopulate it."""
        if isinstance(handle, LocalReplica) and handle.on_death is None:
            handle.on_death = self._on_replica_death
        with self._lock:
            for i, r in enumerate(self.replicas):
                if r.name == name:
                    self.replicas[i] = handle
                    break
            else:
                raise KeyError(name)
            self._probe_fails[name] = 0
            self._views.pop(name, None)
        self._mark_alive(name)

    # -- elastic membership (the autoscaler's actuation surface) -----------

    def cordon_replica(self, name: str) -> None:
        """Remove a replica from the routing candidate set without
        touching its health: no new placements land on it, while its
        in-flight requests keep draining (finish normally, or fail
        open into failover/journal replay if it dies).  Probes, views,
        and the shadow index all keep running, so :meth:`uncordon_replica`
        is a full no-cost undo."""
        with self._lock:
            if not any(r.name == name for r in self.replicas):
                raise KeyError(name)
            if name in self._cordoned:
                return
            self._cordoned.add(name)
        self.metrics.event("router.cordon", replica=name)

    def uncordon_replica(self, name: str) -> None:
        """Return a cordoned replica to the candidate set."""
        with self._lock:
            if name not in self._cordoned:
                return
            self._cordoned.discard(name)
        self.metrics.event("router.uncordon", replica=name)

    def add_replica(self, handle: Any, *,
                    name: str | None = None) -> ReplicaHandle:
        """Join a brand-new replica to the fleet (the autoscaler's
        grow commit point; bare engines wrap like the constructor).
        The newcomer starts with an empty shadow index and zero
        counters and is immediately routable."""
        if not isinstance(handle, ReplicaHandle):
            handle = LocalReplica(handle,
                                  name=name or "replica-new",
                                  faults=self.faults)
        if isinstance(handle, LocalReplica) and handle.on_death is None:
            handle.on_death = self._on_replica_death
        with self._lock:
            if any(r.name == handle.name for r in self.replicas):
                raise ValueError(
                    f"duplicate replica name {handle.name!r}")
            self.replicas.append(handle)
            self._probe_fails[handle.name] = 0
            self._shadows[handle.name] = ShadowPrefixIndex(
                handle.block_size, self.shadow_max_paths)
            self._inflight[handle.name] = 0
            self._routed[handle.name] = 0
            healthy = len(self.replicas) - len(self._dead)
        self.metrics.gauge("router.replicas_healthy").set(healthy)
        self.metrics.event("router.replica_join", replica=handle.name)
        return handle

    def retire_replica(self, name: str, *,
                       stop: bool = True) -> ReplicaHandle:
        """Remove a replica from the fleet entirely (the autoscaler's
        scale-down commit point, after cordon + drain).  The caller
        owns the drain: retiring with in-flight work abandons those
        callbacks, so cordon first and wait for (or force) zero
        inflight.  Returns the removed handle."""
        with self._lock:
            if len(self.replicas) <= 1:
                raise ValueError(
                    "refusing to retire the last replica")
            for i, r in enumerate(self.replicas):
                if r.name == name:
                    handle = self.replicas.pop(i)
                    break
            else:
                raise KeyError(name)
            inflight = self._inflight.pop(name, 0)
            self._routed.pop(name, None)
            self._views.pop(name, None)
            self._shadows.pop(name, None)
            self._probe_fails.pop(name, None)
            self._cordoned.discard(name)
            self._dead.discard(name)
            healthy = len(self.replicas) - len(self._dead)
        self.metrics.gauge("router.replicas_healthy").set(healthy)
        self.metrics.event("router.replica_retire", replica=name,
                           inflight=inflight)
        if stop:
            handle.stop()
        return handle

    def cordoned(self) -> list[str]:
        with self._lock:
            return sorted(self._cordoned)

    # -- the request journal -----------------------------------------------

    def _journal_append(self, kind: str, **fields: Any) -> None:
        """One WAL append, fault-isolated: a failed journal write (the
        ``router.journal`` fault site, or a real disk error) degrades
        durability — counted and evented — but never fails the
        request being served."""
        if self._journal is None:
            return
        try:
            self.faults.check("router.journal", key=kind)
            self._journal.emit(kind, **fields)
        except Exception as e:
            self.metrics.counter("router.journal_errors").inc()
            self.metrics.event("router.journal_error", record=kind,
                               error=str(e))
        else:
            self.metrics.counter("router.journal_appends").inc()

    def _journal_terminal(self, ticket: _Ticket,
                          res: RequestResult) -> None:
        """Record a journaled request's terminal outcome and release
        its idempotency key: the result becomes the exactly-once
        answer for later duplicates, and every ticket parked on the
        key completes with the same result."""
        waiters: list[_Ticket] = []
        with self._lock:
            if ticket.key is not None:
                self._journal_results[ticket.key] = res
                while len(self._journal_results) > self.journal_keys:
                    self._journal_results.pop(
                        next(iter(self._journal_results)))
                self._journal_inflight.pop(ticket.key, None)
                waiters = self._journal_waiters.pop(ticket.key, [])
        self._journal_append(
            "router.terminal", rid=ticket.rid, key=ticket.key,
            status=res.status, tokens=list(res),
            error=None if res.error is None else str(res.error))
        for w in waiters:
            with self._lock:
                if w.done.is_set():
                    continue
                w.result = res
                w.done_ts = self.clock()
            w.done.set()

    def replay_journal(self) -> int:
        """Re-submit every journaled accept with no terminal record
        (crash recovery; :meth:`start` runs this once).  Greedy
        determinism makes each replayed result bit-identical to what
        the lost incarnation would have produced, and keyed requests
        land back in the dedup map so their clients' retries find
        them.  Each replay routes under THIS incarnation's own fresh
        accept record, so once it is durable a ``router.replayed``
        marker retires the original accept — without it the original
        would stay forever unpaired and re-run on every future
        restart, not just this one.  Returns the number of requests
        replayed."""
        pending, self._journal_pending = self._journal_pending, []
        n = 0
        for rec in pending:
            try:
                req = request_from_json(rec.get("req") or {})
            except ValueError:
                # Poisoned or truncated record: it can never replay,
                # so retire it rather than re-parse-and-skip it in
                # every incarnation from now on.
                self._journal_append("router.replayed",
                                     pid=rec.get("pid"),
                                     rid=rec.get("rid"),
                                     key=rec.get("key"), poisoned=True)
                continue
            self.metrics.counter("router.journal_replays").inc()
            self.metrics.event("router.journal_replay",
                               key=rec.get("key"))
            # Rejoin the original trace: the accept record carried the
            # dead incarnation's router.request span, so this replay's
            # span becomes its child — crash-recovery chains render as
            # ONE tree across (pid, rid) incarnations.
            tctx = tracing_mod.TraceContext.from_dict(rec.get("trace"))
            if tctx is not None:
                req.trace_ctx = tctx
            ticket = self._route(req, rec.get("key"))
            if ticket.journaled:
                # The fresh accept hit the WAL inside _route, so the
                # request now survives on its own record; a shed
                # replay (journaled=False) keeps the original accept
                # live for the next incarnation instead.
                self._journal_append("router.replayed",
                                     pid=rec.get("pid"),
                                     rid=rec.get("rid"),
                                     key=rec.get("key"))
            n += 1
        return n

    # -- polling + reports -------------------------------------------------

    def poll_now(self) -> None:
        """One synchronous poll pass (the poller thread's body; tests
        and the bench call it directly for deterministic views).

        Death is debounced for revivable replicas: an HTTP replica
        needs ``probe_fails`` CONSECUTIVE failed probes before it
        leaves the candidate set (one ``/healthz`` blip, or a backend
        still starting at the first 0.05s poll, must not permanently
        shrink the fleet), and a healthy probe brings it back.  A
        local replica's probe is authoritative — its pump thread is
        gone — so it dies on the first unhealthy view and stays dead."""
        # Pass duration is measured on the wall (perf_counter), never
        # the injectable clock: under virtual time the pass itself
        # still costs real host work, and that cost scaling with fleet
        # size is exactly what router.poll_s exists to expose.
        pass_t0 = time.perf_counter()
        for r in list(self.replicas):
            try:
                view = r.probe()
            except Exception:
                view = {"healthy": False}
            healthy = bool(view.get("healthy", False))
            with self._lock:
                self._views[r.name] = view
                self._shadows[r.name].load(view.get("prefix"))
                if healthy:
                    self._probe_fails[r.name] = 0
                else:
                    self._probe_fails[r.name] = \
                        self._probe_fails.get(r.name, 0) + 1
                fails = self._probe_fails[r.name]
            if healthy:
                if r.can_revive:
                    self._mark_alive(r.name)  # no-op when not dead
            elif not r.can_revive or fails >= self.probe_fails:
                self._mark_dead(r.name)       # no-op when already dead
        self.metrics.gauge("router.shadow_index_bytes").set(
            self._enforce_shadow_bound(self._shadow_bytes()))
        sup = self.supervisor
        if sup is not None:
            sup.tick()
        # Health plane rides the poll cadence — cheap no-ops between
        # sampling/evaluation deadlines.
        if self.sampler is not None:
            self.sampler.tick()
            if self.alerts is not None:
                self.alerts.tick()
        asc = self.autoscaler
        if asc is not None:
            asc.tick()
        self.reap_tickets()
        self.metrics.gauge("router.fleet_size").set(len(self.replicas))
        self.metrics.histogram("router.poll_s").observe(
            time.perf_counter() - pass_t0)

    def _poll_loop(self) -> None:
        while not self._poll_stop.wait(self.poll_s):
            self.poll_now()

    def _shadow_bytes(self) -> int:
        with self._lock:
            return sum(s.approx_footprint_bytes()
                       for s in self._shadows.values())

    def _enforce_shadow_bound(self, total: int) -> int:
        """Evict oldest shadow digests until the fleet-wide footprint
        fits ``shadow_max_bytes``.  The per-index ``max_paths`` FIFO
        caps each replica, but at hundreds of replicas the *union* is
        the leak; the poller trims the fattest indexes an eighth at a
        time so steady-state cost is a handful of deque pops, not a
        rebuild.  The running total is decremented by each victim's
        measured shrink rather than re-summed fleet-wide — at 200+
        replicas a full sizeof scan per eviction round turns the poll
        pass quadratic.  Returns the (possibly reduced) total."""
        if self.shadow_max_bytes <= 0:
            return total
        evicted = 0
        while total > self.shadow_max_bytes:
            with self._lock:
                victim = max(self._shadows.values(), key=len,
                             default=None)
                if victim is None or len(victim) == 0:
                    break
                before = victim.approx_footprint_bytes()
                evicted += victim.evict_oldest(max(len(victim) // 8, 1))
                total -= before - victim.approx_footprint_bytes()
        if evicted:
            self.metrics.counter("router.shadow_evictions").inc(evicted)
            self.metrics.event("router.shadow_evict", digests=evicted)
        return total

    def health(self) -> tuple[int, dict]:
        """``GET /healthz``: 200 while at least one replica is
        routable, 503 once the whole fleet is dead.  ``degraded`` is
        true while the fleet runs on its supervisor's restart budget
        (a respawned or circuit-broken replica) — still a 200, but a
        deploy gate should notice."""
        with self._lock:
            healthy = [r.name for r in self.replicas
                       if r.name not in self._dead]
            cordoned = sorted(self._cordoned)
            draining = sorted(n for n in self._cordoned
                              if self._inflight.get(n, 0) > 0)
            body = {"ok": bool(healthy), "replicas": len(self.replicas),
                    "healthy": len(healthy), "pid": os.getpid(),
                    "cordoned": cordoned, "draining": draining}
        sup = self.supervisor
        body["degraded"] = bool(sup is not None and sup.degraded())
        asc = self.autoscaler
        if asc is not None:
            body["epoch"] = asc.epoch.generation
        return (200 if body["ok"] else 503), body

    def state_dump(self) -> str:
        """Human-readable router state (the engine ``state_dump``
        contract one layer up; served at ``GET /state``): per-replica
        health and routing counts, ticket/journal bookkeeping, and —
        with a supervisor attached — each replica's restart history."""
        lines = [f"RouterServer policy={self.policy.name} "
                 f"port={self.port} pid={os.getpid()}"]
        with self._lock:
            n_tickets = len(self._tickets)
            n_done = sum(1 for t in self._tickets.values()
                         if t.done.is_set())
            dead = set(self._dead)
            cordoned = set(self._cordoned)
            rows = [(r.name, self._routed.get(r.name, 0),
                     self._inflight.get(r.name, 0))
                    for r in self.replicas]
            n_keys = len(self._journal_results)
            n_inflight_keys = len(self._journal_inflight)
        lines.append(f"  tickets: {n_tickets} ({n_done} terminal)")
        if self.journal_path:
            lines.append(f"  journal: {self.journal_path} "
                         f"(keys={n_keys} "
                         f"inflight_keys={n_inflight_keys})")
        for name, routed, infl in rows:
            state = "DEAD" if name in dead else "up"
            if name in cordoned:
                state += " CORDONED" + (" draining" if infl else
                                        " drained")
            lines.append(f"  replica {name}: {state} "
                         f"routed={routed} inflight={infl}")
        if self.alerts is not None:
            arep = self.alerts.report()
            lines.append(f"  alerts: firing={arep['firing']} "
                         f"pending={arep['pending']} "
                         f"transitions={len(arep['history'])}")
        if self.advisor is not None:
            rec = self.advisor.recommend()
            lines.append(f"  advice: {rec['action']} n={rec['n']} "
                         f"({rec['reason']})")
        asc = self.autoscaler
        if asc is not None:
            arep = asc.report()
            last = arep["last_action"]
            lines.append(
                f"  autoscaler: epoch={arep['epoch']['generation']} "
                f"size={arep['size']} draining={arep['draining']}"
                + (f" last={last['action']}" if last else ""))
        sup = self.supervisor
        if sup is not None:
            for name, st in sorted(sup.state().items()):
                hist = " ".join("ok" if h["ok"] else "fail"
                                for h in st["history"])
                lines.append(
                    f"  supervisor {name}: "
                    f"restarts={st['restarts']}/{st['max_restarts']}"
                    + (" PERMANENT-DEAD" if st["permanent_dead"] else "")
                    + (f" history=[{hist}]" if hist else ""))
        return "\n".join(lines) + "\n"

    def replicas_report(self) -> list[dict]:
        """``GET /replicas``: per-replica routing/health detail the
        label-less Prometheus names can't carry."""
        out = []
        with self._lock:
            for r in self.replicas:
                shadow = self._shadows[r.name]
                infl = self._inflight.get(r.name, 0)
                out.append({
                    "name": r.name,
                    "healthy": r.name not in self._dead,
                    "cordoned": r.name in self._cordoned,
                    "draining": (r.name in self._cordoned
                                 and infl > 0),
                    "routed": self._routed.get(r.name, 0),
                    "inflight": infl,
                    "view": dict(self._views.get(r.name, {}),
                                 prefix=None),
                    "shadow_paths": len(shadow),
                    "shadow_block_size": shadow.block_size,
                })
        return out

    def device_report(self) -> dict:
        """``GET /device``: fleet view of per-replica device telemetry.
        Only in-process :class:`LocalReplica` engines expose the plane
        directly (an HTTP replica's ``/device`` lives on its own
        monitor); replicas without telemetry are listed by name so the
        fleet summary is honest about its coverage.  MFU aggregates
        skip replicas with no honest peak — the summary's ``mfu_*``
        keys are present only when at least one replica reports one."""
        with self._lock:
            handles = list(self.replicas)
        per: dict[str, dict] = {}
        without: list[str] = []
        for r in handles:
            # the port's engine keeps its plane at .device_telemetry
            dev = getattr(getattr(r, "engine", None), "device_telemetry",
                          None)
            if dev is None:
                without.append(r.name)
            else:
                per[r.name] = dev.report()
        out: dict[str, Any] = {
            "replicas": per,
            "without_telemetry": sorted(without),
        }
        mfus = [rep["win"]["mfu"] for rep in per.values()
                if rep["win"]["mfu"] is not None]
        summary: dict[str, Any] = {
            "n_reporting": len(per),
            "fleet_flops_per_s": sum(
                rep["win"]["flops_per_s"] for rep in per.values()),
        }
        if mfus:
            summary["mfu_min"] = min(mfus)
            summary["mfu_max"] = max(mfus)
            summary["mfu_mean"] = sum(mfus) / len(mfus)
        out["summary"] = summary
        return out

    def memory_report(self) -> dict:
        """Host-side footprint of the router's own bookkeeping — the
        shadow indexes dominate; ``approx_footprint_bytes`` is their
        sum (also the ``router.shadow_index_bytes`` gauge)."""
        with self._lock:
            per_replica = {n: s.approx_footprint_bytes()
                           for n, s in self._shadows.items()}
            tickets = len(self._tickets)
        total = sum(per_replica.values())
        self.metrics.gauge("router.shadow_index_bytes").set(total)
        return {"approx_footprint_bytes": total,
                "shadow_index_bytes": per_replica,
                "tickets": tickets}


def maybe_start_router(replicas: Sequence[Any],
                       **kwargs: Any) -> RouterServer | None:
    """Start a front door when ``HVD_TORCH_ROUTER_PORT`` is set (the
    ``maybe_start_monitor`` contract: unset → None silently,
    unparsable/taken port → warn, never crash the job)."""
    raw = os.environ.get("HVD_TORCH_ROUTER_PORT")
    if not raw:
        return None
    try:
        port = int(raw)
    except ValueError:
        warnings.warn(f"HVD_TORCH_ROUTER_PORT={raw!r} is not an int; "
                      "router disabled", RuntimeWarning, stacklevel=2)
        return None
    try:
        return RouterServer(replicas, port=port, **kwargs).start()
    except OSError as e:
        warnings.warn(f"router port {port} unavailable ({e}); "
                      "router disabled", RuntimeWarning, stacklevel=2)
        return None


# ---------------------------------------------------------------------------
# Bench arm: affinity routing vs round robin over an in-process fleet.
# ---------------------------------------------------------------------------


def measure_router_fleet(
    params: dict, cfg: Any, *,
    n_replicas: int = 3, n_groups: int = 4, waves: int = 6,
    prefix_blocks: int = 4, suffix_len: int = 4,
    max_new_tokens: int = 8, n_slots: int = 4,
    chunk: int = 16, max_len: int | None = None,
    policies: Sequence[str] = ("round_robin", "prefix_affinity"),
) -> dict:
    """Fleet prefix hit rate and throughput, affinity vs round robin
    (the ``serve_router_*`` bench metrics).

    The workload is ``n_groups`` families sharing a
    ``prefix_blocks * chunk``-token prefix, submitted in ``waves``
    rounds of one request per family (each wave waits for the previous
    — the steady drip of a production prompt family, and it makes hit
    accounting deterministic).  Keep ``n_groups`` non-multiple of
    ``n_replicas``: with ``G == R`` round robin aligns each family to
    one replica by accident and the contrast vanishes.  Each policy
    serves the identical workload on a fresh ``n_replicas``-engine fleet
    whose programs warm up untimed on a disjoint prompt first (the port
    compiles nothing; the warmup keeps the first timed wave's caches
    cold), so the timed passes compare *routing* — affinity concentrates
    each family on one replica (first wave misses, the rest hit); round
    robin smears it across the fleet (one cold miss per replica per
    family).  Outputs are asserted token-identical across policies
    (routing must never change tokens).  Returns per-policy
    ``serve_router_hit_rate_<policy>`` /
    ``serve_router_tokens_per_sec_<policy>`` plus the affinity-minus-
    round-robin ``serve_router_hit_rate_gain`` and workload shape."""
    from horovod_tpu_torch.serving_scheduler import ServeEngine

    prefix_len = prefix_blocks * chunk
    if max_len is None:
        need = prefix_len + suffix_len + max_new_tokens + chunk
        max_len = -(-need // chunk) * chunk     # block-aligned
    workload: list[Request] = []
    for w in range(waves):
        for g in range(n_groups):
            prefix = [(11 + 13 * g + i) % 89 + 2
                      for i in range(prefix_len)]
            suffix = [(29 + 7 * g + 3 * w + i) % 89 + 2
                      for i in range(suffix_len)]
            workload.append(Request(prompt=prefix + suffix,
                                    max_new_tokens=max_new_tokens))

    out: dict[str, Any] = {
        "serve_router_replicas": n_replicas,
        "serve_router_groups": n_groups,
        "serve_router_waves": waves,
        "n_requests": len(workload),
        "chunk": chunk,
        "n_slots": n_slots,
    }
    outputs: dict[str, list[list[int]]] = {}
    for policy in policies:
        engines = [ServeEngine(params, cfg, n_slots=n_slots,
                               max_len=max_len, chunk=chunk,
                               prefix_cache=True)
                   for _ in range(n_replicas)]
        # Untimed warmup: run every program once with a token family the
        # workload never shares a first chunk with, so the timed hit
        # counters start from a cold radix for the measured prompts.
        for eng in engines:
            warm = eng.run([Request(prompt=[1] * (chunk + 1),
                                    max_new_tokens=2)])
            assert all(r.ok for r in warm)
        router = RouterServer(engines, policy=policy)
        try:
            hits0 = sum(e.prefix_counters["hits"] for e in engines)
            toks: list[list[int]] = []
            t0 = time.perf_counter()
            for w in range(waves):
                wave = workload[w * n_groups:(w + 1) * n_groups]
                rids = [router.route(r) for r in wave]
                toks.extend(list(router.result(rid)) for rid in rids)
            dt = time.perf_counter() - t0
            hits = sum(e.prefix_counters["hits"] for e in engines) - hits0
            n_tokens = sum(len(t) for t in toks)
            outputs[policy] = toks
            out[f"serve_router_hit_rate_{policy}"] = hits / len(workload)
            out[f"serve_router_tokens_per_sec_{policy}"] = n_tokens / dt
        finally:
            router.stop()
    first = next(iter(outputs))
    for policy, toks in outputs.items():
        assert toks == outputs[first], \
            f"routing changed tokens: {first} vs {policy}"
    if "round_robin" in outputs and "prefix_affinity" in outputs:
        out["serve_router_hit_rate_gain"] = (
            out["serve_router_hit_rate_prefix_affinity"]
            - out["serve_router_hit_rate_round_robin"])
    return out
