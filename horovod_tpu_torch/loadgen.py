"""Open-loop load harness: production-shaped arrivals, saturation
curves, and end-to-end latency attribution.  Port of
``horovod_tpu/loadgen.py``: the schedules are the reference's bit for bit
(stdlib ``random`` keyed by strings), so a seed's ``schedule_digest`` is
the same in both packages.

Every ``serve_*`` figure before this module is a **closed-loop**
rehearsal: the bench submits a fixed batch and measures
throughput-at-any-latency, the number the Horovod paper's own scaling
tables warn against trusting.  A real front door is **open-loop** —
clients arrive on their own clock and are never back-pressured by
completions, so offered load past the knee makes queues (and tail
latency) grow without bound instead of politely slowing the generator.
This module is that client population, stdlib-only, and fully
seed-deterministic:

* **Arrival processes** (:class:`FixedRate`, :class:`Poisson`,
  :class:`Bursty`) turn an offered rate into a reproducible arrival
  schedule.  ``Bursty`` is a two-state Markov-modulated Poisson
  process — calm/burst states with sticky transitions — because
  production traffic arrives in correlated clumps, and the clumps are
  exactly what closed-loop benches never show.

* **Multi-tenant request mixes** (:class:`TenantSpec`,
  :class:`RequestMix`): per-tenant prompt/output length ranges, a
  seeded shared-prefix corpus (the prefix-cache population the router's
  affinity policy exists for), per-tenant SLOs for goodput accounting,
  and an optional **poison blend** (malformed empty-prompt requests
  that must terminate ``REJECTED`` without hurting their neighbours).
  A chaos blend rides the existing fault registry via
  :func:`arm_chaos`.

* **Open-loop drivers**: :func:`run_open_loop` calls
  ``RouterServer.route()`` at each arrival instant (in-process);
  :func:`run_open_loop_http` POSTs the HTTP front door, one daemon
  thread per arrival.  Pacing comes from a :class:`WallClock` — or a
  :class:`VirtualClock` in tier-1 tests, which collapses the schedule
  to "as fast as possible" with zero sleeps while keeping the arrival
  *order and request sets* bit-identical.

* **Saturation sweep** (:func:`measure_saturation`): step offered RPS
  across a ladder, and for each rung report client-observed p50/p99
  TTFT / TPOT / e2e, shed/timeout rates, SLO goodput, and the
  **goodput knee** (the rung where delivered good work per second
  peaks — everything past it is queueing, not serving).

* **Latency attribution**: each record joins the router-side spans
  (:meth:`RouterServer.request_trace` — receive, admission, route
  decision, journal append, submit) with the engine-side
  :class:`~horovod_tpu_torch.metrics.Trace` by rid.  The phases tile the
  client-observed e2e exactly — ingress, route, replica queue, engine
  queue-wait, prefill, decode, finish, egress — so the report can say
  *where* the p99 millisecond lives at each rung, and
  ``tools/load_report.py --compare`` can gate on it.

Knobs: ``HVD_TORCH_LOAD_SEED`` / ``HVD_TORCH_LOAD_PROCESS`` /
``HVD_TORCH_LOAD_LADDER`` / ``HVD_TORCH_LOAD_DURATION_S`` /
``HVD_TORCH_LOAD_TIMEOUT_S`` (rows in :mod:`~horovod_tpu_torch.knobs`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import random
import threading
import time
from typing import Any, Sequence

from horovod_tpu_torch import tracing as tracing_mod
from horovod_tpu_torch.monitor import env_float
from horovod_tpu_torch.serving import (OK, REJECTED, TIMEOUT, Request)

#: Terminal status for an arrival whose reply never came back within
#: the harness timeout — still in flight somewhere, or dropped on the
#: floor by a dying fleet.  Counted into ``timeout_rate``.
LOST = "LOST"

#: The phases that tile a client-observed e2e latency, in causal
#: order.  ``ingress`` = client send -> router receive; ``route`` =
#: receive -> replica submit (admission + policy + journal append);
#: ``replica_queue`` = submit -> engine enqueue (the replica inbox);
#: ``queue_wait`` = enqueue -> first admission (engine scheduler);
#: ``prefill`` = admission -> first emitted token; ``decode`` = first
#: token -> terminal; ``finish`` = terminal -> router done;
#: ``egress`` = router done -> client receipt (HTTP reply path).
ATTR_PHASES = ("ingress_s", "route_s", "replica_queue_s",
               "queue_wait_s", "prefill_s", "decode_s", "finish_s",
               "egress_s")


# -- clocks ----------------------------------------------------------------


class WallClock:
    """Real-time pacing: ``sleep_until(t)`` sleeps to offset ``t``
    seconds after :meth:`start` (monotonic)."""

    def __init__(self) -> None:
        self._t0: float | None = None

    def start(self) -> None:
        self._t0 = time.monotonic()

    def now(self) -> float:
        if self._t0 is None:
            self.start()
        return time.monotonic() - self._t0

    def sleep_until(self, t: float) -> None:
        if self._t0 is None:
            self.start()
        delay = t - self.now()
        if delay > 0:
            time.sleep(delay)


class VirtualClock:
    """Zero-sleep pacing for tier-1 tests: ``sleep_until`` advances a
    virtual cursor instantly, so a seeded schedule keeps its arrival
    order and request sets but the driver never blocks.  Latency
    figures then measure the fleet at max pressure — which is exactly
    the regime a saturation test wants."""

    def __init__(self) -> None:
        self._t = 0.0

    def start(self) -> None:
        self._t = 0.0

    def now(self) -> float:
        return self._t

    def sleep_until(self, t: float) -> None:
        self._t = max(self._t, t)


# -- arrival processes -----------------------------------------------------


class FixedRate:
    """Deterministic evenly-spaced arrivals at ``rate`` per second —
    the closed-form control every stochastic process is judged
    against."""

    name = "fixed"

    def __init__(self, rate: float, seed: int = 0) -> None:
        if rate <= 0:
            raise ValueError("rate must be > 0")
        self.rate = rate

    def times(self, duration_s: float) -> tuple[float, ...]:
        n = int(math.floor(self.rate * duration_s))
        return tuple(i / self.rate for i in range(n))


class Poisson:
    """Memoryless arrivals: exponential inter-arrival gaps at ``rate``
    per second.  A fresh ``random.Random(seed)`` per :meth:`times`
    call makes the schedule a pure function of ``(rate, seed,
    duration)`` — call it twice, get the same schedule."""

    name = "poisson"

    def __init__(self, rate: float, seed: int = 0) -> None:
        if rate <= 0:
            raise ValueError("rate must be > 0")
        self.rate = rate
        self.seed = seed

    def times(self, duration_s: float) -> tuple[float, ...]:
        rng = random.Random(f"poisson:{self.seed}:{self.rate!r}")
        out: list[float] = []
        t = rng.expovariate(self.rate)
        while t < duration_s:
            out.append(t)
            t += rng.expovariate(self.rate)
        return tuple(out)


class Bursty:
    """Two-state Markov-modulated Poisson: sticky calm/burst states in
    ``dwell_s`` slots, Poisson arrivals within each slot at the state's
    rate.  The burst state runs ``burst``x the calm rate and occupies
    ``frac`` of slots at stationarity, with the calm rate scaled so
    the long-run mean is still ``rate`` — same offered load as
    :class:`Poisson`, clumpier arrivals."""

    name = "bursty"

    def __init__(self, rate: float, seed: int = 0, *,
                 burst: float = 4.0, frac: float = 0.25,
                 dwell_s: float = 0.25, persist: float = 0.5) -> None:
        if rate <= 0:
            raise ValueError("rate must be > 0")
        if not 0.0 < frac < 1.0:
            raise ValueError("frac must be in (0, 1)")
        self.rate = rate
        self.seed = seed
        self.burst = burst
        self.frac = frac
        self.dwell_s = dwell_s
        self.persist = persist

    def times(self, duration_s: float) -> tuple[float, ...]:
        rng = random.Random(f"bursty:{self.seed}:{self.rate!r}")
        lo = self.rate / ((1.0 - self.frac) + self.frac * self.burst)
        hi = lo * self.burst
        # Sticky chain with the requested stationary burst fraction:
        # P(stay burst) = persist, P(enter burst | calm) solves
        # frac = enter / (enter + 1 - persist).
        enter = self.frac * (1.0 - self.persist) / (1.0 - self.frac)
        in_burst = rng.random() < self.frac
        out: list[float] = []
        t0 = 0.0
        while t0 < duration_s:
            slot_end = min(t0 + self.dwell_s, duration_s)
            r = hi if in_burst else lo
            t = t0 + rng.expovariate(r)
            while t < slot_end:
                out.append(t)
                t += rng.expovariate(r)
            in_burst = (rng.random() < self.persist if in_burst
                        else rng.random() < enter)
            t0 += self.dwell_s
        return tuple(out)


PROCESSES: dict[str, type] = {p.name: p
                              for p in (FixedRate, Poisson, Bursty)}


def resolve_process(spec: "str | Any", rate: float, seed: int = 0):
    """``"poisson" | "bursty" | "fixed"`` (or an instance passthrough)
    to an arrival process at ``rate``."""
    if not isinstance(spec, str):
        return spec
    try:
        return PROCESSES[spec](rate, seed)
    except KeyError:
        raise ValueError(
            f"unknown arrival process {spec!r}; "
            f"one of {sorted(PROCESSES)}") from None


# -- tenants + request mixes -----------------------------------------------


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's traffic shape: arrival weight, prompt/output token
    ranges, a shared-prefix population (``shared_prefixes`` distinct
    ``prefix_len``-token system prompts drawn from the seeded corpus),
    an SLO for goodput accounting, and a poison fraction (malformed
    empty-prompt requests the fleet must shrug off as ``REJECTED``)."""

    name: str
    weight: float = 1.0
    prompt_len: tuple[int, int] = (8, 24)
    new_tokens: tuple[int, int] = (4, 12)
    shared_prefixes: int = 0
    prefix_len: int = 16
    slo_s: float | None = None
    deadline_s: float | None = None
    poison: float = 0.0


#: The default two-tenant production shape: latency-sensitive
#: interactive traffic with a shared-prefix population (chatbot system
#: prompts) and a tight SLO, plus heavier batch traffic with a loose
#: one.  Token ids stay in [2, 90] — inside the tiny rehearsal vocab,
#: clear of 0/1 (pad / the disjoint warmup family).
DEFAULT_TENANTS: tuple[TenantSpec, ...] = (
    TenantSpec("interactive", weight=3.0, prompt_len=(4, 12),
               new_tokens=(4, 8), shared_prefixes=4, prefix_len=16,
               slo_s=2.0),
    TenantSpec("batch", weight=1.0, prompt_len=(16, 40),
               new_tokens=(8, 16), slo_s=10.0),
)


class RequestMix:
    """Seeded multi-tenant request sampler.  The shared-prefix corpus
    is built once per mix (a pure function of ``(seed, tenant)``), so
    every rung of a sweep draws suffixes against the same prefix
    population — the steady prompt families a prefix cache feeds on."""

    def __init__(self, tenants: Sequence[TenantSpec] = DEFAULT_TENANTS,
                 seed: int = 0, *, vocab_lo: int = 2,
                 vocab_hi: int = 90) -> None:
        if not tenants:
            raise ValueError("need at least one tenant")
        self.tenants = tuple(tenants)
        self.seed = seed
        self.vocab_lo = vocab_lo
        self.vocab_hi = vocab_hi
        self._weights = [t.weight for t in self.tenants]
        self._corpus: dict[str, list[list[int]]] = {}
        for t in self.tenants:
            rng = random.Random(f"corpus:{seed}:{t.name}")
            self._corpus[t.name] = [
                [rng.randint(vocab_lo, vocab_hi)
                 for _ in range(t.prefix_len)]
                for _ in range(t.shared_prefixes)]

    def sample(self, rng: random.Random) -> tuple[Request, TenantSpec,
                                                  bool]:
        """One ``(request, tenant, poison)`` draw from ``rng``."""
        tenant = rng.choices(self.tenants, weights=self._weights)[0]
        if tenant.poison > 0 and rng.random() < tenant.poison:
            # Malformed on purpose: the engine must answer REJECTED
            # without collateral damage.
            return (Request(prompt=[],
                            max_new_tokens=max(tenant.new_tokens[0], 1)),
                    tenant, True)
        n_prompt = rng.randint(*tenant.prompt_len)
        prompt: list[int] = []
        prefixes = self._corpus[tenant.name]
        if prefixes:
            prompt.extend(rng.choice(prefixes))
        prompt.extend(rng.randint(self.vocab_lo, self.vocab_hi)
                      for _ in range(n_prompt))
        req = Request(prompt=prompt,
                      max_new_tokens=rng.randint(*tenant.new_tokens),
                      slo_s=tenant.slo_s,
                      deadline_s=tenant.deadline_s)
        return req, tenant, False


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One scheduled arrival: when (offset seconds from epoch start),
    what (the full request), and who (tenant name, poison flag)."""

    t: float
    req: Request
    tenant: str
    poison: bool


def build_schedule(process: Any, mix: RequestMix, duration_s: float,
                   seed: int = 0) -> tuple[Arrival, ...]:
    """The full offered workload for one rung, bit-reproducible: the
    process fixes *when*, the mix (driven by a ``Random(seed)``
    derived here) fixes *what*.  Same ``(process, mix, duration,
    seed)`` -> identical schedule, always."""
    rng = random.Random(f"schedule:{seed}")
    out = []
    for t in process.times(duration_s):
        req, tenant, poison = mix.sample(rng)
        out.append(Arrival(t, req, tenant.name, poison))
    return tuple(out)


def schedule_digest(schedule: Sequence[Arrival]) -> str:
    """Stable hex digest of a schedule's arrival times and request
    sets — the bit-reproducibility witness the sweep report carries."""
    h = hashlib.blake2b(digest_size=16)
    for a in schedule:
        h.update(repr((a.t, a.tenant, a.poison, a.req.prompt,
                       a.req.max_new_tokens, a.req.slo_s,
                       a.req.deadline_s)).encode())
    return h.hexdigest()


def arm_chaos(faults: Any, seed: int, n_faults: int,
              replica_names: Sequence[str]) -> list:
    """Blend a seeded fault storm into a load run via the existing
    registry: transient engine-site rules from the chaos module's
    schedule generator (coverage-first, then random spread).  Returns
    the armed rules."""
    from horovod_tpu_torch.chaos import ChaosSchedule
    sched = ChaosSchedule.generate(seed, replica_names=replica_names,
                                   n_faults=n_faults, n_kills=0)
    return [rule.arm(faults) for rule in sched.rules]


# -- open-loop drivers -----------------------------------------------------


def run_open_loop(router: Any, schedule: Sequence[Arrival], *,
                  clock: Any = None,
                  timeout_s: float | None = None) -> list[dict]:
    """Drive a :class:`~horovod_tpu_torch.router.RouterServer` in-process:
    ``route()`` fires at each arrival instant regardless of how many
    earlier requests are still in flight (open loop — completions
    never pace arrivals), then one collection pass joins results and
    merged traces.  Returns one record dict per arrival."""
    if timeout_s is None:
        timeout_s = env_float("HVD_TORCH_LOAD_TIMEOUT_S", 60.0)
    clock = clock if clock is not None else WallClock()
    clock.start()
    frac = tracing_mod.env_sample_fraction()
    tseed = tracing_mod.env_trace_seed()
    fired: list[tuple[Arrival, int, float, Any]] = []
    for idx, a in enumerate(schedule):
        clock.sleep_until(a.t)
        ctx = None
        if frac > 0.0:
            # Client-origin trace root: the sampling key is a pure
            # function of the (seeded, deterministic) schedule, so the
            # sampled set replays bit-identically.
            ctx = tracing_mod.TraceContext.root(
                f"client:{idx}:{a.t!r}:{a.tenant}", "client",
                frac, tseed)
            a.req.trace_ctx = ctx
        send_ts = time.monotonic()
        rid = router.route(a.req)
        fired.append((a, rid, send_ts, ctx))
    records: list[dict] = []
    deadline = time.monotonic() + timeout_s
    for a, rid, send_ts, ctx in fired:
        remaining = max(deadline - time.monotonic(), 0.001)
        try:
            res = router.result(rid, timeout=remaining)
            trace = router.request_trace(rid) if res is not None else None
        except KeyError:            # reaped mid-collection
            res, trace = None, None
        if res is None:
            if ctx is not None:
                router.tracer.span(ctx, "client", send_ts,
                                   time.monotonic(), tenant=a.tenant,
                                   status=LOST)
            records.append(_record(
                a, rid, send_ts, None, LOST, 0, None,
                trace_id=ctx.trace_id if ctx is not None else None))
            continue
        router_done = (trace or {}).get("router", {}).get("done_ts")
        done_ts = router_done if router_done else time.monotonic()
        if ctx is not None:
            router.tracer.span(ctx, "client", send_ts, done_ts,
                               tenant=a.tenant, status=res.status)
        tid = (ctx.trace_id if ctx is not None else
               ((trace or {}).get("router") or {}).get("trace_id"))
        records.append(_record(a, rid, send_ts, done_ts,
                               res.status, len(res), trace,
                               trace_id=tid))
    return records


def run_open_loop_http(base_url: str, schedule: Sequence[Arrival], *,
                       clock: Any = None,
                       timeout_s: float | None = None,
                       tracer: Any = None) -> list[dict]:
    """Drive the HTTP front door open-loop: one daemon thread per
    arrival POSTs ``/v1/generate`` at its scheduled instant, client
    send/receive stamps wrap the wire.  Reply traces (the satellite-1
    ``trace`` dict) give the same attribution join as in-process —
    exact when router and client share a monotonic clock domain (the
    in-process-server rehearsal), durations-only when truly remote.
    Sampled arrivals carry their trace context on the ``traceparent``
    request header; pass ``tracer`` (e.g. ``router.tracer`` when the
    server is in-process) to also emit the client span itself."""
    from horovod_tpu_torch.router import request_to_json
    if timeout_s is None:
        timeout_s = env_float("HVD_TORCH_LOAD_TIMEOUT_S", 60.0)
    clock = clock if clock is not None else WallClock()
    clock.start()
    frac = tracing_mod.env_sample_fraction()
    tseed = tracing_mod.env_trace_seed()
    url = base_url.rstrip("/") + "/v1/generate"
    slots: list = [None] * len(schedule)
    ctxs: list = [None] * len(schedule)
    threads: list[threading.Thread] = []

    def _fire(idx: int, a: Arrival) -> None:
        import urllib.error
        import urllib.request
        headers = {"Content-Type": "application/json"}
        if ctxs[idx] is not None:
            headers["traceparent"] = ctxs[idx].to_header()
        send_ts = time.monotonic()
        try:
            http_req = urllib.request.Request(
                url, data=json.dumps(request_to_json(a.req)).encode(),
                headers=headers)
            try:
                with urllib.request.urlopen(
                        http_req, timeout=timeout_s) as resp:
                    body = json.loads(resp.read().decode())
            except urllib.error.HTTPError as e:
                # 429 shed replies carry the same JSON body shape.
                body = json.loads(e.read().decode())
            slots[idx] = (send_ts, time.monotonic(), body)
        except Exception:
            slots[idx] = (send_ts, time.monotonic(), None)

    for idx, a in enumerate(schedule):
        clock.sleep_until(a.t)
        if frac > 0.0:
            ctxs[idx] = tracing_mod.TraceContext.root(
                f"client:{idx}:{a.t!r}:{a.tenant}", "client",
                frac, tseed)
        th = threading.Thread(target=_fire, args=(idx, a), daemon=True,
                              name=f"hvd-loadgen-{idx}")
        th.start()
        threads.append(th)
    deadline = time.monotonic() + timeout_s
    for th in threads:
        th.join(timeout=max(deadline - time.monotonic(), 0.001))
    records: list[dict] = []
    for idx, a in enumerate(schedule):
        got = slots[idx]
        ctx = ctxs[idx]
        if got is None or got[2] is None:
            send_ts = got[0] if got else time.monotonic()
            if ctx is not None and tracer is not None:
                tracer.span(ctx, "client", send_ts, time.monotonic(),
                            tenant=a.tenant, status=LOST)
            records.append(_record(
                a, -1, send_ts, None, LOST, 0, None,
                trace_id=ctx.trace_id if ctx is not None else None))
            continue
        send_ts, done_ts, body = got
        if ctx is not None and tracer is not None:
            tracer.span(ctx, "client", send_ts, done_ts,
                        tenant=a.tenant,
                        status=body.get("status", LOST))
        tid = (ctx.trace_id if ctx is not None else
               ((body.get("trace") or {}).get("router") or {})
               .get("trace_id"))
        records.append(_record(a, body.get("rid", -1), send_ts, done_ts,
                               body.get("status", LOST),
                               len(body.get("tokens") or []),
                               body.get("trace"), trace_id=tid))
    return records


def _record(a: Arrival, rid: int, send_ts: float,
            client_done_ts: float | None, status: str, n_tokens: int,
            trace: dict | None, *, trace_id: str | None = None) -> dict:
    """One arrival's outcome: client-observed latencies plus the
    per-phase attribution split (:data:`ATTR_PHASES`) and, when the
    arrival was head-sampled, its causal ``trace_id`` (the join key
    into ``python -m horovod_tpu_torch.tools.trace_report``)."""
    rec: dict[str, Any] = {
        "rid": rid, "tenant": a.tenant, "poison": a.poison,
        "sched_t": a.t, "status": status, "n_tokens": n_tokens,
        "slo_s": a.req.slo_s, "trace_id": trace_id,
        "e2e_s": None, "ttft_s": None, "tpot_s": None,
        "good": False, "attr": None,
    }
    if client_done_ts is not None:
        rec["e2e_s"] = max(client_done_ts - send_ts, 0.0)
    if trace:
        ft = trace.get("first_token_ts")
        if ft is not None:
            rec["ttft_s"] = max(ft - send_ts, 0.0)
        rec["tpot_s"] = trace.get("tpot_s")
        rec["attr"] = _attr(trace, send_ts, client_done_ts)
    rec["good"] = (status == OK
                   and (a.req.slo_s is None or rec["e2e_s"] is None
                        or rec["e2e_s"] <= a.req.slo_s))
    return rec


def _attr(trace: dict, send_ts: float,
          client_done_ts: float | None) -> dict:
    """Split one merged trace into the :data:`ATTR_PHASES` tiling.
    Every phase is a difference of adjacent stamps (clamped at 0), so
    present phases sum to the client e2e exactly — attribution
    coverage measures how much of the path had stamps, not how well
    the arithmetic balanced."""
    router = trace.get("router") or {}
    recv = router.get("recv_ts")
    submit = router.get("submit_ts")
    done = router.get("done_ts")
    enq = trace.get("enqueue_ts")
    admit = trace.get("admit_ts")
    ft = trace.get("first_token_ts")
    term = trace.get("terminal_ts")

    def span(a: float | None, b: float | None) -> float | None:
        if a is None or b is None:
            return None
        return max(b - a, 0.0)

    return {
        "ingress_s": span(send_ts, recv),
        "route_s": span(recv, submit),
        "replica_queue_s": router.get("replica_queue_s",
                                      span(submit, enq)),
        "queue_wait_s": trace.get("queue_wait_s", span(enq, admit)),
        "prefill_s": span(admit, ft),
        "decode_s": span(ft, term),
        "finish_s": router.get("finish_s", span(term, done)),
        "egress_s": span(done, client_done_ts),
    }


# -- rung summaries + the sweep --------------------------------------------


def percentile(values: Sequence[float], q: float) -> float:
    """Exact sample percentile with linear interpolation (0 on empty —
    the :func:`~horovod_tpu_torch.metrics.percentile_from_buckets` empty
    stance)."""
    if not values:
        return 0.0
    vs = sorted(values)
    if len(vs) == 1:
        return vs[0]
    rank = min(max(q, 0.0), 1.0) * (len(vs) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(vs) - 1)
    return vs[lo] + (vs[hi] - vs[lo]) * (rank - lo)


def attribute(records: Sequence[dict]) -> dict:
    """Mean per-phase latency split over the OK records, plus
    ``coverage`` — the fraction of mean e2e the named phases explain.
    The acceptance bar is coverage >= 0.95 at the knee: if a phase of
    the path loses its stamps, this number says so."""
    ok = [r for r in records
          if r["status"] == OK and r["attr"] and r["e2e_s"]]
    if not ok:
        return {"n": 0, "coverage": 0.0, "mean_e2e_s": 0.0,
                "phases": {p: 0.0 for p in ATTR_PHASES}}
    phases = {p: sum(r["attr"][p] or 0.0 for r in ok) / len(ok)
              for p in ATTR_PHASES}
    mean_e2e = sum(r["e2e_s"] for r in ok) / len(ok)
    return {"n": len(ok), "mean_e2e_s": mean_e2e, "phases": phases,
            "coverage": (sum(phases.values()) / mean_e2e
                         if mean_e2e > 0 else 0.0)}


def summarize_rung(records: Sequence[dict], *, offered_rps: float,
                   duration_s: float) -> dict:
    """One saturation-curve point: status mix, shed/timeout rates,
    client percentiles, SLO goodput, and the per-phase attribution."""
    n = max(len(records), 1)
    statuses: dict[str, int] = {}
    for r in records:
        statuses[r["status"]] = statuses.get(r["status"], 0) + 1
    good = [r for r in records if r["good"]]
    e2es = [r["e2e_s"] for r in records if r["e2e_s"] is not None]
    ttfts = [r["ttft_s"] for r in records if r["ttft_s"] is not None]
    tpots = [r["tpot_s"] for r in records if r["tpot_s"] is not None]
    span_s = max(max((r["sched_t"] for r in records), default=0.0)
                 + (max(e2es) if e2es else 0.0), duration_s, 1e-9)
    # Exemplars: the slowest sampled requests of the rung — trace ids
    # a reader can feed straight to the trace_report tool to see
    # WHERE the rung's tail latency lives.
    tailed = sorted((r for r in records
                     if r.get("trace_id") and r["e2e_s"] is not None),
                    key=lambda r: r["e2e_s"], reverse=True)
    return {
        "offered_rps": offered_rps,
        "duration_s": duration_s,
        "n": len(records),
        "statuses": statuses,
        "ok_rate": statuses.get(OK, 0) / n,
        "shed_rate": statuses.get(REJECTED, 0) / n,
        "timeout_rate": (statuses.get(TIMEOUT, 0)
                         + statuses.get(LOST, 0)) / n,
        "p50_ttft_s": percentile(ttfts, 0.50),
        "p99_ttft_s": percentile(ttfts, 0.99),
        "p50_tpot_s": percentile(tpots, 0.50),
        "p99_tpot_s": percentile(tpots, 0.99),
        "p50_e2e_s": percentile(e2es, 0.50),
        "p99_e2e_s": percentile(e2es, 0.99),
        "goodput": len(good) / n,
        "goodput_rps": len(good) / span_s,
        "tokens": sum(r["n_tokens"] for r in records),
        "attribution": attribute(records),
        "exemplar_trace_ids": [r["trace_id"] for r in tailed[:3]],
    }


def _load_seed() -> int:
    try:
        return int(os.environ.get("HVD_TORCH_LOAD_SEED", "0") or 0)
    except ValueError:
        return 0


def _load_ladder() -> "tuple[float, ...] | None":
    raw = os.environ.get("HVD_TORCH_LOAD_LADDER", "")
    if not raw:
        return None
    return tuple(float(x) for x in raw.split(",") if x.strip())


def measure_saturation(
        params: Any = None, cfg: Any = None, *,
        engines: Sequence[Any] | None = None,
        ladder: Sequence[float] | None = None,
        seed: int | None = None,
        process: str | None = None,
        duration_s: float | None = None,
        timeout_s: float | None = None,
        tenants: Sequence[TenantSpec] | None = None,
        n_replicas: int = 2, n_slots: int = 4, chunk: int = 16,
        max_len: int | None = None, policy: Any = None,
        registry: Any = None, chaos_faults: int = 0,
        http: bool = False, clock: Any = None,
        keep_records: bool = False) -> dict:
    """The saturation sweep: step offered load across ``ladder`` rungs
    of ``duration_s`` of seeded open-loop arrivals each, against a
    fresh ``n_replicas`` fleet behind a
    :class:`~horovod_tpu_torch.router.RouterServer`, and report the curve —
    percentiles and goodput per rung, the **goodput knee** (first rung
    of peak delivered-good-work per second), p99-TTFT monotonicity,
    and the per-phase latency attribution at the knee.

    Bit-reproducible by construction: rung ``i``'s schedule is a pure
    function of ``(seed, i, rate, duration)`` and the shared-prefix
    corpus is a pure function of ``(seed, tenants)`` — the per-rung
    ``schedule_digest`` in the report is the witness.  Pass ``engines``
    to sweep an existing fleet (tests), or ``params``/``cfg`` to build
    one.  ``http=True`` drives the started HTTP front door instead of
    in-process ``route()``.  Flat ``serve_load_*`` keys are the bench
    arm's contract; the full ``rungs`` list is what
    ``tools/load_report.py`` renders and gates on."""
    from horovod_tpu_torch import faults as faults_mod
    from horovod_tpu_torch.metrics import MetricsRegistry
    from horovod_tpu_torch.router import RouterServer

    seed = _load_seed() if seed is None else seed
    if process is None:
        process = os.environ.get("HVD_TORCH_LOAD_PROCESS", "") or "poisson"
    if ladder is None:
        ladder = _load_ladder() or (4.0, 16.0, 64.0, 256.0)
    if duration_s is None:
        duration_s = env_float("HVD_TORCH_LOAD_DURATION_S", 1.0)
    if timeout_s is None:
        timeout_s = env_float("HVD_TORCH_LOAD_TIMEOUT_S", 60.0)
    mix = RequestMix(tenants if tenants is not None else DEFAULT_TENANTS,
                     seed)
    reg = registry if registry is not None else MetricsRegistry()
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
                               faults=fr)
                   for _ in range(n_replicas)]
    # Untimed warmup on the disjoint [1]*k family: every rung pays
    # zero compile time, and the measured radix stays cold for the
    # workload's own prefixes.
    for eng in engines:
        eng.run([Request(prompt=[1] * (eng.chunk + 1),
                         max_new_tokens=2)])
    router = RouterServer(engines, policy=policy, registry=reg,
                          faults=fr)
    if chaos_faults:
        arm_chaos(fr, seed, chaos_faults,
                  [r.name for r in router.replicas])
    if http:
        router.start()
    rungs: list[dict] = []
    all_records: list[list[dict]] = []
    try:
        for i, rate in enumerate(ladder):
            rung_seed = seed * 8191 + 1000003 * (i + 1)
            sched = build_schedule(
                resolve_process(process, rate, rung_seed), mix,
                duration_s, rung_seed)
            if http:
                records = run_open_loop_http(
                    f"http://{router.host}:{router.port}", sched,
                    clock=clock, timeout_s=timeout_s)
            else:
                records = run_open_loop(router, sched, clock=clock,
                                        timeout_s=timeout_s)
            rung = summarize_rung(records, offered_rps=rate,
                                  duration_s=duration_s)
            rung["schedule_digest"] = schedule_digest(sched)
            rungs.append(rung)
            all_records.append(records)
    finally:
        router.stop()
    knee_i = max(range(len(rungs)),
                 key=lambda i: rungs[i]["goodput_rps"])
    knee = rungs[knee_i]
    # Monotone up to measurement jitter: a 1 ms / 5 % slack keeps two
    # equally-underloaded rungs from failing the flag on noise, and a
    # rung that drew < 2 arrivals has no percentile to rank.
    p99s = [r["p99_ttft_s"] for r in rungs if r["n"] >= 2]
    monotone = all(b >= a - max(0.001, 0.05 * a)
                   for a, b in zip(p99s, p99s[1:]))
    report: dict[str, Any] = {
        "serve_load_seed": seed,
        "serve_load_process": process,
        "serve_load_duration_s": duration_s,
        "serve_load_rungs": len(rungs),
        "serve_load_requests": sum(r["n"] for r in rungs),
        "serve_load_replicas": len(router.replicas),
        "serve_load_knee_rps": knee["offered_rps"],
        "serve_load_knee_goodput_rps": knee["goodput_rps"],
        "serve_load_p99_ttft_knee_ms": knee["p99_ttft_s"] * 1e3,
        "serve_load_p99_tpot_knee_ms": knee["p99_tpot_s"] * 1e3,
        "serve_load_attr_coverage_knee":
            knee["attribution"]["coverage"],
        "serve_load_p99_ttft_monotone": int(monotone),
        "serve_load_shed_rate_top": rungs[-1]["shed_rate"],
        "serve_load_timeout_rate_top": rungs[-1]["timeout_rate"],
        "ladder": list(ladder),
        "knee_index": knee_i,
        "knee_exemplar_trace_ids": knee["exemplar_trace_ids"],
        "rungs": rungs,
    }
    if keep_records:
        report["records"] = all_records
    return report
