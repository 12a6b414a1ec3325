"""The JAX ``ServeEngine`` and the port's, driven side by side.

A :class:`Twin` holds one engine of each over the same weights (JAX's,
carried into the port by ``params_from_jax``) and applies every call to
both: submissions, cancellations, fault rules, steps.  After every step
it holds the two to equal finished results, block tables and row
lengths; :meth:`Twin.check` then compares results, statuses, errors,
scheduler events, lifecycle / prefix / spec counters and the program
signature counts.  The port's own oracle, solo ``generate``, is
:func:`solo`.

Both engines run with their measurement planes on: every request traced
(fraction 1.0, one seed), a time-series sampler and the alert rules on
one virtual clock that each step advances by a second, and, with
``device_telemetry=True``, the device plane.  ``check`` holds the two to
equal snapshot key sets, series names, alert states and span forests
(trace ids, span ids, names, parents, attributes; not timestamps); of the
device report it compares the keys, the programs and the window's
dispatch counts, and leaves the measured numbers out.  With ``timeline=True`` each engine writes
a real Chrome timeline (the JAX package's ``Timeline`` and the port's) and
``check`` compares the parsed files, timestamps aside.  The reference's
engine keeps its telemetry plane at ``.device``; the port's at
``.device_telemetry`` (``.device`` is its torch device).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import torch

from horovod_tpu import alerts as jalerts
from horovod_tpu import faults as jfaults
from horovod_tpu import metrics as jmetrics
from horovod_tpu import serving as js
from horovod_tpu import timeline as jtimeline
from horovod_tpu import timeseries as jts
from horovod_tpu import tracing as jtracing
from horovod_tpu.models import llama as jl
from horovod_tpu.serving_scheduler import ServeEngine as JaxEngine
from horovod_tpu_torch import alerts as talerts
from horovod_tpu_torch import faults as tfaults
from horovod_tpu_torch import metrics as tmetrics
from horovod_tpu_torch import serving as ts
from horovod_tpu_torch import timeline as ttimeline
from horovod_tpu_torch import timeseries as tts
from horovod_tpu_torch import tracing as ttracing
from horovod_tpu_torch.models import llama as tl
from horovod_tpu_torch.models.convert import params_from_jax
from horovod_tpu_torch.serving_scheduler import ServeEngine as PortEngine


@dataclasses.dataclass
class World:
    jcfg: jl.LlamaConfig
    jp: dict
    tcfg: tl.LlamaConfig
    tp: dict


def tiny_world(seed: int = 11, zero_head: bool = False) -> World:
    """``llama_tiny`` in f32 from ``PRNGKey(seed)``; ``zero_head`` zeroes
    the lm_head (a constant greedy stream: the drafter's best case)."""
    jcfg = jl.llama_tiny(dtype=jnp.float32)
    tcfg = tl.llama_tiny(dtype=torch.float32)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(seed))
    if zero_head:
        jp = dict(jp, lm_head=jnp.zeros_like(jp["lm_head"]))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    return World(jcfg, jp, tcfg, tp)


def solo(world: World, prompt, n_new: int, max_len: int) -> list[int]:
    """The port's solo greedy ``generate`` of one prompt."""
    return tl.generate(world.tp, torch.tensor([prompt]), world.tcfg,
                       max_new_tokens=n_new, max_len=max_len)[0].tolist()


def assert_solo(world: World, prompt, n_new: int, res, max_len: int,
                eos_id: int | None = None):
    """OK results equal the solo run (cut after its first ``eos_id``);
    others are a prefix of it."""
    want = solo(world, prompt, n_new, max_len)
    if eos_id in want:
        want = want[:want.index(eos_id) + 1]
    got = [int(t) for t in res]
    if res.status == ts.OK:
        assert got == want, (got, want)
    else:
        assert got == want[:len(got)], (got, want)


class Clock:
    """A virtual clock shared by both engines' samplers and alerts."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def parse_timeline(path: str) -> list[dict]:
    """A Chrome timeline's events without their timestamps."""
    with open(path) as f:
        return [{k: v for k, v in e.items() if k != "ts"}
                for e in json.load(f)]


def span_forest(tracer) -> dict:
    """A tracer's closed spans as ``{trace_id: tree}``, each node its span
    id, name, parent, attributes and children (by span id): everything
    but the clock."""
    def node(n):
        return (n["span_id"], n["name"], n["parent_id"],
                tuple(sorted(n["attrs"].items())), n["orphan"],
                tuple(sorted(node(c) for c in n["children"])))

    mod = (ttracing if type(tracer).__module__.startswith(
        "horovod_tpu_torch") else jtracing)
    return {tid: sorted(node(r) for r in roots) for tid, roots in
            mod.build_forest(tracer.recent()).items()}


@contextlib.contextmanager
def _env(values: dict):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


TRACE_SEED = 7


def _result(res) -> tuple:
    err = res.error
    return ([int(t) for t in res], res.status,
            None if err is None else (type(err).__name__,
                                      getattr(err, "site", None),
                                      getattr(err, "key", None),
                                      getattr(err, "hit", None)))


class Twin:
    """One JAX and one port ``ServeEngine`` over the same weights, driven
    by the same calls."""

    def __init__(self, world: World, *, policy=None, timeline=False,
                 device_telemetry=False, **kw):
        """``policy``: a name for both engines, or a (JAX, port) pair of
        policy objects."""
        jpol, tpol = policy if isinstance(policy, tuple) else (policy, policy)
        self.world = world
        self.jfaults = jfaults.FaultRegistry()
        self.tfaults = tfaults.FaultRegistry()
        self.dir = tempfile.mkdtemp(prefix="twin_")
        self.jtimeline = self.ttimeline = None
        if timeline:
            self.jtimeline = jtimeline.Timeline(
                os.path.join(self.dir, "jax.json"))
            self.ttimeline = ttimeline.Timeline(
                os.path.join(self.dir, "port.json"))
        self.clock = Clock()
        jreg = jmetrics.MetricsRegistry(event_log=None)
        treg = tmetrics.MetricsRegistry(event_log=None)
        jsampler = jts.MetricsSampler(jreg, sample_s=1.0, clock=self.clock)
        tsampler = tts.MetricsSampler(treg, sample_s=1.0, clock=self.clock)
        with _env({"HVD_TPU_TRACE_SAMPLE": "1",
                   "HVD_TPU_TRACE_SEED": str(TRACE_SEED),
                   "HVD_TORCH_TRACE_SAMPLE": "1",
                   "HVD_TORCH_TRACE_SEED": str(TRACE_SEED)}):
            self.j = JaxEngine(
                world.jp, world.jcfg, faults=self.jfaults, metrics=jreg,
                monitor=False, sampler=jsampler,
                alerts=jalerts.AlertManager(jsampler, registry=jreg),
                device_telemetry=device_telemetry, policy=jpol,
                timeline=self.jtimeline, **kw)
            self.t = PortEngine(
                world.tp, world.tcfg, faults=self.tfaults, metrics=treg,
                monitor=False, sampler=tsampler,
                alerts=talerts.AlertManager(tsampler, registry=treg),
                device_telemetry=device_telemetry, policy=tpol,
                timeline=self.ttimeline, **kw)
        self.requests: dict[int, dict] = {}

    def submit(self, **req) -> int:
        rid = self.j.submit(js.Request(**req))
        assert self.t.submit(ts.Request(**req)) == rid
        self.requests[rid] = req
        return rid

    def inject(self, site: str, **kw):
        return self.jfaults.inject(site, **kw), self.tfaults.inject(site, **kw)

    def cancel(self, rid: int) -> bool:
        got = self.t.cancel(rid)
        assert self.j.cancel(rid) == got
        return got

    def step(self) -> dict:
        self.clock.t += 1.0
        want, got = self.j.step(), self.t.step()
        assert ({k: _result(v) for k, v in got.items()}
                == {k: _result(v) for k, v in want.items()})
        np.testing.assert_array_equal(
            self.t.pcache.block_table.numpy(),
            np.asarray(self.j.pcache.block_table))
        np.testing.assert_array_equal(self.t.pcache.length.numpy(),
                                      np.asarray(self.j.pcache.length))
        return got

    def pending(self) -> bool:
        assert self.j.pending() == self.t.pending()
        return self.t.pending()

    def drain(self, max_steps: int = 500) -> None:
        for _ in range(max_steps):
            if not self.pending():
                return
            self.step()
        raise AssertionError("the engines did not drain")

    def run(self, reqs: list[dict]) -> list:
        rids = [self.submit(**r) for r in reqs]
        self.drain()
        return [self.t.results[r] for r in rids]

    def check(self, *, max_len: int | None = None) -> None:
        """Both engines agree on everything they report; with
        ``max_len``, every port result also equals (or, non-OK, is a
        prefix of) its solo ``generate``."""
        j, t = self.j, self.t
        assert ({k: _result(v) for k, v in t.results.items()}
                == {k: _result(v) for k, v in j.results.items()})
        assert ([dataclasses.astuple(e) for e in t.events]
                == [dataclasses.astuple(e) for e in j.events])
        assert t.counters == j.counters
        assert t.prefix_counters == j.prefix_counters
        assert t.spec_counters == j.spec_counters
        assert t.compile_cache_sizes() == j.compile_cache_sizes()
        assert t.free_block_count() == j.free_block_count()
        assert t.cached_block_count() == j.cached_block_count()
        assert t.pool.state_lines() == j.pool.state_lines()
        self.check_planes()
        if self.jtimeline is not None:
            self.jtimeline.close()
            self.ttimeline.close()
            assert (parse_timeline(self.ttimeline._path)
                    == parse_timeline(self.jtimeline._path))
        if max_len is not None:
            for rid, res in t.results.items():
                req = self.requests[rid]
                if req["prompt"] and req["max_new_tokens"] > 0:
                    assert_solo(self.world, req["prompt"],
                                req["max_new_tokens"], res, max_len,
                                req.get("eos_id"))

    def check_planes(self) -> None:
        """Equal snapshot key sets, series names, alert states and span
        forests; of the device report, its shape and dispatch counts."""
        j, t = self.j, self.t
        jsnap, tsnap = j.metrics_snapshot(), t.metrics_snapshot()
        assert set(tsnap) == set(jsnap)
        for sec in ("counters", "gauges", "histograms"):
            assert set(tsnap[sec]) == set(jsnap[sec]), sec
        assert tsnap["slo"]["statuses"] == jsnap["slo"]["statuses"]
        for tier in ("raw", "10s", "60s"):
            assert (set(tsnap["timeseries"]["tiers"][tier]["series"])
                    == set(jsnap["timeseries"]["tiers"][tier]["series"]))

        def states(am):
            return {n: (s["state"], s["fired"], s["resolved"], s["no_data"])
                    for n, s in am.states().items()}

        assert states(t.alerts) == states(j.alerts)
        if "device" in jsnap:
            jdev, tdev = jsnap["device"], tsnap["device"]
            assert set(tdev) == set(jdev)
            assert set(tdev["programs"]) == set(jdev["programs"])
            assert set(tdev["win"]) == set(jdev["win"])
            assert tdev["win"]["n"] == jdev["win"]["n"] > 0
            assert (tdev["win"]["dispatches"]
                    == jdev["win"]["dispatches"])
        assert tsnap["advice"]["action"] == jsnap["advice"]["action"]
        assert span_forest(t.tracer) == span_forest(j.tracer)
        assert (tsnap["counters"]["trace.spans"]
                == jsnap["counters"]["trace.spans"] > 0)
