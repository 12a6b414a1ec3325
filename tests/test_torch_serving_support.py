"""Port parity: the stdlib modules the serving engine carries over.

``metrics``, ``faults``, ``profiler``, ``drafting`` and ``scheduling`` are
copies of the JAX package's (which cannot be imported without jax).  One
parametrised test runs the same call sequence through the reference
module and the port's and holds the logs equal: snapshots, Prometheus
text, event-log records (clock stamps aside), fault schedules and their
exceptions, profiler reports on a scripted clock, drafter proposals and
policy orderings.
"""

from __future__ import annotations

import importlib

import pytest


def _metrics(m, tmp_path, monkeypatch):
    log = []
    reg = m.MetricsRegistry(event_log=m.EventLog(str(tmp_path / "ev.jsonl")))
    reg.counter("serve.steps").inc()
    reg.counter("serve.steps").inc(4)
    reg.gauge("serve.queue_depth").set(3.5)
    h = reg.histogram("serve.ttft_s")
    for v in (0.001, 0.02, 0.3, 0.3, 7.0):
        h.observe(v)
    log += [reg.snapshot(), reg.to_prometheus(), h.percentile(0.5),
            h.count, h.sum]
    reg.event("serve.admit", rid=1, slot=0, step=2)
    reg.active_event_log().close()
    log.append([{k: v for k, v in e.items()
                 if k not in ("ts", "mono_s", "pid")}
                for e in m.EventLog.read(str(tmp_path / "ev.jsonl"))])
    with pytest.raises(Exception) as err:
        reg.gauge("serve.steps")
    log.append(type(err.value).__name__)
    # A fresh null registry: the shared ``NULL`` keeps the names that other
    # code in this process registered on it.
    assert isinstance(m.NULL, m.NullRegistry)
    null = m.NullRegistry()
    null.counter("x").inc()
    log.append(null.snapshot())
    tr = m.Trace(rid=3, enqueue_ts=1.0, enqueue_step=0, admit_ts=1.5,
                 first_token_ts=2.0, terminal_ts=4.0, n_tokens=5)
    log += [tr.to_dict(), m.log_bucket_bounds()[:5],
            m.percentile_from_buckets([1.0, 2.0, 4.0], [1, 2, 1, 0], 3, 0.5,
                                      4.0, 0.5),
            m.escape_label_value('a"b\n'), m.TIMELINE_COUNTER_SERIES,
            m.FAULT_SITES, m.LIFECYCLE_EVENT_COUNTERS, sorted(m.METRIC_HELP)]
    return log


def _faults(m, tmp_path, monkeypatch):
    log = []
    reg = m.FaultRegistry()
    r1 = reg.inject("serve.tick", on_hit=2, count=2)
    r2 = reg.inject("serve.admit", key=7, permanent=True, on_hit=3)
    for site, key in [("serve.tick", 1)] * 4 + [("serve.admit", 7)] * 4 + [
            ("serve.admit", 8)]:
        try:
            reg.check(site, key)
            log.append("pass")
        except m.FaultError as exc:
            log.append((type(exc).__name__, exc.site, exc.key, exc.hit,
                        str(exc)))
    log += [(r1.seen, r1.fired), (r2.seen, r2.fired), list(reg.log),
            reg.hits("serve.admit")]
    for bad in (dict(on_hit=0), dict(count=0)):
        with pytest.raises(ValueError):
            reg.inject("serve.tick", **bad)
    reg.clear()
    log.append((reg.rules, reg.log, reg.hits("serve.tick")))
    m.inject("data.producer", on_hit=1)
    with pytest.raises(m.TransientFault):
        m.check("data.producer", key=0)
    m.clear()
    m.check("data.producer", key=0)
    return log


def _profiler(m, tmp_path, monkeypatch):
    clock = iter(range(1000))
    monkeypatch.setattr(m.time, "perf_counter", lambda: next(clock) * 1e-3)
    metrics = importlib.import_module(m.__name__.rsplit(".", 1)[0]
                                      + ".metrics")
    reg = metrics.MetricsRegistry(event_log=None)
    prof = m.TickProfiler(reg, window=3)
    for step in range(5):
        prof.begin(step)
        prof.mark("expire")
        prof.add("admit.prefill_dispatch", 0.0, 0.002 * step)
        prof.mark("admit")
        if step % 2:
            prof.mark("draft")
        prof.mark("decode_dispatch")
        prof.mark("device_sync")
        prof.mark("sample_postprocess")
        prof.end()
    with pytest.raises(ValueError):
        m.TickProfiler(reg, window=0)
    return [prof.report(), reg.snapshot(), m.PHASES, m.SPEC_PHASES,
            m.SUB_PHASES]


def _drafting(m, tmp_path, monkeypatch):
    log = [m.DEFAULT_DRAFT_K]
    d = m.NgramDraftState([1, 2, 3, 9, 7, 5, 1, 2, 3])
    log += [d.propose(3), d.propose(0)]
    d = m.NgramDraftState([4, 4, 7])
    log.append(d.propose(2))
    d.extend([4, 4, 7])
    log.append(d.propose(2))
    d = m.NgramDraftState([5, 9, 0, 0, 0], max_ngram=2)
    d.extend([0, 0, 0])
    log += [d.propose(4), d.toks]
    for kw in (dict(min_ngram=0), dict(min_ngram=3, max_ngram=2)):
        with pytest.raises(ValueError):
            m.NgramDraftState([1], **kw)
    return log


class _Entry:
    def __init__(self, rid, priority, queued_steps, slo_deadline, seq):
        self.rid, self.queued_steps = rid, queued_steps
        self.slo_deadline, self.admit_seq = slo_deadline, seq
        self.req = type("R", (), {"priority": priority})()


def _scheduling(m, tmp_path, monkeypatch):
    entries = [_Entry(i, p, q, d, (3 * i) % 4) for i, (p, q, d) in
               enumerate([(0, 0, 9.0), (5, 0, None), (0, 70, 3.0),
                          (5, 3, 1.0)])]
    log = []
    for name in ("fifo", "priority", "edf"):
        pol = m.resolve_policy(name)
        log += [type(pol).__name__, pol.name,
                [e.rid for e in pol.admission_order(entries)],
                pol.victim([(i, e) for i, e in enumerate(entries)])]
    knob = "HVD_TORCH_SCHED_POLICY" if "torch" in m.__name__ else \
        "HVD_TPU_SCHED_POLICY"
    monkeypatch.setenv(knob, "edf")
    log.append(type(m.resolve_policy(None)).__name__)
    monkeypatch.setenv(knob, "")
    log.append(type(m.resolve_policy(None)).__name__)
    pol = m.PriorityPolicy(starvation_steps=2)
    log.append([e.rid for e in pol.admission_order(entries)])
    for bad in (lambda: m.resolve_policy("sjf"),
                lambda: m.PriorityPolicy(starvation_steps=0)):
        with pytest.raises(ValueError):
            bad()
    return log


SCRIPTS = {"metrics": _metrics, "faults": _faults, "profiler": _profiler,
           "drafting": _drafting, "scheduling": _scheduling}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_copied_module_matches_reference(name, tmp_path, monkeypatch):
    ref = importlib.import_module(f"horovod_tpu.{name}")
    port = importlib.import_module(f"horovod_tpu_torch.{name}")
    want = SCRIPTS[name](ref, tmp_path / "ref", monkeypatch)
    got = SCRIPTS[name](port, tmp_path / "port", monkeypatch)
    assert got == want
