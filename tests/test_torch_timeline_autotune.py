"""The port's HandleManager, Autotuner and Timeline against the JAX
package's.

``HandleManager`` and ``Autotuner`` are copies: both implementations run
the cases of ``tests/test_handle_manager.py`` and ``tests/test_autotune.py``,
and the same script of operations (for the tuner: one fake clock and one
score surface) must give the same outcomes, the same moves and the same
log rows.  The timeline of one op sequence through the port's engine
(a world of one on the CPU) must carry, for each tensor, the JAX
engine's event names and phases (not their timestamps), with and without
the native controller, and be valid Chrome JSON.
"""

from __future__ import annotations

import json
import os
import threading
import uuid

import numpy as np
import pytest
import torch

import horovod_tpu.autotune as jax_autotune
import horovod_tpu_torch.autotune as port_autotune
from horovod_tpu.ops.handle_manager import HandleManager as JaxHM
from horovod_tpu.utils.env import EngineConfig as JaxConfig
from horovod_tpu_torch.ops.handle_manager import HandleManager as PortHM
from horovod_tpu_torch.utils.env import EngineConfig as PortConfig

HMS = pytest.mark.parametrize("HM", [JaxHM, PortHM], ids=["jax", "port"])
TUNERS = pytest.mark.parametrize("impl", ["jax", "port"])


# ------------------------------------------------------------ HandleManager


@HMS
def test_lifecycle_and_post_payload(HM):
    hm = HM()
    h = hm.allocate("t")
    assert hm.name(h) == "t"
    hm.set_post(h, {"ragged": (3, (1, 2))})
    assert hm.take_post(h) == {"ragged": (3, (1, 2))}
    assert hm.take_post(h) is None
    hm.mark_dispatched(h, 42)
    assert hm.poll(h)
    assert hm.wait(h, flush=lambda: None) == 42
    with pytest.raises(ValueError):
        hm.poll(h)


@HMS
def test_released_handle_is_tolerated(HM):
    hm = HM()
    h = hm.allocate("gone")
    hm.release(h)
    hm.mark_dispatched(h, 1)
    hm.mark_error(h, RuntimeError("late"))
    hm.set_post(h, {"x": 1})
    hm.update_post(h, {"y": 2})
    assert hm.take_post(h) is None
    assert hm.outstanding() == 0


@HMS
def test_wait_raises_captured_error_and_releases(HM):
    hm = HM()
    h = hm.allocate()
    hm.mark_error(h, RuntimeError("boom"))
    assert hm.poll(h)
    with pytest.raises(RuntimeError, match="boom"):
        hm.wait(h, flush=lambda: None)
    assert hm.outstanding() == 0


@HMS
def test_wait_blocks_until_marked_from_another_thread(HM):
    hm = HM()
    h = hm.allocate()
    t = threading.Timer(0.05, lambda: hm.mark_dispatched(h, "late-ok"))
    t.start()
    try:
        assert hm.wait(h, flush=lambda: None) == "late-ok"
    finally:
        t.cancel()


def _hm_script(HM) -> list:
    """One script of operations; everything observable, in order."""
    hm, log = HM(), []
    hs = [hm.allocate(f"t{i}") for i in range(5)]
    log.append(hs)
    hm.update_post(hs[0], {"a": 1})
    hm.update_post(hs[0], {"b": 2})
    log.append(hm.take_post(hs[0]))
    log.append([hm.poll(h) for h in hs])
    hm.mark_dispatched(hs[1], "one")
    hm.mark_error(hs[2], KeyError("two"))
    hm.release(hs[3])
    hm.mark_dispatched(hs[3], "released")
    log.append([hm.poll(h) for h in (hs[0], hs[1], hs[2])])
    log.append(hm.outstanding())
    log.append(hm.wait(hs[1], flush=lambda: log.append("flushed")))
    try:
        hm.wait(hs[2], flush=lambda: None)
    except KeyError as e:
        log.append(("raised", str(e)))
    log.append([hm.name(h) for h in hs])
    log.append(hm.outstanding())
    return log


def test_handle_manager_scripts_agree():
    assert _hm_script(PortHM) == _hm_script(JaxHM)


def test_port_poll_and_wait_use_the_dispatched_result():
    class Result:
        def __init__(self):
            self.done = False

        def is_ready(self):
            return self.done

        def value(self):
            return "value"

    hm, r = PortHM(), Result()
    h = hm.allocate()
    hm.mark_dispatched(h, r)
    assert not hm.poll(h)
    r.done = True
    assert hm.poll(h)
    assert hm.wait(h, flush=lambda: None) == "value"


# ----------------------------------------------------------------- Autotuner


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _tuner(impl, monkeypatch, cfg_kwargs, **kwargs):
    mod = jax_autotune if impl == "jax" else port_autotune
    clock = _Clock()
    monkeypatch.setattr(mod.time, "monotonic", clock)
    cfg = (JaxConfig if impl == "jax" else PortConfig)(**cfg_kwargs)
    moves = []
    tuner = mod.Autotuner(cfg, on_move=lambda *m: moves.append(m), **kwargs)
    return tuner, cfg, clock, moves


def _drive(tuner, clock, surface, max_windows=200):
    """Feed windows until convergence; ``surface(threshold, cycle)`` is
    the bytes/s of a setting."""
    for _ in range(max_windows):
        if tuner.done:
            return
        rate = surface(tuner.config.fusion_threshold_bytes,
                       tuner.config.cycle_time_ms)
        per_flush = max(tuner.min_window_bytes // tuner.window_flushes + 1, 1)
        for _ in range(tuner.window_flushes):
            tuner.observe(per_flush, None)
            if tuner._win_t0 is not None:
                clock.t += per_flush / rate
    raise AssertionError("autotuner did not converge")


MiB = 1024 * 1024


def _bumpy(thr, cyc):
    """A surface with a local optimum away from the global one."""
    peak = {0: 1.0, MiB: 2.0, 4 * MiB: 1.5, 16 * MiB: 3.0, 64 * MiB: 2.5,
            256 * MiB: 0.5}[thr]
    return 1e6 * peak / (1 + abs(cyc - 10.0))


@TUNERS
def test_climbs_to_best_threshold(impl, monkeypatch):
    best_t = jax_autotune.THRESHOLD_GRID[3]
    tuner, cfg, clock, _ = _tuner(
        impl, monkeypatch, {"fusion_threshold_bytes": 0,
                            "cycle_time_ms": 5.0},
        warmup_samples=0, window_flushes=4, min_window_bytes=1024)
    _drive(tuner, clock, lambda thr, cyc: 1e6 / (1 + abs(thr - best_t) / MiB)
           / (1 + abs(cyc - 5.0)))
    assert (cfg.fusion_threshold_bytes, cfg.cycle_time_ms) == (best_t, 5.0)


@TUNERS
def test_warmup_discards_samples(impl, monkeypatch):
    tuner, _, _, _ = _tuner(impl, monkeypatch, {}, warmup_samples=5,
                            window_flushes=2, min_window_bytes=1)
    for _ in range(5):
        tuner.observe(1 << 20, None)
    assert tuner._win_flushes == 0 and not tuner._scores


@pytest.mark.parametrize("start", [(0, 1.0), (64 * MiB, 5.0),
                                   (256 * MiB, 25.0)])
def test_tuners_move_and_log_identically(monkeypatch, tmp_path, start):
    runs = {}
    for impl in ("jax", "port"):
        log = tmp_path / f"{impl}.csv"
        tuner, cfg, clock, moves = _tuner(
            impl, monkeypatch, {"fusion_threshold_bytes": start[0],
                                "cycle_time_ms": start[1]},
            warmup_samples=1, window_flushes=3, min_window_bytes=1024,
            log_path=str(log))
        _drive(tuner, clock, _bumpy)
        runs[impl] = (moves, log.read_text(),
                      (cfg.fusion_threshold_bytes, cfg.cycle_time_ms))
    assert runs["port"] == runs["jax"]
    moves, rows, final = runs["port"]
    assert len(moves) > 2 and rows.splitlines()[-1].endswith(",1")
    assert rows.splitlines()[0] == (
        "threshold_bytes,cycle_time_ms,score_bytes_per_sec,best")


def test_port_window_waits_on_the_probe(monkeypatch):
    tuner, _, _, _ = _tuner("port", monkeypatch, {}, warmup_samples=0,
                            window_flushes=2, min_window_bytes=1)

    class Probe:
        waited = 0

        def synchronize(self):
            Probe.waited += 1

    tuner.observe(10, Probe())
    tuner.observe(10, Probe())
    assert Probe.waited == 1 and len(tuner._scores) == 1


# ------------------------------------------------------------------ Timeline


def _events(path):
    with open(path) as f:
        events = json.load(f)          # strict JSON, or this raises
    pids = {e["pid"]: e["args"]["name"] for e in events
            if e.get("name") == "process_name"}
    by_tensor: dict[str, list] = {}
    for e in events:
        if e["ph"] == "M" or e["pid"] not in pids:
            continue
        by_tensor.setdefault(pids[e["pid"]], []).append((e["name"], e["ph"]))
    return by_tensor, events


def _jax_timeline(path, controller):
    import jax.numpy as jnp

    import horovod_tpu as hvd

    keys = ("HOROVOD_TPU_NATIVE_CONTROLLER",
            "HOROVOD_TPU_CONTROLLER_TRANSPORT")
    if controller:
        os.environ.update(dict(zip(keys, (
            "on", f"local:{uuid.uuid4().hex}"))))
        hvd.shutdown()
        hvd.init()
    try:
        hvd.start_timeline(path)
        n = hvd.size()
        x = hvd.per_rank(lambda r: jnp.full((4, 3), float(r)))
        ha = hvd.allreduce_async(x, name="tl.a", average=True)
        hb = hvd.allreduce_async(x, name="tl.b", op=hvd.Max)
        hc = hvd.allgather_async([np.ones((2, 3), np.float32)] * n,
                                 name="tl.c")
        hd = hvd.broadcast_async(x, 0, name="tl.d")
        for h in (ha, hb, hc, hd):
            hvd.synchronize(h)
        hvd.stop_timeline()
    finally:
        if controller:
            for k in keys:
                os.environ.pop(k)
            hvd.shutdown()
            hvd.init()


def _port_timeline(path, controller):
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.ops import eager as E
    from horovod_tpu_torch.ops.collective_ops import Max
    from horovod_tpu_torch.timeline import start_timeline, stop_timeline

    env = {"HVD_TORCH_NATIVE_CONTROLLER": "on" if controller else "off"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        basics.init("cpu")
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    try:
        start_timeline(path)
        x = torch.zeros(4, 3)
        ha = E.allreduce_async(x, name="tl.a", average=True)
        hb = E.allreduce_async(x, name="tl.b", op=Max)
        hc = E.allgather_async(torch.ones(2, 3), "tl.c", sizes=[2])
        hd = E.broadcast_async(x, 0, name="tl.d")
        for h in (ha, hb, hc, hd):
            E.synchronize(h)
        stop_timeline()
    finally:
        basics.shutdown()


@pytest.mark.parametrize("controller", [False, True],
                         ids=["python", "native"])
def test_timeline_matches_jax_names_and_phases(tmp_path, controller):
    jax_path, port_path = tmp_path / "jax.json", tmp_path / "port.json"
    _jax_timeline(str(jax_path), controller)
    _port_timeline(str(port_path), controller)
    want, _ = _events(jax_path)
    got, events = _events(port_path)
    names = ["tl.a", "tl.b", "tl.c", "tl.d"]
    for n in names:
        assert got[n] == want[n], (n, got[n], want[n])
    tick = "NEGOTIATE_TICK_r0" if controller else "NEGOTIATE_TICK_ALL"
    assert (tick, "i") in got["tl.a"]
    assert events[-1]["name"] == "done"
    ends = [e for e in events if e["name"] == "ALLREDUCE" and e["ph"] == "E"]
    assert all(e["args"] == {"dtype": "float32", "shape": [4, 3]}
               for e in ends)


# ------------------------------------------------------------ engine autotune


def test_engine_autotunes_under_eager_traffic(tmp_path, monkeypatch):
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.ops import eager as E

    log = tmp_path / "tune.csv"
    for k, v in {"HOROVOD_AUTOTUNE": "1",
                 "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "1",
                 "HOROVOD_AUTOTUNE_STEADY_STATE_SAMPLES": "2",
                 "HOROVOD_AUTOTUNE_LOG": str(log),
                 "HVD_TORCH_NATIVE_CONTROLLER": "on"}.items():
        monkeypatch.setenv(k, v)
    basics.init("cpu")
    try:
        eng = E._engine()
        assert eng.autotuner is not None
        assert eng.autotuner.on_move == eng.controller.set_tuned
        grads = [torch.full((1 << 16,), float(i)) for i in range(4)]
        for _ in range(40):
            outs = E.grouped_allreduce_eager(grads, average=True)
            for o, g in zip(outs, grads):
                torch.testing.assert_close(o, g, rtol=0, atol=0)
            if len(log.read_text().splitlines()) > 2:
                break
        assert eng.autotuner._scores, "no window ever closed"
        assert eng.config.fusion_threshold_bytes in port_autotune.THRESHOLD_GRID
        assert eng.config.cycle_time_ms in port_autotune.CYCLE_GRID_MS
    finally:
        basics.shutdown()
