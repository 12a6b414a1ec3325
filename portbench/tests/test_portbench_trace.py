"""The trace reduction and the per-layer readers on synthetic traces."""

from __future__ import annotations

import itertools
import types

import pytest

from portbench import harness, trace


def _summary(kernels, window=(0.0, 1000.0), ranges=None):
    names = sorted({k[2] for k in kernels})
    return {"window": list(window),
            "kernels": [[a, b, names.index(n)] for a, b, n in kernels],
            "names": names, "ranges": ranges or {}, "device_ops": [],
            "idle_gaps": []}


def _run(cell_name, summaries, steps=2, window_s=10.0, trace_steps=2):
    cell = harness.Cell(cell_name)
    reports = [{"rank": r, "trace": s, "trace_steps": trace_steps,
                "window": {"steps": steps, "seconds": window_s},
                "work_per_step": cell.runner.work_per_step(cell.config,
                                                           cell.traffic),
                "setup_end": 105.0}
               for r, s in enumerate(summaries)]
    return harness.Run(cell, reports, t_process=100.0)


def test_interval_arithmetic():
    assert trace.union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]
    assert trace.length([(0, 2), (1, 3)]) == 3
    assert trace.gaps([(2, 3), (5, 6)], 0, 10) == [(0, 2), (3, 5), (6, 10)]


def test_idle_share_and_busy_time_clip_to_the_window():
    s = _summary([(-50, 100, "k"), (200, 300, "k"), (250, 400, "m"),
                  (900, 1200, "k")])
    assert trace.busy_us(s) == 100 + 200 + 100
    run = _run("mistral7b-l8.train.4x4096", [s])
    idle = harness.reader("device_idle.tokens").read(run)
    assert idle == pytest.approx(60.0)


def test_rooflines_hold_each_call_to_its_bound():
    from portbench import yardstick

    fwd_ms, _ = yardstick.flash_bound(4, 32, 8, 4096, 128, True, 2, "bf16")
    bwd_ms, _ = yardstick.attn_bwd_bound(4, 32, 8, 4096, 128, True, 2,
                                         "bf16")
    ranges = {"_Flash": [fwd_ms * 1e3 * 2] * 4,
              "autograd::engine::evaluate_function: _FlashBackward":
                  [bwd_ms * 1e3 * 4] * 2,
              "portbench.update": [30_000.0, 6_000.0]}
    run = _run("mistral7b-l8.train.4x4096",
               [_summary([(0, 10, "k")], ranges=ranges)], trace_steps=2)
    assert harness.reader("attn_fwd_roofline.tokens").read(run) == \
        pytest.approx(50.0)
    assert harness.reader("attn_bwd_roofline.tokens").read(run) == \
        pytest.approx(25.0)
    assert harness.reader("update_ms.tokens").read(run) == pytest.approx(18.0)
    # No range read: the readers return nothing, never 0.
    empty = _run("mistral7b-l8.train.4x4096", [_summary([(0, 10, "k")])])
    for name in ("attn_fwd_roofline.tokens", "attn_bwd_roofline.tokens",
                 "update_ms.tokens"):
        assert harness.reader(name).read(empty) is None


def test_mfu_and_rates_take_the_whole_window():
    run = _run("mistral7b-l8.train.4x4096", [_summary([(0, 1, "k")])],
               steps=20, window_s=12.0)
    assert harness.reader("train_tokens_per_s").read(run) == \
        pytest.approx(20 * 16384 / 12.0)
    assert harness.reader("mfu.tokens").read(run) == pytest.approx(
        100 * 20 * 197_606_076_579_840 / 12.0 / 989e12)
    assert harness.reader("setup_s").read(run) == pytest.approx(5.0)
    # Every rank's images count, over the longest rank's window.
    four = _run("resnet50.train.b256", [_summary([(0, 1, "k")])] * 4,
                steps=100, window_s=10.0)
    assert harness.reader("train_images_per_s").read(four) == \
        pytest.approx(4 * 100 * 256 / 10.0)
    assert harness.reader("mfu.images").read(four) == pytest.approx(
        100 * 3 * 8_178_368_512 * 4 * 100 * 256 / 10.0 / (4 * 989e12))


_IDS = itertools.count(1)


def _event(name, start, end, device="CPU", kernels=(), children=(),
           annotation=False, id=None):
    from torch.autograd import DeviceType

    e = types.SimpleNamespace(
        id=id if id is not None else next(_IDS),
        name=name, time_range=types.SimpleNamespace(start=start, end=end),
        device_type=getattr(DeviceType, device), is_async=False,
        is_user_annotation=annotation, cpu_parent=None,
        kernels=[types.SimpleNamespace(name=n, duration=d)
                 for n, d in kernels], cpu_children=list(children))
    for c in e.cpu_children:
        c.cpu_parent = e
    return e


def test_summarize_counts_outermost_ranges_and_drops_overhead():
    # The launch queue filled inside aten::mm: the profiler's record of it
    # carries the operation's id, and the gemm is linked to both.
    queue_full = _event("Command Buffer Full", 45, 46, id=1000,
                        kernels=[("gemm", 7)])
    inner = _event("portbench.update", 20, 30, kernels=[("adam", 4)])
    outer = _event("portbench.update", 10, 60, children=[
        inner, _event("aten::mm", 40, 50, kernels=[("gemm", 7)], id=1000,
                      children=[queue_full])],
        kernels=[("Command Buffer Full", 500)])
    events = [
        _event("portbench.window", 0, 100),
        outer, *outer.cpu_children, queue_full,
        _event("gemm", 41, 49, device="CUDA"),
        _event("adam", 25, 29, device="CUDA"),
        _event("Command Buffer Full", 0, 100, device="CUDA"),
        _event("portbench.update", 0, 100, device="CUDA", annotation=True),
    ]
    prof = types.SimpleNamespace(events=lambda: events)
    s = trace.summarize(prof, ["portbench.update", "_Flash"])
    assert s["ranges"] == {"portbench.update": [11], "_Flash": []}
    assert sorted(s["names"]) == ["adam", "gemm"]
    assert trace.busy_us(s) == 12
    assert trace.window_us(s) == 100
    # Idle 0-25 and 29-41 µs inside the outer range, 49-100 after it.
    assert dict(s["idle_gaps"]) == pytest.approx(
        {"portbench.update": 37e-6, "no host operation open": 51e-6})
    with pytest.raises(RuntimeError, match="portbench.window"):
        trace.summarize(types.SimpleNamespace(events=lambda: events[1:]))
