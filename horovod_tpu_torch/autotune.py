"""Autotuner: an online search over the fusion threshold and cycle time.

Port of ``horovod_tpu/autotune.py`` (later Horovod's ``HOROVOD_AUTOTUNE``):
a coordinate-descent hill climber over a log-spaced threshold grid and a
cycle-time grid, scored by the bytes the engine's allreduces moved per
second of wall time.

The engine calls :meth:`Autotuner.observe` after each flush that
dispatched an allreduce, with the bytes a rank moved and a probe of the
batch.  When a window closes (enough flushes and bytes), the tuner waits
for the probe to finish (its CUDA event on the card, its ``Work`` on the
CPU), so the window's wall time covers the collectives and not only their
issue; it scores the setting in bytes/s, writes a log row and moves to a
neighbouring setting, or, once no neighbour beats the incumbent (re-scored
once before it is pinned), pins the best and stops.  The score is the
whole loop's cadence, deliberately: a setting that hides the wire under
compute should win.

``HOROVOD_AUTOTUNE=1`` enables it; ``HOROVOD_AUTOTUNE_LOG=<file>`` writes
a CSV of (setting, score) rows.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Any

MiB = 1024 * 1024

# 0 disables fusion (one collective a tensor): a real candidate where
# fusion only adds the copy.
THRESHOLD_GRID = (0, 1 * MiB, 4 * MiB, 16 * MiB, 64 * MiB, 256 * MiB)
CYCLE_GRID_MS = (1.0, 2.5, 5.0, 10.0, 25.0)


class Autotuner:
    """Coordinate descent over (fusion_threshold, cycle_time).

    Owns no thread: driven by ``observe()`` from the engine, it writes
    ``config``'s two knobs in place (the engine reads both every cycle)."""

    def __init__(self, config, *, warmup_samples: int = 3,
                 window_flushes: int = 10, min_window_bytes: int = 1 * MiB,
                 log_path: str | None = None, on_move=None):
        """``on_move(threshold_bytes, cycle_ms)`` fires on every move, the
        final pin included: with the native controller, rank 0 forwards it
        to ``NativeController.set_tuned`` so the world re-buckets at the
        next tick."""
        self.config = config
        self.on_move = on_move
        self.warmup_samples = warmup_samples
        self.warmup_left = warmup_samples
        self.window_flushes = window_flushes
        self.min_window_bytes = min_window_bytes
        self.log_path = log_path
        self.done = False
        # observe() runs outside the engine's flush lock, so that waiting
        # on the probe cannot stall other flushes: guard the tuner's state.
        self._obs_lock = threading.Lock()

        ti = _nearest(THRESHOLD_GRID, config.fusion_threshold_bytes)
        ci = _nearest(CYCLE_GRID_MS, config.cycle_time_ms)
        self._pos = (ti, ci)
        self._scores: dict[tuple[int, int], float] = {}
        self._score_counts: dict[tuple[int, int], int] = {}
        self._pending: list[tuple[int, int]] = []
        self._coord = 0            # 0: tune the threshold, 1: the cycle time
        self._stale_coords = 0     # coordinates in a row with no improvement
        self._confirmed = False    # incumbent re-scored before finishing?
        self._best_seen: tuple[int, int] | None = None
        # Two settings with equal means could swap the lead forever, each
        # swap paying a window: after three revisits the best is pinned.
        self._confirm_budget = 3
        self._win_bytes = 0
        self._win_flushes = 0
        self._win_t0: float | None = None
        self._win_last_out: Any = None
        if self.log_path:
            with open(self.log_path, "w") as f:
                f.write("threshold_bytes,cycle_time_ms,"
                        "score_bytes_per_sec,best\n")

    def observe(self, nbytes: int, last_out: Any) -> None:
        """One flush's dispatched allreduce traffic; ``last_out`` has
        ``synchronize()``, which blocks until the flush's last collective
        finished (or is None)."""
        if self.done or nbytes <= 0:
            return
        with self._obs_lock:
            if self.warmup_left > 0:
                self.warmup_left -= 1
                return
            if self._win_t0 is None:
                self._win_t0 = time.monotonic()
            self._win_bytes += nbytes
            self._win_flushes += 1
            self._win_last_out = last_out
            if (self._win_flushes >= self.window_flushes
                    and self._win_bytes >= self.min_window_bytes):
                self._close_window()

    def _close_window(self) -> None:
        if self._win_last_out is not None:
            self._win_last_out.synchronize()
        elapsed = max(time.monotonic() - self._win_t0, 1e-9)
        score = self._win_bytes / elapsed
        # A running mean per setting: revisits refine, one lucky window
        # does not stick.
        k = self._score_counts.get(self._pos, 0)
        prev = self._scores.get(self._pos, 0.0)
        self._scores[self._pos] = (prev * k + score) / (k + 1)
        self._score_counts[self._pos] = k + 1
        self._log_row(score)
        self._win_bytes = 0
        self._win_flushes = 0
        self._win_t0 = None
        self._win_last_out = None
        self._advance()

    def _advance(self) -> None:
        if not self._pending:
            best = max(self._scores, key=self._scores.__getitem__)
            if best != self._best_seen:
                # A new incumbent must be (re-)confirmed before it is pinned.
                self._best_seen = best
                self._confirmed = False
            grid = THRESHOLD_GRID if self._coord == 0 else CYCLE_GRID_MS
            i = best[self._coord]
            neighbors = [_with_coord(best, self._coord, j)
                         for j in (i - 1, i + 1) if 0 <= j < len(grid)]
            self._pending = [p for p in neighbors if p not in self._scores]
            if not self._pending:
                # This coordinate is locally optimal: switch; when both
                # are, confirm the incumbent once, then finish.
                self._stale_coords += 1
                self._coord ^= 1
                if self._stale_coords >= 2:
                    if not self._confirmed and self._confirm_budget > 0:
                        self._confirm_budget -= 1
                        self._confirmed = True
                        self._move_to(best)
                        return
                    self._finish(max(self._scores,
                                     key=self._scores.__getitem__))
                    return
                self._advance()
                return
            self._stale_coords = 0
            self._confirmed = False
        self._move_to(self._pending.pop(0))

    def _move_to(self, pos: tuple[int, int]) -> None:
        self._pos = pos
        self.config.fusion_threshold_bytes = THRESHOLD_GRID[pos[0]]
        self.config.cycle_time_ms = CYCLE_GRID_MS[pos[1]]
        if self.on_move is not None:
            self.on_move(THRESHOLD_GRID[pos[0]], CYCLE_GRID_MS[pos[1]])
        # New bucket shapes change the first flushes' cost (new buffer
        # sizes for the allocator): warm up again after every move.
        self.warmup_left = self.warmup_samples

    def _finish(self, best: tuple[int, int]) -> None:
        self._move_to(best)
        self.done = True
        self._log_row(self._scores[best], best=True)
        print("horovod_tpu_torch autotune converged: "
              f"HOROVOD_FUSION_THRESHOLD={THRESHOLD_GRID[best[0]]} "
              f"HOROVOD_CYCLE_TIME={CYCLE_GRID_MS[best[1]]} "
              f"({self._scores[best] / MiB:.1f} MiB/s observed)",
              file=sys.stderr)

    def _log_row(self, score: float, best: bool = False) -> None:
        if not self.log_path:
            return
        with open(self.log_path, "a") as f:
            f.write(f"{self.config.fusion_threshold_bytes},"
                    f"{self.config.cycle_time_ms},{score:.1f},{int(best)}\n")


def _nearest(grid, value) -> int:
    return min(range(len(grid)), key=lambda i: abs(grid[i] - value))


def _with_coord(pos: tuple[int, int], coord: int, j: int) -> tuple[int, int]:
    return (j, pos[1]) if coord == 0 else (pos[0], j)
