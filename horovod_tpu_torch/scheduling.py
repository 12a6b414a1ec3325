"""Pluggable scheduler policies for :class:`ServeEngine`.

A copy of ``horovod_tpu/scheduling.py`` for the PyTorch port, which may not
import the JAX package (its ``__init__`` pulls in jax); environment
knobs are ``HVD_TORCH_*`` here.  Names of modules the port does not
have yet (the router, the monitor, tracing, ...) are the reference's.

Admission order and preemption victim choice used to be hardcoded —
FIFO over the queue, evict the youngest decoding row.  Both are
*policy*, not correctness: scheduler invariant 2 (row independence +
greedy determinism) pins every request's output bit-identical to its
solo run regardless of who runs first or who gets preempted, so the
scheduler is free to reorder waiting and to pick preemption victims by
regret rather than by age.  This module is that seam, in the shape
production schedulers grew it (vLLM's ``--scheduling-policy
{fcfs,priority}``, Sarathi/DistServe-style SLO-aware variants):

* :class:`FifoPolicy` — submission order, evict the youngest.  The
  default, and **bit-compatible** with the pre-policy engine: every
  decision it returns is exactly what the hardcoded code chose.
* :class:`PriorityPolicy` — higher ``Request.priority`` admits first,
  lowest-priority rows are preempted first; a step-counted starvation
  guard promotes entries stuck longer than ``starvation_steps`` to the
  front (in FIFO order among themselves) so low priority means *later*,
  never *never*.
* :class:`EdfPolicy` — earliest-deadline-first over the absolute SLO
  deadline (``enqueue + Request.slo_s``; requests without an SLO sort
  last, FIFO among themselves).  Preemption evicts the
  **slack-richest** row — the one with the most time left to its
  deadline, i.e. the least-regretted victim — instead of the youngest.

A policy sees the engine's own queue entries and slot records
(duck-typed: ``req``, ``queued_steps``, ``slo_deadline``,
``admit_seq``) and returns *orderings and choices only* — it never
mutates scheduler state, allocates blocks, or touches device programs,
so a policy never adds (or retraces) a jit signature.

Select with ``ServeEngine(policy=...)`` — an instance, a name, or
``None`` to read the ``HVD_TORCH_SCHED_POLICY`` env knob (default
``fifo``).
"""

from __future__ import annotations

import math
import os
from typing import Any, Sequence


def _slo_deadline(x: Any) -> float:
    """Absolute SLO deadline of a queue entry or slot; no-SLO requests
    sort as infinitely slack."""
    d = x.slo_deadline
    return math.inf if d is None else d


def _priority(x: Any) -> int:
    return x.req.priority if x.req is not None else 0


class SchedulerPolicy:
    """Admission order + preemption victim selection.

    ``admission_order(queue)`` returns the queue's entries in the order
    admission should consider them (a permutation — never add or drop
    entries).  Head-of-line blocking applies to the first block-starved
    candidate in that order, which is what feeds the preemption
    trigger, so the order decides who waits under pressure.

    ``victim(candidates)`` picks the slot index to preempt from a
    non-empty ``[(slot_index, slot), ...]`` list of replayable decoding
    rows.  The preempted request replays bit-identically, so this is a
    pure latency/regret decision."""

    name = "base"

    def admission_order(self, queue: Sequence[Any]) -> list[Any]:
        raise NotImplementedError

    def victim(self, candidates: Sequence[tuple[int, Any]]) -> int:
        raise NotImplementedError


class FifoPolicy(SchedulerPolicy):
    """Submission order in, youngest row out — the bit-compatible
    default (exactly the pre-policy hardcoded behavior)."""

    name = "fifo"

    def admission_order(self, queue: Sequence[Any]) -> list[Any]:
        return list(queue)

    def victim(self, candidates: Sequence[tuple[int, Any]]) -> int:
        return max(candidates, key=lambda c: c[1].admit_seq)[0]


class PriorityPolicy(SchedulerPolicy):
    """Strict priority with a step-counted starvation guard.

    Entries queued ``starvation_steps`` or longer jump to the front in
    FIFO order among themselves; the rest sort by descending
    ``Request.priority`` (stable, so equal priorities stay FIFO).
    Preemption evicts the lowest-priority row, youngest on ties."""

    name = "priority"

    def __init__(self, starvation_steps: int = 64):
        if starvation_steps < 1:
            raise ValueError(f"starvation_steps must be >= 1, got "
                             f"{starvation_steps}")
        self.starvation_steps = starvation_steps

    def admission_order(self, queue: Sequence[Any]) -> list[Any]:
        starved = [e for e in queue
                   if e.queued_steps >= self.starvation_steps]
        fresh = sorted((e for e in queue
                        if e.queued_steps < self.starvation_steps),
                       key=lambda e: -_priority(e))
        return starved + fresh

    def victim(self, candidates: Sequence[tuple[int, Any]]) -> int:
        return max(candidates,
                   key=lambda c: (-_priority(c[1]), c[1].admit_seq))[0]


class EdfPolicy(SchedulerPolicy):
    """Earliest-deadline-first over ``enqueue + Request.slo_s``.

    Admission runs the most urgent deadline first (no-SLO entries last,
    FIFO among themselves — ``sorted`` is stable); preemption evicts
    the slack-richest row (latest deadline, youngest on ties) — the
    victim whose SLO the replay detour hurts least."""

    name = "edf"

    def admission_order(self, queue: Sequence[Any]) -> list[Any]:
        return sorted(queue, key=_slo_deadline)

    def victim(self, candidates: Sequence[tuple[int, Any]]) -> int:
        return max(candidates,
                   key=lambda c: (_slo_deadline(c[1]),
                                  c[1].admit_seq))[0]


POLICIES: dict[str, type[SchedulerPolicy]] = {
    "fifo": FifoPolicy,
    "priority": PriorityPolicy,
    "edf": EdfPolicy,
}


def resolve_policy(
    policy: "SchedulerPolicy | str | None" = None,
) -> SchedulerPolicy:
    """An instance passes through; a name constructs; ``None`` reads
    ``HVD_TORCH_SCHED_POLICY`` (unset/empty → ``fifo``)."""
    if isinstance(policy, SchedulerPolicy):
        return policy
    name = policy or os.environ.get("HVD_TORCH_SCHED_POLICY", "") or "fifo"
    cls = POLICIES.get(name)
    if cls is None:
        raise ValueError(
            f"unknown scheduler policy {name!r}; choose from "
            f"{sorted(POLICIES)}")
    return cls()
