"""The comparison that decides ``correct`` for a training cell.

Both sides give the same readings of the first steps of one training run
from the same weights and batches:

``losses``  the loss of each step, averaged over the world;
``grad``    per leaf, the norm of the first step's gradient as the
            optimizer received it (reduced over the world and clipped);
``change``  per leaf, the norm of the parameters' change over the steps.

Three numbers are compared, each against its cell's limit:

``loss_gap``    max over steps of |loss − ref| / |ref|;
``grad_gap``    max over leaves of | ‖g‖ − ‖g_ref‖ | / max(‖g_ref‖,
                median leaf's ‖g_ref‖);
``change_gap``  the same for the change.

Each leaf number leaves out the leaves whose own reference reading, the
first gradient for ``grad_gap`` and the change for ``change_gap``, is
under a thousandth of the median leaf's (:func:`kept_leaves`): their
gradient or change is nought to rounding.  A reading that is missing or
not finite reads as infinitely far.
"""

from __future__ import annotations

import math
import statistics

SKIP_SHARE = 1e-3
NUMBERS = ("loss_gap", "grad_gap", "change_gap")


def kept_leaves(ref: dict) -> list[str]:
    """The leaves a leaf number compares: those whose reference reading
    (``ref``, by leaf) is at least a thousandth of the median leaf's, the
    median taken over the leaves that read above nought."""
    moving = [v for v in ref.values() if v > 0]
    if not moving:
        return []
    floor = SKIP_SHARE * statistics.median(moving)
    return sorted(k for k, v in ref.items() if v >= floor)


def _gap(value, ref: float, scale: float) -> float:
    if value is None or not math.isfinite(value):
        return math.inf
    return abs(value - ref) / scale


def leaf_gap(prog: dict, ref: dict, keys) -> tuple[float, str | None]:
    """The worst gap over ``keys`` and its leaf."""
    if not keys:
        return math.inf, None
    scale = statistics.median(ref[k] for k in keys)
    worst = max(keys, key=lambda k: _gap(prog.get(k), ref[k],
                                         max(ref[k], scale)))
    return _gap(prog.get(worst), ref[worst], max(ref[worst], scale)), worst


def loss_gap(prog: list, ref: list) -> float:
    if len(prog) != len(ref):
        return math.inf
    return max(_gap(p, r, abs(r)) for p, r in zip(prog, ref))


def readings_gaps(prog: dict, ref: dict) -> dict:
    """The three numbers, and the leaves that set the two leaf numbers."""
    out = {"loss_gap": loss_gap(prog["losses"], ref["losses"]),
           "worst_leaf": {}, "leaves_compared": {}, "leaves_left_out": {}}
    for kind in ("grad", "change"):
        keys = kept_leaves(ref[kind])
        out[f"{kind}_gap"], out["worst_leaf"][kind] = leaf_gap(
            prog[kind], ref[kind], keys)
        out["leaves_compared"][kind] = len(keys)
        out["leaves_left_out"][kind] = sorted(set(ref[kind]) - set(keys))
    return out


def judge(prog: dict, ref: dict, limits: dict) -> tuple[bool, dict, dict]:
    """(correct, compared, detail): ``compared`` maps each number to its
    value and limit, in the order of ``NUMBERS``; a number whose limit is
    None is shown and not judged."""
    gaps = readings_gaps(prog, ref)
    compared, ok = {}, True
    for name in NUMBERS:
        limit = limits.get(name)
        compared[name] = {"value": gaps[name], "limit": limit}
        if limit is not None and not gaps[name] <= limit:
            ok = False
    return ok, compared, gaps
