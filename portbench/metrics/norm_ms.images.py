"""``norm_ms.images``: device milliseconds per step of the kernels launched
inside the port's fused batch norm: the profiler's range around the
forward of its autograd function (``_BatchNormAct``: statistics and apply)
and around its backward (``..._BatchNormActBackward``: reduce and
element-wise).  Both ranges' outermost occurrences summed over the traced
steps, the mean over ranks (the arithmetic of ``reduce_ms.images``);
nothing where no trace holds either range, as in a program without the
fused batch norm."""

RANGES = ("_BatchNormAct",
          "autograd::engine::evaluate_function: _BatchNormActBackward")


def read(run):
    per_rank = [[us for name in RANGES for us in t["ranges"].get(name, [])]
                for t in run.traces]
    if not any(per_rank):
        return None
    return (sum(sum(r) for r in per_rank) / len(per_rank)
            / run.trace_steps / 1e3)
