"""``update_ms.tokens``: device milliseconds per step of the kernels
launched inside the optimizer's gradient reduction and update (the
``portbench.update`` range the ``train_lm`` runner opens around
``DistributedOptimizer.synchronize()`` and ``step()`` in the traced
segment), the mean over ranks."""

RANGES = ("portbench.update",)


def read(run):
    per_rank = [sum(t["ranges"].get(RANGES[0], [])) for t in run.traces]
    if not any(per_rank):
        return None
    return sum(per_rank) / len(per_rank) / run.trace_steps / 1e3
