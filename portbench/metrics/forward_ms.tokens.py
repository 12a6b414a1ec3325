"""``forward_ms.tokens``: device milliseconds per step of the kernels
launched inside the port's ``hvd.forward`` span: ``make_train_step``'s
forward, ``loss_fn(params, batch)``. The summary's ``ranges`` summed
over the traced steps, the mean over ranks (the arithmetic of
``update_ms.tokens``); nothing where no trace holds the range."""

RANGES = ("hvd.forward",)


def read(run):
    per_rank = [t["ranges"].get(RANGES[0], []) for t in run.traces]
    if not any(per_rank):
        return None
    return (sum(sum(r) for r in per_rank) / len(per_rank)
            / run.trace_steps / 1e3)
