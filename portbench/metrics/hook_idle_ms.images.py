"""``hook_idle_ms.images``: device-idle milliseconds per traced step in
the gaps whose innermost open host operation is the port's ``hvd.hook``
span (the hook optimizer's post-accumulate-grad hook, on autograd's
thread): the summary's ``idle_gaps`` entry of that name over the traced
steps, the mean over ranks' traces.  A lower bound: ``trace.summarize``
names only the longest gaps (``NAMED_GAPS``) and keeps the ten names that
hold most of them.  Nothing where no trace names the span."""

GAP = "hvd.hook"


def read(run):
    per_rank = [dict(t["idle_gaps"]).get(GAP) for t in run.traces]
    if all(s is None for s in per_rank):
        return None
    return (sum(s or 0.0 for s in per_rank) / len(per_rank)
            / run.trace_steps * 1e3)
