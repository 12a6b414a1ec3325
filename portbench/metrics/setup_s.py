"""``setup_s``: from the start of the process that prints the result to the
start of the measured window on the last rank to reach it: loading,
building the port's kernels where they are not built yet, making the
weights, the checked first steps and the warm-up steps (host clock)."""


def read(run):
    return max(r["setup_end"] for r in run.reports) - run.t_process
