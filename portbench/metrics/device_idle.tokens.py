"""The device's idle share of the traced segment: the time in which no
operation ran on the card over the segment's length, in percent (the
mean over ranks)."""

from portbench import trace


def read(run):
    shares = [1 - trace.busy_us(t) / trace.window_us(t) for t in run.traces
              if t["kernels"]]
    if not shares:
        return None
    return 100 * sum(shares) / len(shares)
