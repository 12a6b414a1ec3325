"""``train_tokens_per_s``: the tokens every rank trained on in the measured
window over the window's length (the longest rank's), host clock."""


def read(run):
    return run.work / run.window_s
