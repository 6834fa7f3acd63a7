"""The window's seconds over the optimizer steps it completed, in ms:
the host-clock step time, which the shared host's launch speed sets."""


def read(run):
    if run.kind != "train" or not run.steps:
        return None
    return 1e3 * run.window_s / run.steps
