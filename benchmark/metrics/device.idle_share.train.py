"""The device's idle share of a training step, in %: 1 less the
device-busy time a traced step (the union of the profiler's device
intervals over the traced steps) over the untraced window's time a step.
The profiler slows the host, so the traced steps' own wall time would
read the idle share high; this sets device time against the same clock
as ``mfu``."""


def read(run):
    tr = run.trace
    if run.kind != "train" or tr is None or not tr.items \
            or tr.busy_s <= 0 or not run.steps:
        return None
    return 100.0 * (1.0 - (tr.busy_s / tr.items) / (run.window_s / run.steps))
