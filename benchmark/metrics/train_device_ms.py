"""The card's busy time an optimizer step, in ms: the union of the
profiler's device intervals over the profiled tail's steps, over those
steps. Left out where no operation ran on a device."""


def read(run):
    tr = run.trace
    if run.kind != "train" or tr is None or not tr.items or tr.busy_s <= 0:
        return None
    return 1e3 * tr.busy_s / tr.items
