"""The step's counted work (forward and backward products,
``core.work``) at the card's peak for the step's type over the window's
time a step, in %; the work is counted over the traced steps."""
from benchmark.core.peaks import PEAK_FLOP_PER_S


def read(run):
    tr = run.trace
    flop = run.work.get("train_flop", 0.0)
    if run.kind != "train" or tr is None or not tr.items or not flop \
            or not run.steps:
        return None
    dtype = run.work.get("train_dtype", "float32")
    least = flop / PEAK_FLOP_PER_S[dtype] / tr.items
    return 100.0 * least / (run.window_s / run.steps)
