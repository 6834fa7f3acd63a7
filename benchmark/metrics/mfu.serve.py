"""The frame's counted work at the card's peaks over the window's mean
frame time, in %: the CNN's products in float32 and the rerank's
(tower, projector, decoder, attention, a shared prefix once) in
bfloat16 (``core.work``), counted over the traced frames, a frame's
share of it set against the untraced window's time a frame."""
from benchmark.core.peaks import PEAK_FLOP_PER_S


def read(run):
    tr = run.trace
    if run.kind != "serve" or tr is None or not tr.items or not run.item_s:
        return None
    least = (run.work.get("cnn_flop", 0.0) / PEAK_FLOP_PER_S["float32"]
             + run.work.get("rerank_flop", 0.0)
             / PEAK_FLOP_PER_S["bfloat16"]) / tr.items
    if least <= 0:
        return None
    return 100.0 * least / (run.window_s / len(run.item_s))
