"""Frames published in the window over the window's seconds."""
from benchmark.core.stats import rate


def read(run):
    if run.kind != "serve" or not run.item_s:
        return None
    return rate(len(run.item_s), run.window_s)
