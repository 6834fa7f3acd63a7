"""The 95th percentile of every frame's time in the window, in ms."""
from benchmark.core.stats import percentile


def read(run):
    if run.kind != "serve" or not run.item_s:
        return None
    return 1e3 * percentile(run.item_s, 95)
