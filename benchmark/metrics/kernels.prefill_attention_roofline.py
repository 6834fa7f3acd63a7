"""The flash prefill's share of its roofline, in %: the least time of
the attention the rerank's rows need (causal pairs, a prefix the rows
share counted once; ``core.work``) at the bf16 and HBM peaks, over the
device time of ``flash_prefill_kernel`` in the traced frames."""
from benchmark.core.peaks import least_seconds


def read(run):
    tr = run.trace
    flop = run.work.get("attn_flop", 0.0)
    if tr is None or not flop:
        return None
    seconds = tr.kernel_seconds("flash_prefill_kernel")
    if seconds <= 0:
        return None
    least = least_seconds(flop, run.work.get("attn_bytes", 0.0), "bfloat16")
    return 100.0 * least / seconds
