"""The grouped expert kernel's share of its roofline, in %: the least
time of the routed pairs' products and of the experts' weights and the
tokens' rows (``core.work_moe``) at the bf16 and HBM peaks, taken apart
for the calls of a few pairs (decode steps, bound by the weights) and of many
(prompt passes, bound by the products) and added, over the device time
of ``moe_experts_gate_up_kernel`` and ``moe_experts_down_kernel`` in the
traced frames. The harness counts the calls it sees at the kernel's
wrapper (the prompt passes, eager steps), and a decode graph's replays
from the rerank's shapes: their pairs exactly, their experts read as the
fewest a call can read (one token's k), so the decode's part of the
share reads low (``models/llava_moe_rerank.py``)."""
from benchmark.core.peaks import least_seconds


def read(run):
    tr = run.trace
    if tr is None:
        return None
    least = sum(least_seconds(run.work.get(f"moe_flop.{size}", 0.0),
                              run.work.get(f"moe_bytes.{size}", 0.0),
                              "bfloat16") for size in ("few", "many"))
    seconds = tr.kernel_seconds("moe_experts_gate_up_kernel",
                                "moe_experts_down_kernel")
    if least <= 0 or seconds <= 0:
        return None
    return 100.0 * least / seconds
