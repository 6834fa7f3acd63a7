"""The grouped expert kernel's device time a rerank, in ms:
``moe_experts_gate_up_kernel`` and ``moe_experts_down_kernel`` in the
traced frames (prompt pass and decode steps), over the reranks they
ran."""


def read(run):
    tr = run.trace
    n = run.work.get("traced_reranks", 0.0)
    if tr is None or not n:
        return None
    seconds = tr.kernel_seconds("moe_experts_gate_up_kernel",
                                "moe_experts_down_kernel")
    return 1e3 * seconds / n if seconds > 0 else None
