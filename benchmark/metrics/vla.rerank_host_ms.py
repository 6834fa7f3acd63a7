"""The rerank's time outside its device-timed parts: the mean of
``StageTimer`` ``vla_rerank`` (the whole rerank on the host clock) less
the mean over the window's reranks of ``encode_ms + prefill_ms +
decode_ms`` (``LlavaTorchScorer.last``, CUDA events), in ms: candidate
prompts, tokenizing, uploads, the parse and the selector."""

PARTS = ("encode_ms", "prefill_ms", "decode_ms")


def read(run):
    st = run.stages.get("vla_rerank")
    vals = [sum(v[k] for k in PARTS) for v in run.vla
            if all(k in v for k in PARTS)]
    if run.kind != "serve" or not st or not st["count"] or not vals:
        return None
    return 1e3 * st["total_s"] / st["count"] - sum(vals) / len(vals)
