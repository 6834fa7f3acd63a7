"""The rerank's greedy decode (``LlavaTorchScorer.last["decode_ms"]``,
CUDA events, every step of it), the mean over the window's reranks, in
ms."""


def read(run):
    vals = [v["decode_ms"] for v in run.vla if "decode_ms" in v]
    return sum(vals) / len(vals) if vals else None
