"""The rerank's prefill (``LlavaTorchScorer.last["prefill_ms"]``, CUDA
events), the mean over the window's reranks, in ms."""


def read(run):
    vals = [v["prefill_ms"] for v in run.vla if "prefill_ms" in v]
    return sum(vals) / len(vals) if vals else None
