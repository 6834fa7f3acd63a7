"""The rerank's image encoding: the anyres tiles through the vision
tower, the projector and the packing (``LlavaTorchScorer.last
["encode_ms"]``, CUDA events), the mean over the window's reranks, in
ms."""


def read(run):
    vals = [v["encode_ms"] for v in run.vla if "encode_ms" in v]
    return sum(vals) / len(vals) if vals else None
