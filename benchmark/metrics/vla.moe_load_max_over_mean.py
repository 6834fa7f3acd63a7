"""The routers' load imbalance: in a rerank's prompt pass, each expert
layer's busiest expert's routed pairs over the mean pairs an expert
(``LlavaTorchScorer.last["moe_load"]``, computed on the device); the
median over the layers, the mean over the window's reranks. None where
no rerank records it, as in a program without experts."""
import statistics


def read(run):
    vals = [statistics.median(batch) for v in run.vla
            for batch in v.get("moe_load", ()) if batch]
    if run.kind != "serve" or not vals:
        return None
    return sum(vals) / len(vals)
