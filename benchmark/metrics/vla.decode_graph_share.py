"""The share of the window's reranks whose greedy decode replayed a CUDA
graph captured before that rerank, in %: ``LlavaTorchScorer.last``'s
``decode_graph`` reads "replayed" (it reads "captured" where the rerank
captured the graph itself, "eager" where the steps ran without one).
None where no rerank records a route, as in a program without it."""


def read(run):
    routes = [v["decode_graph"] for v in run.vla if "decode_graph" in v]
    if run.kind != "serve" or not routes:
        return None
    return 100.0 * sum(r == "replayed" for r in routes) / len(routes)
