"""The share of the window's reranks whose prompt ran the shared route,
in %: ``LlavaTorchScorer.last``'s ``prefill_route`` reads "shared" (the
rows' image prefix ran once, its K/V were copied into every row and the
rows' text ran alone) or "full" (one pass over every slot of every
row), the newest batch's route. None where no rerank records a route,
as in a program without it."""


def read(run):
    routes = [v["prefill_route"] for v in run.vla if "prefill_route" in v]
    if run.kind != "serve" or not routes:
        return None
    return 100.0 * sum(r == "shared" for r in routes) / len(routes)
