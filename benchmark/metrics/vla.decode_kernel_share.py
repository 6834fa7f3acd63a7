"""The share of the window's reranks whose decode steps' attention ran
the hand-written decode kernel, in %: ``LlavaTorchScorer.last``'s
``decode_attention`` reads "kernel" (the steps' attention launched
``kernels/decode_attention``'s CUDA kernel, captured or eagerly) or
"plain" (its plain version, off the card), the newest batch's. None
where no rerank records it, as in a program without it or a decoder
whose step keeps its own attention (latent attention)."""


def read(run):
    routes = [v["decode_attention"] for v in run.vla
              if "decode_attention" in v]
    if run.kind != "serve" or not routes:
        return None
    return 100.0 * sum(r == "kernel" for r in routes) / len(routes)
