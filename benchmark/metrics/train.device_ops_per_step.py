"""Device operations (kernels, copies, fills) in the traced window over
the optimizer steps it held."""


def read(run):
    tr = run.trace
    if run.kind != "train" or tr is None or not tr.items:
        return None
    return tr.n_device_ops / tr.items
