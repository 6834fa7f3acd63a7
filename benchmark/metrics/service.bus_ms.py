"""``StageTimer`` ``bus_push`` (``on_mask``, ``on_depth``: a frame into
the frame bus) and ``bus_pair`` (``process_pending``'s
``try_get_pair``), host clock. The window's total over its published
frames, in ms."""


def read(run):
    got = [run.stages[k] for k in ("bus_push", "bus_pair")
           if k in run.stages]
    if run.kind != "serve" or not run.item_s or not got:
        return None
    return 1e3 * sum(st["total_s"] for st in got) / len(run.item_s)
