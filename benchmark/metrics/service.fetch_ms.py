"""``StageTimer`` ``fetch``: ``fetch_to_host`` of a frame's result, the
copies' launch and the one synchronization (its wait is also in
``device_wait``), host clock. The window's total over its published
frames, in ms."""


def read(run):
    st = run.stages.get("fetch")
    if run.kind != "serve" or not run.item_s or not st:
        return None
    return 1e3 * st["total_s"] / len(run.item_s)
