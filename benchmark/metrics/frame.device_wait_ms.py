"""``StageTimer`` ``device_wait``: the host's blocking waits for the
device (``utils.device.host_read``, ``fetch_to_host``'s one
synchronization, and in the rerank the scorer's and the decode's CUDA
event synchronizations), host clock. The window's total over its
published frames, in ms."""


def read(run):
    st = run.stages.get("device_wait")
    if run.kind != "serve" or not run.item_s or not st:
        return None
    return 1e3 * st["total_s"] / len(run.item_s)
