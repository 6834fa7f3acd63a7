"""The service's own time around the frame stages: each frame's time
less its ``StageTimer`` ``frame_total`` (bus push and pairing, the int16
cast), the mean over the window's frames, in ms."""


def read(run):
    total = run.stages.get("frame_total")
    if run.kind != "serve" or not run.item_s or not total:
        return None
    return 1e3 * (sum(run.item_s) - total["total_s"]) / len(run.item_s)
