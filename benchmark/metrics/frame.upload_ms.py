"""``StageTimer`` ``upload``, one of ``pipeline/frame.py``
``select_grasp``'s six spans (host clock): the mask, the depth and the
camera scalars to the device. The window's total over its published
frames, in ms; in the rerank's cell it holds the re-pick's second
frame-function call too."""


def read(run):
    st = run.stages.get("upload")
    if run.kind != "serve" or not run.item_s or not st:
        return None
    return 1e3 * st["total_s"] / len(run.item_s)
