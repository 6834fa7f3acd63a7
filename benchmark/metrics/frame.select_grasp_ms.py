"""``StageTimer`` ``select_grasp`` (the frame function, host clock), the
mean over the window's calls, in ms."""


def read(run):
    st = run.stages.get("select_grasp")
    if run.kind != "serve" or not st or not st["count"]:
        return None
    return 1e3 * st["total_s"] / st["count"]
