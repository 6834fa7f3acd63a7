"""Blocking host reads (``utils.device.host_reads``) a published frame."""


def read(run):
    if run.kind != "serve" or not run.item_s:
        return None
    return run.host_reads / len(run.item_s)
