"""The EDT kernels' share of their roofline, in %: the least time of the
bytes their calls need (each field read once, each result written once,
``core.work``) at the HBM peak, over the kernels' device time by name
(``minplus_pass2_kernel``, ``rowband_kernel``,
``rowband_radius_kernel``) in the traced frames."""
from benchmark.core.peaks import HBM_BYTES_PER_S

KERNELS = ("minplus_pass2_kernel", "rowband_kernel", "rowband_radius_kernel")


def read(run):
    tr = run.trace
    nbytes = run.work.get("edt_bytes", 0.0)
    if tr is None or not nbytes:
        return None
    seconds = tr.kernel_seconds(*KERNELS)
    if seconds <= 0:
        return None
    return 100.0 * (nbytes / HBM_BYTES_PER_S) / seconds
