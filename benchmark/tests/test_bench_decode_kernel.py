"""The reader of the route of the VLA decode steps' attention
(``vla.decode_kernel_share``) on hand-built runs."""

import pytest

from benchmark.core.main import load_reader
from benchmark.core.record import Run


def _run(kind="serve", vla=(), frames=4):
    return Run(kind=kind, setup_s=1.0, window_s=1.0, attempted=frames,
               failed=0, memory_peak_bytes=0, item_s=[0.05] * frames,
               stages={}, vla=list(vla))


@pytest.mark.parametrize("routes,share", [
    (["kernel", "kernel", "plain", "kernel"], 75.0),
    (["kernel"] * 3, 100.0),
    (["plain"], 0.0)])
def test_decode_kernel_share_counts_the_kernel_reranks(routes, share):
    read = load_reader("vla.decode_kernel_share")
    lasts = [{"decode_ms": 80.0, "decode_attention": r} for r in routes]
    assert read(_run(vla=lasts)) == pytest.approx(share)


def test_decode_kernel_share_is_none_without_a_route():
    """A program without the kernel, or a decoder whose step keeps its
    own attention, records no route: the reader finds nothing."""
    read = load_reader("vla.decode_kernel_share")
    assert read(_run(vla=[{"decode_ms": 93.0,
                           "decode_graph": "replayed"}])) is None
    assert read(_run()) is None
    assert read(_run(kind="train", frames=0,
                     vla=[{"decode_attention": "kernel"}])) is None
