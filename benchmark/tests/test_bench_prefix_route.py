"""The reader of the VLA prompt pass's route (``vla.prefix_shared_share``)
on hand-built runs."""

import pytest

from benchmark.core.main import load_reader
from benchmark.core.record import Run


def _run(kind="serve", vla=(), frames=4):
    return Run(kind=kind, setup_s=1.0, window_s=1.0, attempted=frames,
               failed=0, memory_peak_bytes=0, item_s=[0.05] * frames,
               stages={}, vla=list(vla))


@pytest.mark.parametrize("routes,share", [
    (["shared", "shared", "full", "shared"], 75.0),
    (["shared"] * 3, 100.0),
    (["full"], 0.0)])
def test_prefix_shared_share_counts_the_shared_reranks(routes, share):
    read = load_reader("vla.prefix_shared_share")
    lasts = [{"prefill_ms": 80.0, "prefill_route": r} for r in routes]
    assert read(_run(vla=lasts)) == pytest.approx(share)


def test_prefix_shared_share_is_none_without_a_route():
    read = load_reader("vla.prefix_shared_share")
    assert read(_run(vla=[{"prefill_ms": 330.0,
                           "decode_graph": "replayed"}])) is None
    assert read(_run()) is None
    assert read(_run(kind="train", frames=0,
                     vla=[{"prefill_route": "shared"}])) is None
