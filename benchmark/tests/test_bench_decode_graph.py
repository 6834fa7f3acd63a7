"""The reader of the VLA decode's route (``vla.decode_graph_share``) on
hand-built runs."""

import pytest

from benchmark.core.main import load_reader
from benchmark.core.record import Run


def _run(kind="serve", vla=(), frames=4):
    return Run(kind=kind, setup_s=1.0, window_s=1.0, attempted=frames,
               failed=0, memory_peak_bytes=0, item_s=[0.05] * frames,
               stages={}, vla=list(vla))


@pytest.mark.parametrize("routes,share", [
    (["captured", "replayed", "replayed", "replayed"], 75.0),
    (["replayed"] * 3, 100.0),
    (["captured", "eager"], 0.0)])
def test_decode_graph_share_counts_the_replayed_reranks(routes, share):
    read = load_reader("vla.decode_graph_share")
    lasts = [{"decode_ms": 150.0, "decode_graph": r} for r in routes]
    assert read(_run(vla=lasts)) == pytest.approx(share)


def test_decode_graph_share_is_none_without_a_route():
    read = load_reader("vla.decode_graph_share")
    assert read(_run(vla=[{"decode_ms": 300.0, "prefill_ms": 330.0}])) \
        is None
    assert read(_run()) is None
    assert read(_run(kind="train", frames=0,
                     vla=[{"decode_graph": "replayed"}])) is None
