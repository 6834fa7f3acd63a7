"""The readers of the program's spans and counters (``StageTimer``
stages, the scorer's ``last``) on hand-built runs: each reads its value,
and nothing from a run of the other kind or one without its stage."""

import pytest

from benchmark.core.main import load_reader
from benchmark.core.record import Run

FRAME_STAGES = {"frame.upload_ms": "upload",
                "frame.leaf_select_ms": "leaf_select",
                "frame.score_maps_ms": "score_maps",
                "frame.candidates_ms": "candidates",
                "frame.cnn_ms": "cnn", "frame.lift_ms": "lift",
                "frame.device_wait_ms": "device_wait",
                "service.fetch_ms": "fetch"}


def _run(kind="serve", stages=None, vla=(), frames=4):
    return Run(kind=kind, setup_s=1.0, window_s=1.0, attempted=frames,
               failed=0, memory_peak_bytes=0, item_s=[0.05] * frames,
               stages=dict(stages or {}), vla=list(vla))


def _st(total_s, count):
    return {"total_s": total_s, "count": count}


@pytest.mark.parametrize("name", sorted(FRAME_STAGES))
def test_frame_stage_readers_take_the_total_over_published_frames(name):
    read = load_reader(name)
    stage = FRAME_STAGES[name]
    # 4 frames, 6 calls (two re-picks): the total over the frames
    run = _run(stages={stage: _st(0.030, 6), "other": _st(9.0, 1)})
    assert read(run) == pytest.approx(7.5)
    assert read(_run(stages={"other": _st(9.0, 1)})) is None
    assert read(_run(kind="train", stages={stage: _st(0.030, 6)},
                     frames=0)) is None


def test_bus_reader_sums_push_and_pair():
    read = load_reader("service.bus_ms")
    both = {"bus_push": _st(0.008, 8), "bus_pair": _st(0.004, 4)}
    assert read(_run(stages=both)) == pytest.approx(3.0)
    assert read(_run(stages={"bus_push": _st(0.008, 8)})) \
        == pytest.approx(2.0)
    assert read(_run(stages={"fetch": _st(1.0, 4)})) is None
    assert read(_run(kind="train", stages=both, frames=0)) is None


def test_vla_encode_is_the_mean_over_reranks():
    read = load_reader("vla.encode_ms")
    lasts = [{"encode_ms": 40.0, "prefill_ms": 1.0},
             {"encode_ms": 60.0, "prefill_ms": 1.0}, {"prefill_ms": 1.0}]
    assert read(_run(vla=lasts)) == pytest.approx(50.0)
    assert read(_run(vla=[{"prefill_ms": 1.0}])) is None
    assert read(_run(kind="train", frames=0)) is None


def test_vla_decode_issue_is_the_loop_less_the_queued_prefill():
    read = load_reader("vla.decode_issue_ms")
    # 3 calls: loop 300 ms, prefill 320 ms on the device, 20 ms to issue
    stages = {"vla_decode": _st(0.9, 3), "vla_prefill": _st(0.06, 3)}
    lasts = [{"prefill_ms": 320.0}] * 3
    assert read(_run(stages=stages, vla=lasts)) == pytest.approx(0.0)
    # the host issues the prefill slower than the device runs it
    lasts = [{"prefill_ms": 10.0}] * 3
    assert read(_run(stages=stages, vla=lasts)) == pytest.approx(300.0)
    lasts = [{"prefill_ms": 120.0}] * 3
    assert read(_run(stages=stages, vla=lasts)) == pytest.approx(200.0)
    assert read(_run(stages={"vla_decode": _st(0.9, 3)}, vla=lasts)) is None
    assert read(_run(stages=stages)) is None
    assert read(_run(stages={"vla_rerank": _st(0.9, 3)}, vla=lasts)) is None
    assert read(_run(kind="train", stages=stages, vla=lasts,
                     frames=0)) is None


def test_vla_rerank_host_is_the_rerank_less_its_device_parts():
    read = load_reader("vla.rerank_host_ms")
    lasts = [{"encode_ms": 40.0, "prefill_ms": 300.0, "decode_ms": 350.0},
             {"encode_ms": 60.0, "prefill_ms": 320.0, "decode_ms": 370.0}]
    stages = {"vla_rerank": _st(1.6, 2)}
    assert read(_run(stages=stages, vla=lasts)) == pytest.approx(80.0)
    # no device timings (the CPU), or no rerank stage: nothing to read
    assert read(_run(stages=stages,
                     vla=[{"prefill_ms": 1.0, "decode_ms": 1.0}])) is None
    assert read(_run(vla=lasts)) is None
    assert read(_run(kind="train", stages=stages, vla=lasts,
                     frames=0)) is None
