"""The port's render, angle-QA and row-sharded demo tools on the CPU.

* ``render_sample_torch`` renders the committed artifacts/
  sample_composite.png (made by the JAX tool) pixel for pixel.
* ``angle_quantifier_shell_torch --clicks`` gives the JAX shell's rows
  on the same clicks, on a synthetic scene and on a frame of a framelog
  recording (``--replay``): leaf and validity equal, the angles within
  1e-3 degrees, the bound of tests/test_torch_service.py's
  ``angle_error`` check (the orientation's f32 moments sum in another
  order: 2.1e-5 degrees read here).
* ``examples/run_spatial_demo_torch.py`` on two gloo ranks: the
  row-sharded frame equals ``make_frame_fn``'s (leaf, pixel, 3D point).
"""

import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from tools import angle_quantifier_shell_torch as shell_t  # noqa: E402
from tools import render_sample_torch as render_t  # noqa: E402
from tests._torch_threads import one_torch_thread  # noqa: F401,E402
from tests.test_torch_tools_eval import jax_tool  # noqa: E402

ANGLE_TOL = 1e-3


def test_render_sample_gives_the_committed_png(tmp_path):
    from PIL import Image
    out = render_t.main(["--device", "cpu", "--out",
                         str(tmp_path / "s.png")])
    got = np.asarray(Image.open(tmp_path / "s.png"))
    want = np.asarray(Image.open(os.path.join(ROOT, "artifacts",
                                              "sample_composite.png")))
    assert out["shape"] == list(want.shape) == [1080, 2880, 3]
    np.testing.assert_array_equal(got, want)


def _clicks():
    """A slanted pair across each leaf's centroid of the seed-8 scene
    (both tools' synthetic frame, and the recording's second frame),
    and one pair off every leaf."""
    from leafgrasp_tpu_torch.io.scenes import make_leaf_scene
    mask, _ = make_leaf_scene(1080, 1440, num_leaves=6, seed=8, margin=120)
    pairs = []
    for leaf in np.unique(mask[mask > 0]):
        ys, xs = np.nonzero(mask == leaf)
        cx, cy = int(xs.mean()), int(ys.mean())
        pairs.append([[cx - 30, cy - 8], [cx + 30, cy + 8]])
    return pairs + [[[5, 5], [15, 9]]]


def _rows_match(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a["leaf_id"] == b["leaf_id"]
        assert a["valid"] == b["valid"]
        for key in ("manual_deg", "estimated_deg", "error_deg"):
            assert (key in a) == (key in b)
            if key in a:
                assert abs(a[key] - b[key]) <= ANGLE_TOL, key


@pytest.mark.parametrize("replay", [False, True],
                         ids=["synthetic", "replay"])
def test_angle_shell_gives_the_jax_shells_rows(tmp_path, replay):
    from leafgrasp_tpu_torch.io.framelog import FrameLogWriter
    from leafgrasp_tpu_torch.io.scenes import make_leaf_scene
    clicks = tmp_path / "clicks.json"
    clicks.write_text(json.dumps(_clicks()))
    argv = ["--clicks", str(clicks)]
    if replay:
        log = str(tmp_path / "session.flog")
        writer = FrameLogWriter(log, 1080, 1440)
        for seed in (3, 8):
            mask, depth = make_leaf_scene(1080, 1440, num_leaves=6,
                                          seed=seed, margin=120)
            writer.append(mask.astype(np.int16), depth, seed)
        writer.close()
        argv += ["--replay", log, "--frame-index", "1"]
    got = shell_t.main(argv + ["--out", str(tmp_path / "torch.json")])
    with jax_tool("tools.angle_quantifier_shell",
                  argv + ["--out", str(tmp_path / "jax.json")]) as tool:
        if not replay:
            tool.main()
            with open(tmp_path / "jax.json") as f:
                want = json.load(f)["annotations"]
            assert got["source"] == "synthetic seed=8 leaves=6"
        else:
            # the JAX shell's --replay indexes its reader (rd[i]), which
            # has no __getitem__ (ROADMAP C): its session runs on the
            # frame read through FrameLogReader.frame
            from leafgrasp_tpu.io.framelog import FrameLogReader
            with FrameLogReader(log) as rd:
                mask = np.array(rd.frame(1)[0])
            want = tool.session(mask, [tuple(map(tuple, p))
                                       for p in _clicks()])
            assert got["source"] == f"framelog:{log}[1]"
    assert got["annotated"] == sum(r["valid"] for r in want) == 6
    _rows_match(got["annotations"], want)


def test_spatial_demo_equals_the_single_device_frame():
    from examples import run_spatial_demo_torch as demo
    out = demo.main(["--device", "cpu", "--ranks", "2"])
    assert out["equal"] and out["frame"] == [1080, 360]
    assert out["sharded"]["found"] and out["collectives"] > 0
