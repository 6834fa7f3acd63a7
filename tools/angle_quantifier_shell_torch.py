#!/usr/bin/env python3
"""Click-to-annotate leaf-angle QA shell on the PyTorch port: the
counterpart of tools/angle_quantifier_shell.py (the reference's
scripts/leaf_angle_quantifier.py:36-78).

Each pair of clicks along a leaf's midrib is one annotation: the leaf is
read at the clicks' midpoint (the reference's rule), and the manual line
angle is compared with the port's estimated major-axis angle
(``io/tools.angle_error``), folded into [0, 90] degrees.

* ``--clicks FILE`` (headless): a JSON list of click pairs
  ``[[[x1, y1], [x2, y2]], ...]``;
* without it (needs a display and matplotlib): the golden-ratio palette
  view of the mask (the visualizer's ``generate_color``), two clicks an
  annotation, close the window to finish.

Frame source: ``--replay`` a framelog recording (``io/framelog.py``, a
GraspService session) or a synthetic scene (``--seed``/``--leaves``).

    python tools/angle_quantifier_shell_torch.py --clicks clicks.json
    python tools/angle_quantifier_shell_torch.py --replay session.flog \\
        --clicks clicks.json

Writes the per-annotation rows and their mean and largest error to
``--out`` (default build/artifacts_torch/angle_qa.json); the last
stdout line is the JSON summary.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from tools._torch_eval import OUT_DIR, write_json  # noqa: E402


def mask_view(mask: np.ndarray) -> np.ndarray:
    """Golden-ratio palette render of the instance mask (the reference
    quantifier's create_mask_visualization)."""
    from leafgrasp_tpu_torch.pipeline.visualizer import generate_color
    vis = np.zeros(mask.shape + (3,), np.uint8)
    for i, orig in enumerate(np.unique(mask[mask > 0]), start=1):
        vis[mask == orig] = generate_color(i)
    return vis


def annotate(mask: np.ndarray, pair) -> dict:
    """One annotation: the leaf at the click midpoint
    (leaf_angle_quantifier.py:53-56), its manual against its estimated
    angle."""
    from leafgrasp_tpu_torch.io.tools import angle_error
    (x1, y1), (x2, y2) = pair
    mx = int(round((x1 + x2) / 2))
    my = int(round((y1 + y2) / 2))
    h, w = mask.shape
    if not (0 <= my < h and 0 <= mx < w) or mask[my, mx] <= 0:
        return dict(leaf_id=0, valid=False,
                    note="click midpoint not on a leaf")
    leaf_id = int(mask[my, mx])
    r = angle_error(mask == leaf_id, ((x1, y1), (x2, y2)))
    r["leaf_id"] = leaf_id
    return r


def session(mask: np.ndarray, pairs) -> list:
    rows = []
    for pair in pairs:
        r = annotate(mask, pair)
        rows.append(r)
        if r.get("valid"):
            print(f"Leaf {r['leaf_id']}: manual {r['manual_deg']:.1f} "
                  f"deg, estimated {r['estimated_deg']:.1f} deg, "
                  f"difference {r['error_deg']:.1f} deg", flush=True)
        else:
            print(f"skipped: {r.get('note', 'degenerate leaf')}",
                  flush=True)
    return rows


def interactive_pairs(view):
    """Click pairs from a matplotlib window until it closes."""
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(12, 9))
    ax.imshow(view)
    ax.set_title("click 2 points along a midrib (close window to end)")
    while plt.fignum_exists(fig.number):
        pts = fig.ginput(2, timeout=0)
        if len(pts) < 2:
            break
        ax.plot([pts[0][0], pts[1][0]], [pts[0][1], pts[1][1]],
                "g-o", linewidth=2)
        fig.canvas.draw_idle()
        yield pts[0], pts[1]
    plt.close(fig)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clicks", default=None,
                    help="JSON [[[x1,y1],[x2,y2]], ...] -> headless")
    ap.add_argument("--replay", default=None,
                    help="framelog recording; annotate one of its frames")
    ap.add_argument("--frame-index", type=int, default=0)
    ap.add_argument("--seed", type=int, default=8)
    ap.add_argument("--leaves", type=int, default=6)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1440)
    ap.add_argument("--out", default=os.path.join(OUT_DIR, "angle_qa.json"))
    args = ap.parse_args(argv)

    if args.replay:
        from leafgrasp_tpu_torch.io.framelog import FrameLogReader
        with FrameLogReader(args.replay) as rd:
            mask = np.array(rd.frame(args.frame_index)[0])
        source = f"framelog:{args.replay}[{args.frame_index}]"
    else:
        from leafgrasp_tpu_torch.io.scenes import make_leaf_scene
        mask, _ = make_leaf_scene(args.height, args.width,
                                  num_leaves=args.leaves, seed=args.seed,
                                  margin=120)
        source = f"synthetic seed={args.seed} leaves={args.leaves}"

    if args.clicks:
        with open(args.clicks) as f:
            pairs = [tuple(map(tuple, p)) for p in json.load(f)]
        rows = session(mask, pairs)
    else:
        rows = session(mask, interactive_pairs(mask_view(mask)))

    errs = [r["error_deg"] for r in rows if r.get("valid")]
    summary = dict(source=source, annotations=rows, annotated=len(errs),
                   mean_error_deg=round(float(np.mean(errs)), 2)
                   if errs else None,
                   max_error_deg=round(float(np.max(errs)), 2)
                   if errs else None)
    write_json(args.out, summary)
    print(json.dumps({k: v for k, v in summary.items()
                      if k != "annotations"}))
    return summary


if __name__ == "__main__":
    main()
