#!/usr/bin/env python3
"""Interleaved A/B of the port's two EDT pass-2 routes: the counterpart
of tools/micro_bench_edt_ab.py, under its definitions.

On the ``sparse`` bench scene at 1080 x 1440 (6 leaves, seed 8), three
seed channels (background, all leaves, everything but leaf 3), timed in
turns in one process:

  banded_x3            one vertical pass 1, then ``squared_edt`` a
                       channel: the banded min-plus (K3/K4), as the JAX
                       package's ``edt_batch`` (the JAX tool's
                       ``xla_banded_x3``)
  rowband_x3           ``edt_batch``: horizontal pass 1, the row-banded
                       kernel (K5) over all channels in one launch (the
                       JAX tool's ``rowband_x3``; the port's
                       ``edt_batch_rowband`` is the same function)
  pass1_transposed_scan, pass1_vertical_scan
                       the two pass-1 scans alone
  rowband_kernel_only  K5 alone on the horizontal pass-1 field

The two routes' distances must be bit-equal (exact integer squared
distances, one correctly rounded root), else the tool raises. Each row:
``--trials`` times ``--reps`` calls back to back between CUDA events
(``torch.cuda.synchronize()`` as the barrier), min and median a call,
and the launches and host reads of one call.

Prints the JAX tool's lines, then one JSON line with the same numbers
and ``device`` (the card's name and power limit).

    python tools/micro_bench_edt_ab_torch.py [--trials 5 --reps 20]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from tools._torch_bench import device_stamp, event_ms, one_call  # noqa: E402
from tools._torch_eval import add_device_arg, setup_device  # noqa: E402

H, W = 1080, 1440
SCENE = dict(num_leaves=6, seed=8, margin=120)
LEAF = 3


def seed_channels(mask, dev):
    """(3, H, W) bool seeds: background, all leaves, all but LEAF."""
    import torch
    m = torch.as_tensor(mask).to(dev)
    return torch.stack([m == 0, m > 0, m != LEAF])


def banded_x3(seeds):
    """The K3/K4 route: one vertical pass 1, the banded min-plus a
    channel, one rounding of each root."""
    import torch
    from leafgrasp_tpu_torch.ops.edt import (exact_sqrt,
                                             nearest_seed_dist_1d,
                                             squared_edt)
    g = nearest_seed_dist_1d(seeds, axis=1).to(torch.float32)
    g2 = g * g
    return torch.stack([exact_sqrt(squared_edt(seeds[c], g2=g2[c]))
                        for c in range(seeds.shape[0])])


def pass1_transposed(seeds):
    """Horizontal squared pass 1 through the transposed layout (the JAX
    tool's ``pass1_t``)."""
    import torch
    from leafgrasp_tpu_torch.ops.edt import nearest_seed_dist_1d
    g = nearest_seed_dist_1d(seeds.transpose(1, 2), axis=1)
    return g.transpose(1, 2).to(torch.float32) ** 2


def pass1_vertical(seeds):
    import torch
    from leafgrasp_tpu_torch.ops.edt import nearest_seed_dist_1d
    g = nearest_seed_dist_1d(seeds, axis=1).to(torch.float32)
    return g * g


def routes(seeds):
    """{row: zero-argument call} of the JAX tool's five rows."""
    from leafgrasp_tpu_torch.kernels.rowband import squared_edt_rowband
    from leafgrasp_tpu_torch.ops.edt import edt_batch
    g2r = pass1_transposed(seeds).contiguous()
    return {"banded_x3": lambda: banded_x3(seeds),
            "rowband_x3": lambda: edt_batch(seeds),
            "pass1_transposed_scan": lambda: pass1_transposed(seeds),
            "pass1_vertical_scan": lambda: pass1_vertical(seeds),
            "rowband_kernel_only(prepass+kernel)":
                lambda: squared_edt_rowband(g2r)}


def measure(seeds, dev, trials: int, reps: int):
    """({row: [ms a call of each trial]}, {row: one call's record},
    {row: output}); raises unless the two routes agree bit for bit."""
    import torch
    fns = routes(seeds)
    calls, outs = {}, {}
    for name, fn in fns.items():        # warm-up, counts, outputs
        fn()
        calls[name], outs[name] = one_call(fn, dev)
    a, b = outs["banded_x3"], outs["rowband_x3"]
    if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
        bad = int((a != b).sum())
        raise RuntimeError(f"the banded and row-banded routes differ at "
                           f"{bad} pixels")
    results = {name: [] for name in fns}
    for _ in range(trials):
        for name, fn in fns.items():
            results[name].append(event_ms(fn, dev, reps))
    return results, calls, outs


def main(argv=None):
    """Run the A/B and print its lines and record; returns the record."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = setup_device(args.device)

    from leafgrasp_tpu_torch.io.scenes import make_leaf_scene
    mask, _ = make_leaf_scene(H, W, **SCENE)
    results, calls, _ = measure(seed_channels(mask, dev), dev, args.trials,
                                args.reps)
    rows = {}
    for name, v in results.items():
        med = sorted(v)[len(v) // 2]
        rows[name] = {"min_ms": min(v), "median_ms": med,
                      **{k: calls[name][k]
                         for k in ("launches", "host_reads")}}
        print(f"{name:40s} min {min(v):7.3f}  med {med:7.3f} ms",
              flush=True)
    rec = {"tool": "micro_bench_edt_ab", "trials": args.trials,
           "reps": args.reps, "routes_bit_equal": True, "rows": rows,
           "device": device_stamp(dev)}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
