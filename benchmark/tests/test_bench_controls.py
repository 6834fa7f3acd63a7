"""The controls, at a size a test run holds: the reference put in the
program's place in the nearest precision below the configuration's must
come out not correct against each cell's limits. The CNN's control
(TF32) exists only on the card."""

import json

import pytest
import torch

from benchmark.core import spec
from benchmark.tests.tiny import TINY


def test_frame_control_fails_the_limits():
    from benchmark.controls import frame_control
    cell = spec.resolve("frame.union.mixed")
    r = frame_control.readings(cell, 5, torch.device("cpu"),
                               json.loads(json.dumps(TINY[cell.name])),
                               faults=("leaf", "pixel"))
    lim = cell.limits
    assert r["program"]["pixel_gap"] <= lim["pixel_gap"]
    assert r["program"]["xyz_err_m"] <= lim["xyz_err_m"]
    ctl = r["control"]
    assert ctl["pixel_gap"] > lim["pixel_gap"] or \
        ctl["xyz_err_m"] > lim["xyz_err_m"] or ctl["flags"] > 0
    assert r["fault_leaf"]["leaf_gap"] > lim["leaf_gap"]
    assert r["fault_pixel"]["pixel_gap"] > lim["pixel_gap"]


def test_vla_control_runs_and_rounds_every_matrix():
    from benchmark.controls import vla_control
    from benchmark.reference import llava_ref
    cell = spec.resolve("vla.anyres.bf16")
    r = vla_control.readings(cell, 3, torch.device("cpu"), ("fp8",),
                             json.loads(json.dumps(TINY[cell.name])))
    assert r["tokens"] > 0 and "control_fp8_token_gap" in r
    w = torch.linspace(-1, 1, 64).reshape(4, 16)
    q = llava_ref.Weights({"w": w, "b": w[0]}, "fp8")
    assert not torch.equal(q("w"), w)
    assert torch.equal(q("b"), w[0])        # vectors stay as they are
    assert (q("w") - w).abs().max() <= 2 ** -4


def test_control_gap_reads_the_token_the_control_puts_first():
    from benchmark.reference import llava_ref
    ref = torch.tensor([[[3.0, 1.0, 2.5]]])
    ctl = torch.tensor([[[0.0, 5.0, 1.0]]])
    assert llava_ref.control_gaps(ref, ctl).item() == 2.0
    assert llava_ref.token_gaps(ref, [[2]]).item() == 0.5


def test_train_fault_half_batch_fails_the_limits():
    from benchmark.controls import train_control
    cell = spec.resolve("cnn.train.b16")
    r = train_control.readings(cell, 3, torch.device("cpu"),
                               TINY[cell.name])
    lim = cell.limits
    assert all(r["program"][k] <= lim[k] for k in lim)
    assert any(r["fault_half_batch"][k] > lim[k] for k in lim)


@pytest.mark.cuda
def test_train_control_fails_the_limits_on_the_card(card):
    from benchmark.controls import train_control
    cell = spec.resolve("cnn.train.b16")
    r = train_control.readings(cell, 3, card, TINY[cell.name])
    lim = cell.limits
    assert any(r["control_tf32"][k] > lim[k] for k in lim)
