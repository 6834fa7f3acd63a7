"""Whole runs of each cell at a tiny size on the CPU, past the card
check: the last line's keys, the readers, the import guard, the exit
without a card and without the program."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.tests.tiny import ROOT, tiny_run
from benchmark.core import guard, spec

CELLS = ["frame.union.mixed", "vla.anyres.bf16", "cnn.train.b16"]
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("name", CELLS)
def test_tiny_run_line(name):
    run, limits, line = tiny_run(name)
    assert KEYS <= set(line)
    assert list(line)[-1] == "limits"
    assert line["correct"] is True, line["limits"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    # every end-to-end metric of the cell is read; one from a device
    # trace only where a device ran, so never on the CPU
    e2e = spec.resolve(name).end_to_end
    assert set(line["metrics"]) == {m["name"] for m in e2e
                                    if m["source"] == "host_clock"}
    assert "setup_s" in line["metrics"]
    if name == "cnn.train.b16":
        # the profiled tail runs in untraced runs too
        assert run.trace is not None and run.trace.items >= 1
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    json.dumps(line)


@pytest.mark.parametrize("name", ["frame.union.mixed", "cnn.train.b16"])
def test_tiny_traced_run_reads_its_layers(name):
    run, limits, line = tiny_run(name, trace=True)
    assert run.trace is not None and run.trace.items >= 1
    assert run.trace.window_s > 0
    names = set(line["metrics"])
    if name == "cnn.train.b16":
        assert {"mfu.train", "train.device_ops_per_step"} <= names
    else:
        assert {"service.ingest_ms", "frame.select_grasp_ms",
                "frame.host_reads"} <= names
    # no device ran here: device shares are left out, never 0
    assert "device.idle_share.serve" not in names or \
        line["metrics"]["device.idle_share.serve"]["value"] > 0


def test_tiny_vla_quantized_deployment(monkeypatch):
    """A configuration's ``quantize`` entry serves the program's int8
    decoder, and the reference rounds the same matrices."""
    from benchmark.core import spec
    from benchmark.models import llava_rerank
    built = []
    orig = llava_rerank.program_model

    def spy(cfg, state, quantize):
        model = orig(cfg, state, quantize)
        built.append(model.cfg.quantized)
        return model
    monkeypatch.setattr(llava_rerank, "program_model", spy)
    cell = spec.resolve("vla.anyres.bf16")
    cell.config = dict(cell.config, quantize={"bits": 8})
    _, _, line = tiny_run("vla.anyres.bf16", cell=cell)
    assert built == [True]
    assert line["correct"] is True, line["limits"]


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded(["leafgrasp_tpu_torch.ops",
                                   "jaxtyping", "flaxen"]) == []
    assert guard.forbidden_loaded(["jax.numpy", "leafgrasp_tpu.ops",
                                   "optax", "torch"]) == \
        ["jax.numpy", "leafgrasp_tpu.ops", "optax"]


def test_a_run_loads_no_jax(tmp_path):
    code = ("import sys, json; sys.path.insert(0, %r); "
            "from benchmark.tests.tiny import tiny_run; "
            "from benchmark.core import guard; "
            "tiny_run('vla.anyres.bf16'); tiny_run('cnn.train.b16'); "
            "print(json.dumps(guard.forbidden_loaded()))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(tmp_path),
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_exits_without_a_card():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "frame.union.mixed", "--seed", "4294967311", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_fails_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "frame.union.mixed", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300,
        cwd=str(tmp_path), env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
