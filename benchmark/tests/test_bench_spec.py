"""BENCHMARK.json against the contract: every entry resolves to its
files, names and units are in the allowed characters, and each metric
is reported where it says it is."""

import json
import os
import re

import pytest

from benchmark.core import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = spec.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_unique_and_allowed(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


def test_metric_units_and_sources():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])


def test_every_file_resolves():
    for c in SPEC["configs"]:
        assert os.path.isfile(os.path.join(spec.ROOT, c["file"]))
        assert c["file"].startswith("benchmark/")
        assert len(c["reduced"]) <= 16
    for w in SPEC["workloads"]:
        assert w["chips"] in (1, 4)
        assert os.path.isfile(spec.traffic_path(w["traffic"]))
        assert os.path.isfile(spec.limits_path(w["name"]))
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for path in spec.metric_files(SPEC).values():
        assert os.path.isfile(path), path


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_setup_another_e2e_and_a_layer(cell):
    c = spec.resolve(cell, SPEC)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names, (cell, m["name"])


def test_layer_names_and_moves():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        for w in m.get("workloads", []):
            assert w in CELLS


def test_file_names_use_name_characters():
    for dirpath, dirnames, files in os.walk(spec.HERE):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in files:
            assert re.match(r"^[A-Za-z0-9_.-]+$", f), f
