"""BENCHMARK.json against the contract the harness is built to: names,
units, files found by name, and that every cell that reports a per-layer
metric reports the end-to-end metric it moves."""

import json
import os
import re

import pytest

from hrbench import run as hr

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
MAN = hr.load_manifest()
CELLS = [w["name"] for w in MAN["workloads"]]


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
    assert len(set(names)) == len(names)
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200


def test_bounds():
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_what_its_layer_metrics_move(cell):
    e2e = {m["name"] for m in hr.metrics_of(MAN, cell, "end_to_end")}
    layer = hr.metrics_of(MAN, cell, "per_layer")
    assert "setup_s" in e2e and len(e2e) >= 2
    assert layer
    for m in layer:
        assert m["moves"] in e2e, (cell, m["name"], m["moves"])


def test_listed_cells_exist():
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        for w in m.get("workloads", []):
            assert w in CELLS, (m["name"], w)


def test_files_are_found_by_name():
    root = hr.ROOT
    for c in MAN["configs"]:
        with open(os.path.join(root, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"]
        assert conf["reduced"] == c["reduced"]
        assert c["file"].startswith(MAN["paths"][0] + "/")
    for w in MAN["workloads"]:
        assert os.path.exists(os.path.join(hr.HERE, "traffic", w["traffic"] + ".json"))
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert callable(hr.reader(m["name"]))


def test_a_layer_metric_without_workloads_goes_to_every_cell_of_its_moves():
    man = {"end_to_end": [{"name": "a", "workloads": ["x"]}, {"name": "s"}],
           "per_layer": [{"name": "l", "moves": "a"}, {"name": "k", "moves": "s"}]}
    assert [m["name"] for m in hr.metrics_of(man, "x", "per_layer")] == ["l", "k"]
    assert [m["name"] for m in hr.metrics_of(man, "y", "per_layer")] == ["k"]
