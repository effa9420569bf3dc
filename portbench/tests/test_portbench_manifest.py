"""The manifest (``BENCHMARK.json``) against the benchmark's contract, and the
files each cell resolves to."""

from __future__ import annotations

import json
import pathlib
import re

import pytest

from portbench import harness, manifest as manifest_mod

ROOT = pathlib.Path(__file__).resolve().parents[2]
DATA = json.loads((ROOT / "BENCHMARK.json").read_text())
MAN = manifest_mod.load()
E2E = {m["name"] for m in DATA["end_to_end"]}
CELLS = [w["name"] for w in DATA["workloads"]]
LINE = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in DATA[key]:
            yield entry["name"]
    for w in DATA["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in DATA["configs"]:
        yield from c["reduced"]


def test_top_level_keys_and_paths():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= len(DATA["paths"]) <= 16 and len(DATA["command"]) <= 32
    for p in DATA["paths"]:
        assert PATH.match(p) and ".." not in p.split("/") and not p.startswith("/")
        assert (ROOT / p).is_dir()
    for word in DATA["command"]:
        assert LINE.match(word) and not word.startswith("/") and ".." not in word.split("/")
        if "/" in word:
            assert any(word.startswith(p + "/") for p in DATA["paths"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_names_use_allowed_characters(name):
    assert manifest_mod.NAME_RE.match(name), name


def test_names_unique_and_units_allowed():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in DATA[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in DATA["end_to_end"] + DATA["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in DATA["end_to_end"] + DATA["per_layer"]:
        assert manifest_mod.UNIT_RE.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")


def test_entry_keys_and_limits():
    for c in DATA["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in DATA["paths"]))
    assert len({c["file"] for c in DATA["configs"]}) == len(DATA["configs"])
    pairs = [(w["config"], w["traffic"]) for w in DATA["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in DATA["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
    for m in DATA["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in DATA["end_to_end"]} >= {"setup_s"}
    for m in DATA["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert LINE.match(m["layer"])
    assert 1 <= DATA["run_seconds"] <= 51


def test_run_seconds_fit_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    assert runs * (DATA["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_resolve(cell):
    c = MAN.cell(cell)
    w = MAN.workload(cell)
    assert MAN.config_path(w["config"]).is_file()
    assert MAN.traffic_path(w["traffic"]).is_file()
    assert c.config["name"] == w["config"]
    for key in ("batch", "height", "width", "channels"):
        assert int(c.config[key]) >= 1
    assert c.config["reduced"] == MAN.config_entry(w["config"])["reduced"]
    # the numbers the cell's entry judges (reference.Judgement, FloatJudgement)
    if harness.entry_name(c.traffic) == "blur":
        assert c.config["dtype"] == "float32" and c.config["layout"] == "BCHW"
        want = {"max_abs_err"} | ({"grad_max_abs_err"} if c.traffic.get("backward") else set())
        assert set(c.checks) == want
    else:
        assert c.config["dtype"] == "uint8" and c.config["layout"] == "BHWC"
        assert {"mismatch_pct", "worst_count_diff"} <= set(c.checks)
    for check in c.checks.values():
        assert float(check["limit"]) >= 0
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in DATA["end_to_end"] + DATA["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(MAN.reader(metric))


@pytest.mark.parametrize("metric", [m["name"] for m in DATA["per_layer"]])
def test_moves_names_an_end_to_end_metric_each_of_its_cells_reports(metric):
    entry = next(m for m in DATA["per_layer"] if m["name"] == metric)
    assert entry["moves"] in E2E
    for cell in entry.get("workloads", CELLS):
        c = MAN.cell(cell)
        assert entry["moves"] in {m["name"] for m in c.end_to_end}
        assert metric in {m["name"] for m in c.per_layer}


def test_layers_are_named_alike():
    layers = {}
    for m in DATA["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
