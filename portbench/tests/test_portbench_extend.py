"""A configuration, a traffic mix, a cell and a metric added as new files and
manifest entries alone, in a temporary copy of the benchmark, are found by
name and run, with no edit to a file that is there: a ``blur_u8`` cell, and
float ``blur`` cells forward and forward + backward."""

from __future__ import annotations

import json
import pathlib
import shutil
import time

import pytest
import torch

from portbench import harness, manifest as manifest_mod

ROOT = pathlib.Path(__file__).resolve().parents[2]


def test_new_files_and_entries_are_picked_up(tmp_path):
    base = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", base, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(base): p.read_bytes() for p in base.rglob("*") if p.is_file()}
    data = json.loads((ROOT / "BENCHMARK.json").read_text())

    (base / "configs" / "tiny-b2.json").write_text(json.dumps({
        "name": "tiny-b2", "source": "a test", "batch": 2, "height": 40, "width": 56,
        "channels": 3, "dtype": "uint8", "layout": "BHWC", "assumed": {}, "reduced": []}))
    (base / "traffic" / "s3.json").write_text(json.dumps({
        "entry": "blur_u8", "engine": "auto", "sigma": 3.0, "loop": "closed", "clients": 1,
        "pool": 2, "warmup_calls": 1, "samples": 1, "trace_seconds": 0.05}))
    (base / "checks" / "tiny-b2-s3.json").write_text(json.dumps({
        "mismatch_pct": {"limit": 5.0}, "worst_count_diff": {"limit": 1}}))
    (base / "metrics" / "calls_per_s.py").write_text(
        "def read(ctx):\n    return len(ctx.window.calls) / ctx.window.seconds\n")
    data["configs"].append({"name": "tiny-b2", "source": "a test",
                            "file": "portbench/configs/tiny-b2.json", "reduced": [],
                            "why": "a test"})
    data["workloads"].append({"name": "tiny-b2-s3", "config": "tiny-b2", "traffic": "s3",
                              "chips": 1, "why": "a test"})
    data["end_to_end"].append({"name": "calls_per_s", "unit": "1/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock",
                               "workloads": ["tiny-b2-s3"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))

    after = {p.relative_to(base): p.read_bytes() for p in base.rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())  # nothing there was edited

    man = manifest_mod.load(tmp_path / "BENCHMARK.json", base)
    cell = man.cell("tiny-b2-s3")
    assert cell.config["height"] == 40 and cell.traffic["sigma"] == 3.0
    assert "calls_per_s" in {m["name"] for m in cell.end_to_end}
    assert "calls_per_s" not in {m["name"] for m in man.cell("rgb4k-b32-s10").end_to_end}

    from blur_algorithms_tpu_torch.api import blur_u8

    torch.set_num_threads(2)
    result, compared = harness.run_cell(man, cell, 5, 0.2, False, "cpu", time.perf_counter(),
                                        fn=blur_u8)
    assert result["correct"], compared
    assert result["metrics"]["calls_per_s"]["value"] > 0
    assert result["metrics"]["calls_per_s"]["unit"] == "1/s"


@pytest.mark.parametrize("backward", [False, True])
def test_a_float_blur_cell_is_added_as_files_alone(tmp_path, backward):
    base = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", base, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(base): p.read_bytes() for p in base.rglob("*") if p.is_file()}
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    traffic = "s4-fwdbwd" if backward else "s4-fwd"
    checks = {"max_abs_err": {"limit": 3e-3}}
    if backward:
        checks["grad_max_abs_err"] = {"limit": 1e-5}

    (base / "configs" / "tinyf-b2.json").write_text(json.dumps({
        "name": "tinyf-b2", "source": "a test", "batch": 2, "height": 36, "width": 52,
        "channels": 3, "dtype": "float32", "layout": "BCHW", "precision": "float32",
        "assumed": {}, "reduced": []}))
    (base / "traffic" / f"{traffic}.json").write_text(json.dumps({
        "entry": "blur", "backward": backward, "engine": "auto", "sigma": 4.0,
        "loop": "closed", "clients": 1, "pool": 2, "warmup_calls": 1, "samples": 2,
        "trace_seconds": 0.05}))
    (base / "checks" / f"tinyf-b2-{traffic}.json").write_text(json.dumps(checks))
    data["configs"].append({"name": "tinyf-b2", "source": "a test",
                            "file": "portbench/configs/tinyf-b2.json", "reduced": [],
                            "why": "a test"})
    data["workloads"].append({"name": f"tinyf-b2-{traffic}", "config": "tinyf-b2",
                              "traffic": traffic, "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))

    after = {p.relative_to(base): p.read_bytes() for p in base.rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())  # nothing there was edited

    man = manifest_mod.load(tmp_path / "BENCHMARK.json", base)
    cell = man.cell(f"tinyf-b2-{traffic}")
    torch.set_num_threads(2)
    result, compared = harness.run_cell(man, cell, 2**31 + 5, 0.2, False, "cpu",
                                        time.perf_counter())
    assert result["correct"], compared
    assert [c[0] for c in compared] == [*checks, "failed_calls"]
    assert result["judged"]["values"] == 2 * 2 * 3 * 36 * 52
    assert result["metrics"]["mp_per_s"]["value"] > 0
