"""On the card: one short run of the headline cell and of the float cell, and
each one's control against the port at the cell's own size. Skipped where no
CUDA card is visible."""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")


@pytest.mark.cuda
def test_headline_cell_runs_correct_on_the_card():
    _need_card()
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "rgb4k-b32-s10",
                          "--seed", str(2**31 + 901), "--seconds", "2", "--trace", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=1300)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
    assert list(result)[-1] == "checks"


@pytest.mark.cuda
def test_control_fails_where_the_port_passes_on_the_card():
    _need_card()
    out = subprocess.run([sys.executable, "portbench/control.py", "--workload", "rgb4k-b32-s10",
                          "--seeds", str(2**31 + 902), "--control-seeds", str(2**31 + 903)],
                         cwd=ROOT, capture_output=True, text=True, timeout=1300)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [json.loads(x) for x in out.stdout.strip().splitlines()]
    limits = json.loads((ROOT / "portbench/checks/rgb4k-b32-s10.json").read_text())
    program = [x for x in lines if x["side"] == "program"]
    control = [x for x in lines if x["side"] != "program"]
    assert program and control
    assert all(x[name] <= c["limit"] for x in program for name, c in limits.items())
    # the control goes through a whole run's comparison and reads not correct
    assert all(not x["correct"] and not x["checks"]["mismatch_pct"]["passed"] for x in control)


@pytest.mark.cuda
def test_float_cell_runs_correct_and_its_control_fails_on_the_card():
    _need_card()
    cell = "float4k-b4-s10-fwdbwd"
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell,
                          "--seed", str(2**31 + 904), "--seconds", "2", "--trace", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=1300)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["busy_s"] > 0
    assert {"route_ms_per_call", "program_idle_ms_per_call"} <= set(result["metrics"])
    out = subprocess.run([sys.executable, "portbench/control.py", "--workload", cell,
                          "--seeds", str(2**31 + 905), "--control-seeds", str(2**31 + 906)],
                         cwd=ROOT, capture_output=True, text=True, timeout=1300)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [json.loads(x) for x in out.stdout.strip().splitlines()]
    limits = json.loads((ROOT / f"portbench/checks/{cell}.json").read_text())
    program = [x for x in lines if x["side"] == "program"]
    control = [x for x in lines if x["side"] != "program"]
    assert program and control
    assert all(x[name] <= c["limit"] for x in program for name, c in limits.items())
    # the TF32 control goes through a whole run's comparison and reads not correct
    assert all(not x["correct"] and not x["checks"]["max_abs_err"]["passed"] for x in control)
