"""A whole run, past the harness's look for a card, with the timed path
sound and then broken underneath: ``correct`` has to come out true for the
port and false for each fault a cell can have."""

from __future__ import annotations

import dataclasses
import time

import pytest
import torch

from portbench import harness, manifest as manifest_mod

MAN = manifest_mod.load()


def _tiny(cell_name: str, batch: int = 2):
    """The cell with its frames cut to a size a test run holds (its sigma
    kept where the frame holds its taps, else 4)."""
    cell = MAN.cell(cell_name)
    cfg = dict(cell.config, batch=batch, height=72, width=96)
    traffic = dict(cell.traffic)
    if harness.sigma_of(traffic, cell.config) > 10:
        traffic.pop("sigma_rule", None)
        traffic["sigma"] = 4.0
    traffic["trace_seconds"] = 0.05
    return dataclasses.replace(cell, config=cfg, traffic=traffic)


def _run(cell, blur_u8=None, trace=False):
    torch.set_num_threads(2)
    return harness.run_cell(MAN, cell, 2**31 + 77, 0.3, trace, "cpu", time.perf_counter(),
                            blur_u8=blur_u8)


def _port():
    from blur_algorithms_tpu_torch.api import blur_u8

    return blur_u8


@pytest.mark.parametrize("cell", ["rgb4k-b32-s10", "photo24k-sqrtw"])
@pytest.mark.parametrize("trace", [False, True])
def test_the_port_runs_correct(cell, trace):
    result, compared = _run(_tiny(cell), _port(), trace)
    assert result["correct"], compared
    assert result["attempted"] >= 2 and result["failed"] == 0
    names = {m["name"] for m in (MAN.cell(cell).per_layer if trace else MAN.cell(cell).end_to_end)}
    assert set(result["metrics"]) <= names
    if not trace:
        assert {"mp_per_s", "call_ms_p95", "setup_s"} <= set(result["metrics"])
    assert [c[0] for c in compared][-1] == "failed_calls"


def _unchanged(img, sigma, engine="auto"):
    """A step that returns its state unchanged."""
    return img.clone()


def _half_batch(img, sigma, engine="auto"):
    """Half the batch left out: the first half blurred, the rest unchanged."""
    out = img.clone()
    half = img.shape[0] // 2
    out[:half] = _port()(img[:half], sigma, engine=engine)
    return out


def _altered(img, sigma, engine="auto"):
    """An answer altered where it is produced: one value three counts off."""
    out = _port()(img, sigma, engine=engine)
    v = int(out[0, 3, 5, 1])
    out[0, 3, 5, 1] = v + 3 if v < 250 else v - 3
    return out


class _Raises:
    """Calls that raise in the window (the warm-up calls pass)."""

    def __init__(self):
        self.calls = 0
        self.__name__ = "raises"

    def __call__(self, img, sigma, engine="auto"):
        self.calls += 1
        if self.calls > 2:
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return _port()(img, sigma, engine=engine)


def _wrong_shape(img, sigma, engine="auto"):
    return _port()(img, sigma, engine=engine)[..., :2]


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered, "raises", _wrong_shape])
def test_a_broken_timed_path_reads_not_correct(fault):
    fault = _Raises() if fault == "raises" else fault
    result, compared = _run(_tiny("rgb4k-b32-s10"), fault)
    assert not result["correct"], (fault.__name__, compared)
    assert any(not ok for *_, ok in compared)


@pytest.mark.parametrize("cell", [w["name"] for w in MAN.data["workloads"]])
def test_the_control_in_the_port_place_reads_not_correct(cell):
    """The control (the reference in float8 e4m3, the step below the
    configurations' bfloat16) through a whole run of the cell's comparison."""
    from portbench import reference

    def control(img, sigma, engine="auto"):
        return reference.blur_lower_precision(img, sigma, reference.CONTROL_DTYPE)

    result, compared = _run(_tiny(cell), control)
    assert not result["correct"]
    passed = dict((c[0], c[3]) for c in compared)
    assert passed["mismatch_pct"] is False and passed["worst_count_diff"] is False
