"""The plain reference against a direct float64 convolution, its judgement,
and the bfloat16 control failing each cell's limit at a size a test run
holds."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from portbench import frames, harness, manifest as manifest_mod, reference

MAN = manifest_mod.load()
CELLS = [w["name"] for w in MAN.data["workloads"]]


def _direct(planes: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """Separable correlation in float64 with reflect-101 borders, tap by
    tap (rows, then columns)."""
    r = (len(taps) - 1) // 2
    x = planes.astype(np.float64)
    for axis in (-1, -2):
        moved = np.moveaxis(x, axis, -1)
        padded = np.pad(moved, [(0, 0)] * (moved.ndim - 1) + [(r, r)], mode="reflect")
        n = moved.shape[-1]
        out = np.zeros_like(moved)
        for t, tap in enumerate(taps.astype(np.float64)):
            out += tap * padded[..., t:t + n]
        x = np.moveaxis(out, -1, axis)
    return x


def test_taps_follow_the_upstream_formulas():
    # Source.cpp:60-73: sigma 10 -> radius 32.29 -> width 65
    assert reference.gaussian_width(10.0, 10_000) == 65
    assert reference.gaussian_width(900.0, 30_000) == 5991
    assert reference.gaussian_width(10.0, 40) == 41  # clamped, forced odd
    taps = reference.gaussian_taps(3.0, 1000)
    assert taps.dtype == np.float32 and len(taps) % 2 == 1
    assert abs(float(np.sum(taps, dtype=np.float64)) - 1.0) < 1e-6
    assert np.array_equal(taps, taps[::-1])
    assert int(np.argmax(taps)) == len(taps) // 2


@pytest.mark.parametrize("shape,sigma", [((2, 23, 31, 3), 2.5), ((1, 40, 17, 3), 4.0)])
def test_reference_matches_a_direct_float64_convolution(shape, sigma):
    x = frames.make_frames("cpu", shape[0], shape[1], shape[2], 3, 12345)
    taps = reference.gaussian_taps(sigma, max(shape[1], shape[2]))
    ops = reference.Operators(shape[1], shape[2], sigma, "cpu")
    for b in range(shape[0]):
        for c in range(3):
            plane = x[b, :, :, c].to(torch.float64)
            got = reference._blur_plane(plane, ops.rows, ops.cols, ops.r, ops.r).numpy()
            want = _direct(x[b, :, :, c].numpy(), taps)
            assert np.abs(got - want).max() < 1e-9


def test_band_matrix_reflects_101_and_zeroes_past_the_frame():
    taps = np.array([0.1, 0.2, 0.4, 0.2, 0.1], dtype=np.float32)
    m = reference.band_matrix(6, taps, "cpu")
    x = torch.arange(6, dtype=torch.float64)
    padded = np.pad(np.arange(6.0), 2, mode="reflect")
    want = [float(np.dot(taps.astype(np.float64), padded[i:i + 5])) for i in range(6)]
    assert torch.allclose(x @ m, torch.tensor(want, dtype=torch.float64))
    # a radius past the line: reflected up to n - 1 a side, zero beyond
    wide = reference.band_matrix(3, np.full(9, 1 / 9, dtype=np.float32), "cpu")
    assert float(wide.sum(0)[0]) == pytest.approx(7 / 9)


def test_judgement_of_exact_rounding_and_of_faults():
    x = frames.make_frames("cpu", 1, 30, 40, 3, 99)
    sigma = 3.0
    ops = reference.Operators(30, 40, sigma, "cpu")
    exact = torch.empty_like(x)
    for c in range(3):
        y = reference._blur_plane(x[0, :, :, c].to(torch.float64), ops.rows, ops.cols, ops.r,
                                  ops.r)
        exact[0, :, :, c] = torch.clamp(torch.floor(y + 0.5), 0, 255).to(torch.uint8)
    n = reference.judge(exact, x, sigma, ops=ops).numbers()
    assert n["mismatch_pct"] == 0 and n["worst_count_diff"] == 0
    assert n["worst_excess_counts"] <= 0
    altered = exact.clone()
    altered[0, 5, 7, 1] += 2
    n = reference.judge(altered, x, sigma, ops=ops).numbers()
    assert n["worst_count_diff"] == 2
    assert reference.judge(None, x, sigma, ops=ops).numbers()["mismatch_pct"] == 100.0
    assert reference.judge(exact[..., :2], x, sigma, ops=ops).numbers()["worst_count_diff"] == 255


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_cell_limit(cell):
    """The control (the reference in float8 e4m3 in the program's place) at
    the cell's sigma on a frame a test run holds: its mismatch share and its
    worst count lie past the cell's limits, as at the cell's own size on the
    card."""
    c = MAN.cell(cell)
    sigma = harness.sigma_of(c.traffic, c.config)
    h, w = 120, 200
    x = frames.make_frames("cpu", 1, h, w, 3, 4242)
    out = reference.blur_lower_precision(x, sigma)
    n = reference.judge(out, x, sigma).numbers()
    assert n["mismatch_pct"] > float(c.checks["mismatch_pct"]["limit"])
    assert n["worst_count_diff"] > float(c.checks["worst_count_diff"]["limit"])
    assert math.isfinite(n["worst_excess_counts"])
