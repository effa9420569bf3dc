"""The plain reference against a direct float64 convolution, forward and
backward, its judgements, and each cell's control (one step below the
configuration's precision) failing the cell's limit at a size a test run
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


def _reflect101_direct(x: torch.Tensor, taps: np.ndarray, axis: int) -> torch.Tensor:
    """Correlation by ``taps`` along ``axis`` of float64 ``x`` under
    reflect-101 borders (reflected up to ``n - 1`` a side, zero past it), by
    gathering each tap's shifted samples: differentiable, so autograd gives
    its adjoint."""
    n = x.shape[axis]
    r = (len(taps) - 1) // 2
    p = torch.arange(-r, n + r)
    keep = (p >= -(n - 1)) & (p <= 2 * (n - 1))
    j = torch.where(p < 0, -p, p)
    j = torch.where(j > n - 1, 2 * (n - 1) - j, j).clamp(0, n - 1)
    shape = [1] * x.ndim
    shape[axis] = len(p)
    padded = x.index_select(axis, j) * keep.to(x.dtype).reshape(shape)
    out = torch.zeros_like(x)
    for t, tap in enumerate(taps.astype(np.float64)):
        out = out + float(tap) * padded.narrow(axis, t, n)
    return out


@pytest.mark.parametrize("block", [reference._BLOCK, 8])
@pytest.mark.parametrize("h,w,sigma", [(23, 31, 2.5), (5, 40, 10.0), (3, 64, 6.0),
                                       (40, 17, 4.0)])
def test_reference_backward_is_the_adjoint_of_a_direct_convolution(h, w, sigma, block,
                                                                   monkeypatch):
    """``_adjoint_plane`` against ``torch.autograd`` on the direct float64
    reflect-101 blur, including radii at or past a frame side (5 and 3 rows
    at r 20 and r 18) and blocks smaller than the radius."""
    monkeypatch.setattr(reference, "_BLOCK", block)
    taps = reference.gaussian_taps(sigma, max(h, w))
    ops = reference.Operators(h, w, sigma, "cpu")
    gen = torch.Generator().manual_seed(h * w)
    x = (torch.rand((h, w), generator=gen, dtype=torch.float64) * 255).requires_grad_(True)
    g = torch.randn((h, w), generator=gen, dtype=torch.float64)
    y = _reflect101_direct(_reflect101_direct(x, taps, 1), taps, 0)
    (want,) = torch.autograd.grad(y, x, g)
    got = reference._adjoint_plane(g, ops.rows, ops.cols, ops.r, ops.r)
    assert torch.abs(got - want).max() < 1e-12
    fwd = reference._blur_plane(x.detach(), ops.rows, ops.cols, ops.r, ops.r)
    assert torch.abs(fwd - y.detach()).max() < 1e-9
    # the reflect-101 band is not symmetric: the forward taken as the
    # adjoint is wrong at the borders
    assert torch.abs(reference._blur_plane(g, ops.rows, ops.cols, ops.r, ops.r) - want).max() > 1e-3


def test_planes_are_the_frames_before_rounding():
    planes = frames.make_planes("cpu", 2, 20, 30, 3, 2**40 + 3)
    assert planes.dtype == torch.float32 and planes.shape == (2, 3, 20, 30)
    assert float(planes.min()) >= 0 and float(planes.max()) <= 255
    u8 = frames.make_frames("cpu", 2, 20, 30, 3, 2**40 + 3)
    assert torch.equal(planes.permute(0, 2, 3, 1).to(torch.uint8), u8)
    g = frames.make_cotangent("cpu", (2, 3, 20, 30), 11)
    assert torch.equal(g, frames.make_cotangent("cpu", (2, 3, 20, 30), 11))
    assert abs(float(g.mean())) < 0.1 and abs(float(g.std()) - 1) < 0.1


def test_round_tf32_keeps_ten_mantissa_bits_to_nearest():
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 3 * 2**-11, -(1 + 2**-11), 255.3, 1 + 2**-12])
    want = [1.0, 1 + 2**-10, 1 + 2 * 2**-10, -(1 + 2**-10), 255.25, 1.0]
    assert reference.round_tf32(x).tolist() == want
    y = reference.round_tf32(torch.randn(1000, dtype=torch.float64).to(torch.float32))
    assert torch.equal(reference.round_tf32(y), y)
    assert int((y.view(torch.int32) & 0x1FFF).abs().sum()) == 0


def test_float_judgement_of_exact_answers_and_of_faults():
    gen = torch.Generator().manual_seed(7)
    x = torch.rand((2, 3, 30, 40), generator=gen) * 255
    g = torch.randn((2, 3, 30, 40), generator=gen)
    sigma = 3.0
    ops = reference.Operators(30, 40, sigma, "cpu")
    y = torch.stack([reference._blur_plane(p.to(torch.float64), ops.rows, ops.cols, ops.r,
                                           ops.r) for p in x.reshape(-1, 30, 40)])
    gx = torch.stack([reference._adjoint_plane(p.to(torch.float64), ops.rows, ops.cols, ops.r,
                                               ops.r) for p in g.reshape(-1, 30, 40)])
    y, gx = y.reshape(x.shape).to(torch.float32), gx.reshape(x.shape).to(torch.float32)
    n = reference.judge_float((y, gx), x, g, sigma, ops=ops).numbers()
    assert n["max_abs_err"] < 1e-4 and n["grad_max_abs_err"] < 1e-6
    assert reference.judge_float((y,), x, None, sigma, ops=ops).numbers().keys() == {"max_abs_err"}
    bad = y.clone()
    bad[1, 2, 3, 4] += 0.25
    assert reference.judge_float((bad, gx), x, g, sigma, ops=ops).numbers()["max_abs_err"] \
        == pytest.approx(0.25, abs=1e-4)
    bad = gx.clone()
    bad[0, 0, 0, 0] = float("nan")
    assert reference.judge_float((y, bad), x, g, sigma, ops=ops).numbers()["grad_max_abs_err"] \
        == math.inf
    for answer in (None, (y,), (y, gx[..., :-1]), (y.double(), gx)):
        n = reference.judge_float(answer, x, g, sigma, ops=ops).numbers()
        assert n == {"max_abs_err": math.inf, "grad_max_abs_err": math.inf}


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_cell_limit(cell):
    """The control (the reference one step below the configuration's
    precision in the program's place) at the cell's sigma on a frame a test
    run holds: a ``blur_u8`` cell's mismatch share and worst count, and a
    ``blur`` cell's largest error forward and backward, lie past the cell's
    limits, as at the cell's own size on the card."""
    c = MAN.cell(cell)
    sigma = harness.sigma_of(c.traffic, c.config)
    h, w = 120, 200
    if harness.entry_name(c.traffic) == "blur":
        x = frames.make_planes("cpu", 1, h, w, 3, 4242)
        g = frames.make_cotangent("cpu", x.shape, 4243)
        answer = (reference.blur_f32_lower_precision(x, sigma),
                  reference.adjoint_f32_lower_precision(g, sigma))
        n = reference.judge_float(answer, x, g, sigma).numbers()
        assert n["max_abs_err"] > float(c.checks["max_abs_err"]["limit"])
        assert n["grad_max_abs_err"] > float(c.checks["grad_max_abs_err"]["limit"])
        return
    x = frames.make_frames("cpu", 1, h, w, 3, 4242)
    out = reference.blur_lower_precision(x, sigma)
    n = reference.judge(out, x, sigma).numbers()
    assert n["mismatch_pct"] > float(c.checks["mismatch_pct"]["limit"])
    assert n["worst_count_diff"] > float(c.checks["worst_count_diff"]["limit"])
    assert math.isfinite(n["worst_excess_counts"])
