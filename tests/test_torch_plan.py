"""The port's host-side planning layer equals the JAX package's.

Plans, tap factories, FFT sizes, band matrices, the int8 quantiser, and the
tensor ops of the port (reflect-101 pad, layout) are held against their JAX
counterparts and the NumPy oracle on the same inputs, made with numpy from
a seed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from blur_algorithms_tpu import oracle as j_oracle  # noqa: E402
from blur_algorithms_tpu.ops import band_matmul as j_band  # noqa: E402
from blur_algorithms_tpu.ops import kernels as j_kernels  # noqa: E402
from blur_algorithms_tpu.ops import layout as j_layout  # noqa: E402
from blur_algorithms_tpu.ops import pad as j_pad  # noqa: E402
from blur_algorithms_tpu.ops import plan as j_plan  # noqa: E402
from blur_algorithms_tpu.ops import sizes as j_sizes  # noqa: E402
from blur_algorithms_tpu.pallas_kernels import fused_blur as j_fused  # noqa: E402
from blur_algorithms_tpu_torch import oracle as t_oracle  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fused_blur as t_fused  # noqa: E402
from blur_algorithms_tpu_torch.ops import band_matmul as t_band  # noqa: E402
from blur_algorithms_tpu_torch.ops import kernels as t_kernels  # noqa: E402
from blur_algorithms_tpu_torch.ops import layout as t_layout  # noqa: E402
from blur_algorithms_tpu_torch.ops import pad as t_pad  # noqa: E402
from blur_algorithms_tpu_torch.ops import plan as t_plan  # noqa: E402
from blur_algorithms_tpu_torch.ops import sizes as t_sizes  # noqa: E402

SHAPE = (700, 1100)  # holds r = 498 (sigma 150) on both axes


def _assert_axis_equal(a, b):
    for field in ("dim", "width", "pad", "fft_len", "trailing", "border"):
        assert getattr(a, field) == getattr(b, field), field
    np.testing.assert_array_equal(a.taps, b.taps)
    assert a.taps.dtype == b.taps.dtype
    np.testing.assert_array_equal(a.spectrum, b.spectrum)
    assert (a.spectrum_c is None) == (b.spectrum_c is None)
    if a.spectrum_c is not None:
        np.testing.assert_array_equal(a.spectrum_c, b.spectrum_c)
    assert a.support_radius == b.support_radius


def _assert_plan_equal(a, b):
    for field in ("shape", "kernel", "sigma", "passes", "size_mode",
                  "box_passes", "sigma_x", "fft_shape"):
        assert getattr(a, field) == getattr(b, field), field
    _assert_axis_equal(a.row, b.row)
    _assert_axis_equal(a.col, b.col)


@pytest.mark.parametrize("size_mode", ["auto", "smooth235", "pow2"])
@pytest.mark.parametrize("sigma", [0.7, 3.0, 10.0, 50.0, 150.0, (5.0, 11.0)])
def test_gaussian_plans_equal(sigma, size_mode):
    _assert_plan_equal(
        t_plan.make_plan(SHAPE, sigma, size_mode=size_mode),
        j_plan.make_plan(SHAPE, sigma, size_mode=size_mode),
    )


@pytest.mark.parametrize("kernel, nsmooth, shape", [
    ("box_fast", 9, SHAPE),
    ("box_fast", 40, (60, 1100)),  # clamped column axis
    ("box", 3, SHAPE),
    ("gaussian", 200.0, (300, 90)),  # clamped on both axes
])
def test_other_plans_equal(kernel, nsmooth, shape):
    _assert_plan_equal(
        t_plan.make_plan(shape, nsmooth, kernel=kernel),
        j_plan.make_plan(shape, nsmooth, kernel=kernel),
    )


def test_custom_plans_equal():
    rng = np.random.default_rng(1)
    row = rng.random(9).astype(np.float32)
    col = np.array([-0.25, 1.5, -0.25], np.float32)
    _assert_plan_equal(
        t_plan.make_custom_plan((64, 96), row, col),
        j_plan.make_custom_plan((64, 96), row, col),
    )
    _assert_plan_equal(  # wider than the axis: centrally truncated
        t_plan.make_custom_plan((5, 96), row),
        j_plan.make_custom_plan((5, 96), row),
    )


def test_tap_factory_equal():
    for sigma in (0.3, 1.0, 7.5, 120.0):
        width = j_kernels.gaussian_window(sigma)
        assert t_kernels.gaussian_window(sigma) == width
        assert t_kernels.gaussian_window(sigma, 33) == j_kernels.gaussian_window(sigma, 33)
        np.testing.assert_array_equal(
            t_kernels.gaussian_kernel(sigma, width),
            j_kernels.gaussian_kernel(sigma, width),
        )
    for k in (1, 4, 9):
        np.testing.assert_array_equal(
            t_kernels.box_tent_kernel(k), j_kernels.box_tent_kernel(k))
        np.testing.assert_array_equal(
            t_kernels.box_passes_kernel(k, 3), j_kernels.box_passes_kernel(k, 3))
    taps = j_kernels.gaussian_kernel(4.0, 25)
    for n in (32, 100):
        np.testing.assert_array_equal(
            t_kernels.real_spectrum(taps, n), j_kernels.real_spectrum(taps, n))
        np.testing.assert_array_equal(
            t_kernels.complex_spectrum(taps, n), j_kernels.complex_spectrum(taps, n))


def test_fft_sizes_equal():
    # the JAX "auto" mode is smooth235 off a TPU, which is the port's rule
    for n in list(range(1, 700, 7)) + [2160, 3840, 4000, 24000]:
        assert t_sizes.is_valid_size(n) == j_sizes.is_valid_size(n)
        for mode in t_sizes.SIZE_MODES:
            assert t_sizes.plan_fft_size(n, mode) == j_sizes.plan_fft_size(n, mode)
    with pytest.raises(ValueError):
        t_sizes.plan_fft_size(64, "odd")


@pytest.mark.parametrize("sigma, block", [(3.0, 24), (10.0, 128), (50.0, 1)])
def test_band_block_matrix_and_quantiser_equal(sigma, block):
    taps = j_kernels.gaussian_kernel(sigma, j_kernels.gaussian_window(sigma))
    band = t_band.band_block_matrix(taps, block)
    np.testing.assert_array_equal(band, j_band.band_block_matrix(taps, block))
    for pow2 in (False, True):
        scale = t_fused.pick_int8_scale(taps, pow2=pow2)
        assert scale == j_fused.pick_int8_scale(taps, pow2=pow2)
        np.testing.assert_array_equal(
            t_fused._quantize_band_int8(band, scale),
            j_fused._quantize_band_int8(band, scale),
        )


def test_int8_applicable_agrees():
    plans = [
        ((48, 64), 3.0),
        ((48, 64), 0.1),  # radius 0 on both axes
        ((1, 64), 3.0),  # radius 0 on the column axis only
    ]
    for shape, sigma in plans:
        t = t_plan.make_plan(shape, sigma)
        j = j_plan.make_plan(shape, sigma)
        assert t_fused.int8_applicable(t, torch.uint8) == j_fused.int8_applicable(j, jnp.uint8)
    signed = [-0.25, 1.5, -0.25]
    t = t_plan.make_custom_plan((16, 16), signed)
    j = j_plan.make_custom_plan((16, 16), signed)
    assert not t_fused.int8_applicable(t, torch.uint8)
    assert t_fused.int8_applicable(t, torch.uint8) == j_fused.int8_applicable(j, jnp.uint8)
    assert not t_fused.int8_applicable(t_plan.make_plan((48, 64), 3.0), torch.float32)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("pads", [
    [(3, 3), (5, 2)],
    [(0, 4), (7, 7)],
    [(9, 12), (1, 0)],  # past the dim - 1 clamp on the first axis: zeros
])
def test_reflect_101_equal(dtype, pads):
    rng = np.random.default_rng(2)
    x = (rng.random((2, 8, 11)) * 255).astype(dtype)
    got = t_pad.reflect_101(torch.from_numpy(x), pads).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_pad.reflect_101(jnp.asarray(x), pads)))
    np.testing.assert_array_equal(got, j_oracle.reflect_101_np(x, pads))
    np.testing.assert_array_equal(got, t_oracle.reflect_101_np(x, pads))
    axes_got = t_pad.reflect_101(torch.from_numpy(x), [(2, 3)], axes=[0]).numpy()
    np.testing.assert_array_equal(axes_got, j_oracle.reflect_101_np(x, [(2, 3)], axes=[0]))
    assert t_pad.clamp_pad(9, 8) == j_pad.clamp_pad(9, 8) == 7


def test_layout_equal():
    rng = np.random.default_rng(3)
    img = (rng.random((2, 5, 7, 3)) * 255).astype(np.uint8)
    planar = t_layout.to_planar(torch.from_numpy(img))
    np.testing.assert_array_equal(
        planar.numpy(), np.asarray(j_layout.to_planar(jnp.asarray(img))))
    assert planar.is_contiguous() and planar.dtype == torch.float32
    f = (rng.random((2, 3, 5, 7)) * 300 - 20).astype(np.float32)
    f[0, 0, 0, :4] = [0.5, 1.5, 254.5, -0.5]  # ties round half up
    np.testing.assert_array_equal(
        t_layout.from_planar(torch.from_numpy(f)).numpy(),
        np.asarray(j_layout.from_planar(jnp.asarray(f))),
    )
    np.testing.assert_array_equal(
        t_layout.round_to_u8(torch.from_numpy(f)).numpy(),
        np.asarray(j_layout.round_to_u8(jnp.asarray(f))),
    )
    u8 = torch.from_numpy(np.moveaxis(img, -1, -3).copy())
    np.testing.assert_array_equal(t_layout.from_planar(u8).numpy(), img)


def test_oracle_copy_equal():
    rng = np.random.default_rng(4)
    img = (rng.random((40, 52, 3)) * 255).astype(np.uint8)
    for sigma in (2.0, (1.5, 4.0)):
        np.testing.assert_array_equal(
            t_oracle.blur_u8(img, sigma), j_oracle.blur_u8(img, sigma))
    plan_t = t_plan.make_plan((40, 52), 3.0)
    plan_j = j_plan.make_plan((40, 52), 3.0)
    planar = np.moveaxis(img, -1, 0).astype(np.float32)
    np.testing.assert_array_equal(
        t_oracle.blur_direct(planar, plan_t), j_oracle.blur_direct(planar, plan_j))
    np.testing.assert_array_equal(
        t_oracle.blur_planar_fft2(planar, plan_t),
        j_oracle.blur_planar_fft2(planar, plan_j),
    )
