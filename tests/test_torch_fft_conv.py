"""The reference FFT engines of the port (``fft2``, ``fft_tiles``,
``pffft``), K5's plain version and ``dft_spectrum``, against the JAX
package on the CPU.

Both packages run the transforms in float32 pocketfft-class libraries
(``jnp.fft`` / ``torch.fft``); only the order of rounding differs. Limits
at 0..255 scale: float blurs within 1e-3, uint8 within 1 count of
``oracle.blur_u8`` (and of the pffft twin for ``"pffft"``), K5's plain
version equal to the JAX off-TPU expression. Spectra are compared as
magnitudes ``10 ** (dB / 20)`` within 4e-6 of the largest: the log scale
magnifies the float32 transform's rounding in the near-zero bins, where
``torch.fft`` and ``np.fft`` round differently.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import blur_algorithms_tpu as jax_pkg  # noqa: E402
import blur_algorithms_tpu_torch as port  # noqa: E402
from blur_algorithms_tpu import oracle  # noqa: E402
from blur_algorithms_tpu.ops import fft_conv as j_fft_conv  # noqa: E402
from blur_algorithms_tpu.ops.plan import make_plan as j_make_plan  # noqa: E402
from blur_algorithms_tpu.pallas_kernels import spectral_multiply as j_k5  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import spectral_multiply as t_k5  # noqa: E402
from blur_algorithms_tpu_torch.ops import fft_conv as t_fft_conv  # noqa: E402
from blur_algorithms_tpu_torch.ops.plan import make_plan  # noqa: E402

ASYM_ROW = [0.05, 0.1, 0.5, 0.2, 0.3, -0.1, 0.02]
ASYM_COL = [-0.2, 0.4, 0.9, 0.1, -0.05]
ENGINES = ["fft2", "fft_tiles", "pffft"]


def _planar(shape, seed):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.float32)


def _frames(shape, seed):
    rng = np.random.default_rng(seed)
    b, h, w, c = shape
    yy, xx = np.mgrid[0:h, 0:w]
    base = 127 + 80 * np.sin(xx / 7.0) + 60 * np.cos(yy / 11.0)
    img = base[None, :, :, None] + rng.normal(0, 25, (b, h, w, c))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("sigma, size_mode", [(3.0, "auto"), ((2.0, 9.0), "auto"),
                                              (5.0, "smooth235"), (4.0, "pow2")])
def test_engines_against_jax(engine, sigma, size_mode):
    x = _planar((2, 3, 44, 70), seed=1)
    got = port.blur(torch.from_numpy(x), sigma, engine=engine, size_mode=size_mode)
    assert got.dtype == torch.float32 and got.shape == x.shape
    want = jax_pkg.blur(jnp.asarray(x), sigma, engine=engine, size_mode=size_mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)


@pytest.mark.parametrize("engine", ["fft2", "fft_tiles"])
@pytest.mark.parametrize("taps_row, taps_col", [(ASYM_ROW, ASYM_COL), (ASYM_ROW, None),
                                                ([0.25, 0.5, 0.25], ASYM_COL)])
def test_asymmetric_taps_against_jax(engine, taps_row, taps_col):
    x = _planar((2, 40, 56), seed=2)
    got = port.convolve_separable(torch.from_numpy(x), taps_row, taps_col, engine=engine)
    want = jax_pkg.convolve_separable(jnp.asarray(x), taps_row, taps_col, engine=engine)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)


def test_pffft_matches_its_numpy_twin_and_quirk():
    x = _planar((2, 40, 60), seed=3)
    plan = j_make_plan((40, 60), 3.0, size_mode="smooth235")
    got = port.blur(torch.from_numpy(x), 3.0, engine="pffft", size_mode="smooth235")
    np.testing.assert_allclose(got.numpy(), oracle.blur_planar_pffft(x, plan),
                               rtol=0, atol=1e-3)
    spec = make_plan((40, 60), 3.0).row.spectrum
    np.testing.assert_array_equal(t_fft_conv._pffft_quirked(spec, 64),
                                  j_fft_conv._pffft_quirked(spec, 64))
    assert t_fft_conv._pffft_quirked(spec, 63) is spec


@pytest.mark.parametrize("n", [9, 10, 64, 65])
def test_mirror_full_equals_jax(n):
    rng = np.random.default_rng(n)
    half = rng.standard_normal(n // 2 + 1).astype(np.float32)
    np.testing.assert_array_equal(t_fft_conv._mirror_full(half, n),
                                  j_fft_conv._mirror_full(half, n))
    c = (half + 1j * rng.standard_normal(half.shape)).astype(np.complex64)
    np.testing.assert_array_equal(t_fft_conv._mirror_full_c(c, n),
                                  j_fft_conv._mirror_full_c(c, n))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("sigma", [2.0, 6.0])
def test_uint8_through_each_engine_against_the_oracle(engine, sigma):
    img = _frames((2, 36, 52, 3), seed=4)
    size_mode = "smooth235" if engine == "pffft" else "auto"
    got = port.blur_u8(torch.from_numpy(img), sigma, engine=engine, size_mode=size_mode)
    assert got.dtype == torch.uint8 and got.shape == img.shape
    got = got.numpy().astype(int)
    want_jax = np.asarray(jax_pkg.blur_u8(jnp.asarray(img), sigma, engine=engine,
                                          size_mode=size_mode)).astype(int)
    assert np.abs(got - want_jax).max() <= 1
    for b in range(img.shape[0]):
        # the pffft engine's Nyquist shortcut moves noisy frames off the
        # exact oracle: its own oracle is the NumPy twin of the quirk
        want = (oracle.blur_u8_pffft(img[b], sigma) if engine == "pffft"
                else oracle.blur_u8(img[b], sigma))
        assert np.abs(got[b] - want.astype(int)).max() <= 1


# ---------------------------------------------------------------------------
# K5: the spectral multiply


def test_k5_plain_equals_the_jax_off_tpu_expression():
    rng = np.random.default_rng(5)
    spec = (rng.standard_normal((3, 24, 17)) + 1j * rng.standard_normal((3, 24, 17)))
    spec = spec.astype(np.complex64)
    col = rng.standard_normal(24).astype(np.float32)
    row = rng.standard_normal(17).astype(np.float32)
    for scale in (1.0, 0.37):
        got = t_k5.spectral_multiply_2d(torch.from_numpy(spec), col, row, scale)
        want = j_k5.spectral_multiply_2d(jnp.asarray(spec), col, row, scale)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        got = t_k5.spectral_multiply_rows(torch.from_numpy(spec), row, scale)
        want = j_k5.spectral_multiply_rows(jnp.asarray(spec), row, scale)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("engine", ["fft2", "fft_tiles"])
def test_kernel_multiply_against_jax_pallas_multiply(engine):
    x = _planar((2, 40, 64), seed=6)
    plan, jplan = make_plan((40, 64), 4.0), j_make_plan((40, 64), 4.0)
    fn = {"fft2": (t_fft_conv.blur_fft2, j_fft_conv.blur_fft2),
          "fft_tiles": (t_fft_conv.blur_fft_tiles, j_fft_conv.blur_fft_tiles)}[engine]
    before = t_k5.spectral_multiply_2d.launches
    got = fn[0](torch.from_numpy(x), plan, kernel_multiply=True)
    assert t_k5.spectral_multiply_2d.launches == before  # CPU: the plain version
    want = fn[1](jnp.asarray(x), jplan, pallas_multiply=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.numpy(), fn[0](torch.from_numpy(x), plan).numpy(),
                               rtol=0, atol=1e-4)


def test_kernel_multiply_and_pffft_refuse_asymmetric_taps():
    x = torch.from_numpy(_planar((1, 24, 30), seed=7))
    plan = port.make_custom_plan((24, 30), ASYM_ROW, ASYM_COL)
    with pytest.raises(ValueError, match="symmetric"):
        t_fft_conv.blur_fft2(x, plan, kernel_multiply=True)
    with pytest.raises(ValueError, match="symmetric"):
        t_fft_conv.blur_fft_tiles(x, plan, kernel_multiply=True)
    with pytest.raises(ValueError, match="symmetric"):
        port.convolve_separable(x, ASYM_ROW, ASYM_COL, engine="pffft")


def test_k5_rejects_bad_inputs():
    spec = torch.zeros((2, 4, 5), dtype=torch.complex64)
    with pytest.raises(TypeError):
        t_k5.spectral_multiply_2d(spec.real, np.ones(4), np.ones(5))
    with pytest.raises(ValueError):
        t_k5.spectral_multiply_2d(spec, np.ones(5), np.ones(5))
    with pytest.raises(ValueError):  # neither CUDA nor CPU: no silent move
        t_k5.spectral_multiply_2d(spec.to("meta"), np.ones(4), np.ones(5))


# ---------------------------------------------------------------------------
# the spectrum export


def _close_spectra(got: torch.Tensor, want):
    assert got.dtype == torch.float32
    a, b = 10.0 ** (got.numpy() / 20.0), 10.0 ** (np.asarray(want) / 20.0)
    np.testing.assert_allclose(a, b, rtol=0, atol=4e-6 * b.max())


@pytest.mark.parametrize("nsmooth", [1.0, 2.0, 7.0])
def test_dft_spectrum_against_jax_and_oracle(nsmooth):
    x = _planar((2, 40, 48), seed=8)
    got = port.dft_spectrum(torch.from_numpy(x), nsmooth)
    plan = j_make_plan((40, 48), nsmooth)
    assert got.shape == (2, *plan.fft_shape)
    _close_spectra(got, oracle.dft_spectrum_np(x, plan))
    _close_spectra(got, jax_pkg.dft_spectrum(jnp.asarray(x), nsmooth))


def test_dft_spectrum_uint8_channels():
    img = _frames((1, 30, 44, 3), seed=9)[0]
    got = port.dft_spectrum(torch.from_numpy(img), 1.5)
    plan = j_make_plan((30, 44), 1.5)
    assert got.shape == (3, *plan.fft_shape)
    _close_spectra(got, oracle.dft_spectrum_np(
        np.moveaxis(img, -1, 0).astype(np.float32), plan))
    _close_spectra(got, jax_pkg.dft_spectrum(jnp.asarray(img), 1.5))


def test_port_oracle_copies_equal_jax():
    """The port's copies of the pffft and spectrum oracles (``chip_smoke.py``
    holds the card against them) equal the JAX package's."""
    from blur_algorithms_tpu_torch import oracle as t_oracle

    x = _planar((2, 30, 44), seed=10)
    img = _frames((1, 30, 44, 3), seed=11)[0]
    for size_mode in ("auto", "smooth235"):
        plan, jplan = make_plan((30, 44), 3.0, size_mode=size_mode), j_make_plan(
            (30, 44), 3.0, size_mode=size_mode)
        np.testing.assert_array_equal(t_oracle.blur_planar_pffft(x, plan),
                                      oracle.blur_planar_pffft(x, jplan))
        np.testing.assert_array_equal(t_oracle.dft_spectrum_np(x, plan),
                                      oracle.dft_spectrum_np(x, jplan))
    np.testing.assert_array_equal(t_oracle.blur_u8_pffft(img, 3.0),
                                  oracle.blur_u8_pffft(img, 3.0))
