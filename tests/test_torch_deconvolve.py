"""The port's ``models.wiener_deconvolve`` against the JAX package on the
CPU: float within 1e-3 at 0..255 scale of JAX's (the same reflect-101
frame, 1-D spectra and per-bin gain H / (H^2 + balance), pocketfft-class
f32 FFTs on both sides), uint8 within 1 count; the blur's round trip
recovers the interior as in JAX's own test.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from blur_algorithms_tpu.models.deconvolve import wiener_deconvolve as j_wiener  # noqa: E402
import blur_algorithms_tpu_torch as port  # noqa: E402
from blur_algorithms_tpu_torch.models import wiener_deconvolve  # noqa: E402


def _smooth(shape):
    """Band-limited planes: recovery is well posed away from crushed bins."""
    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = (127 + 50 * np.sin(xx / 9.0) + 40 * np.cos(yy / 12.0)
            + 25 * np.sin(xx * 1.0) + 15 * np.cos(yy * 0.8))
    return np.stack([base, np.roll(base, 7, 0)], axis=0).astype(np.float32)


@pytest.mark.parametrize("sigma, balance", [(3.0, 1e-3), (2.0, 1e-2)])
def test_wiener_float_against_jax(sigma, balance):
    x = _smooth((80, 96))
    got = wiener_deconvolve(torch.from_numpy(x), sigma, balance)
    assert got.dtype == torch.float32 and got.shape == x.shape
    want = np.asarray(j_wiener(jnp.asarray(x), sigma, balance))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


def test_wiener_u8_against_jax():
    img = np.clip(np.moveaxis(_smooth((64, 72)), 0, -1)[..., [0, 1, 0]], 0, 255).astype(np.uint8)
    got = wiener_deconvolve(torch.from_numpy(img), 2.0).numpy().astype(int)
    want = np.asarray(j_wiener(jnp.asarray(img), 2.0)).astype(int)
    assert got.shape == img.shape and np.abs(got - want).max() <= 1


def test_wiener_round_trip_recovers_the_interior():
    x = _smooth((80, 96))
    blurred = port.blur(torch.from_numpy(x), 2.0, engine="fft2")
    rec = wiener_deconvolve(blurred, 2.0, balance=1e-3).numpy()
    inner = (slice(None), slice(12, -12), slice(12, -12))
    assert np.abs(rec[inner] - x[inner]).max() < 2.0  # counts on a 0..255 scale


def test_wiener_rejects_an_unknown_kernel():
    with pytest.raises(ValueError):
        wiener_deconvolve(torch.zeros((16, 16)), 2.0, kernel="not-a-kernel")
