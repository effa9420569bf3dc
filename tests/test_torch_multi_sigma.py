"""The port's ``blur_multi_sigma(_u8)`` (a sigma sweep in one call) against
the JAX package on the CPU: float within 1e-3 at 0..255 scale of JAX's
``blur_multi_sigma`` (both pocketfft-class f32 FFTs of the same padded
frame), each slice within 2e-2 of the per-sigma oracle (JAX's bound);
uint8 within 1 count of JAX and of ``oracle.blur_u8``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import blur_algorithms_tpu as jax_pkg  # noqa: E402
import blur_algorithms_tpu_torch as port  # noqa: E402
from blur_algorithms_tpu import oracle  # noqa: E402
from blur_algorithms_tpu.ops.plan import make_plan as j_make_plan  # noqa: E402


def _frame(shape, seed):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.float32)


@pytest.mark.parametrize("shape, sigmas", [
    ((3, 72, 88), [0.8, 4.0, 11.0]),
    ((2, 3, 40, 56), [0.0, 2.0]),  # sigma 0: the identity slice
    ((1, 40, 56), [30.0]),  # the radius clamps against the short axis
])
def test_blur_multi_sigma_against_jax_and_oracle(shape, sigmas):
    x = _frame(shape, seed=len(sigmas))
    got = port.blur_multi_sigma(torch.from_numpy(x), sigmas)
    assert got.dtype == torch.float32 and tuple(got.shape) == (len(sigmas), *shape)
    got = got.numpy()
    want = np.asarray(jax_pkg.blur_multi_sigma(jnp.asarray(x), sigmas))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    for i, s in enumerate(sigmas):
        if s <= 0:
            np.testing.assert_allclose(got[i], x, rtol=0, atol=1e-3)
            continue
        ref = oracle.blur_planar_fft2(x, j_make_plan(shape[-2:], s))
        np.testing.assert_allclose(got[i], ref, rtol=0, atol=2e-2)


def test_blur_multi_sigma_u8_against_jax_and_oracle():
    img = (np.random.default_rng(5).random((2, 48, 64, 3)) * 255).astype(np.uint8)
    sigmas = [1.5, 6.0]
    got = port.blur_multi_sigma_u8(torch.from_numpy(img), sigmas)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (2, *img.shape)
    got = got.numpy().astype(int)
    want = np.asarray(jax_pkg.blur_multi_sigma_u8(jnp.asarray(img), sigmas)).astype(int)
    assert np.abs(got - want).max() <= 1
    for i, s in enumerate(sigmas):
        for b in range(2):
            assert np.abs(got[i, b] - oracle.blur_u8(img[b], s).astype(int)).max() <= 1


def test_blur_multi_sigma_rejects_bad_inputs():
    with pytest.raises(ValueError, match="non-empty"):
        port.blur_multi_sigma(torch.zeros((8, 8)), [])
    with pytest.raises(TypeError):
        port.blur_multi_sigma_u8(torch.zeros((8, 8, 3)), [1.0])
