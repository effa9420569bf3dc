"""The port's ``models.unsharp_mask``, ``models.high_pass`` (on K2) and
``models.channel_smooth`` against the JAX package's on the CPU: float
within 2e-3 at the 0..255 scale, uint8 within 1 count; and the entry
point's device rule (no card and no ``"cpu"``: ``RuntimeError``).
"""

from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from blur_algorithms_tpu import models as j_models  # noqa: E402
from blur_algorithms_tpu import oracle  # noqa: E402
from blur_algorithms_tpu_torch import models  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fused_blur  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread: beside XLA's CPU threads (and the suite's other
    workers) the plain versions' tap-by-tap ops otherwise spin against them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _u8_close(got, want):
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("sigma, amount", [(2.0, 0.8), (1.0, 1.5), (6.0, 1.0)])
def test_unsharp_u8_against_jax(rgb_image, sigma, amount):
    got = models.unsharp_mask(torch.from_numpy(rgb_image), sigma, amount).numpy()
    want = np.asarray(j_models.unsharp_mask(jnp.asarray(rgb_image), sigma, amount))
    _u8_close(got, want)


def test_unsharp_threshold_against_jax(rgb_image):
    got = models.unsharp_mask(torch.from_numpy(rgb_image), 2.0, 1.5, threshold=8).numpy()
    want = np.asarray(j_models.unsharp_mask(jnp.asarray(rgb_image), 2.0, 1.5, threshold=8))
    # the hard cutoff can flip a pixel whose |detail| sits on it within float
    # error (the JAX test allows the same against its oracle)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert (diff > 1).mean() < 1e-3


def test_unsharp_amount_zero_is_identity(rgb_image):
    np.testing.assert_array_equal(models.unsharp_mask(torch.from_numpy(rgb_image), 3.0, 0.0).numpy(),
                                  rgb_image)


def test_unsharp_float_against_jax_and_differentiable():
    x = (np.random.default_rng(1).random((2, 40, 48)) * 255).astype(np.float32)
    t = torch.from_numpy(x).requires_grad_()
    got = models.unsharp_mask(t, 2.0, 1.0)
    want = np.asarray(j_models.unsharp_mask(jnp.asarray(x), 2.0, 1.0))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=2e-3)
    got.sum().backward()
    assert torch.isfinite(t.grad).all()


def test_unsharp_u8_requires_interleaved():
    with pytest.raises(ValueError, match="interleaved"):
        models.unsharp_mask(torch.zeros((16, 16), dtype=torch.uint8), 2.0)


def test_unsharp_runs_k2s_plain_version(rgb_image, monkeypatch):
    calls = []
    real = fused_blur.blur_fused_f32_ref
    monkeypatch.setattr(fused_blur, "blur_fused_f32_ref",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    models.unsharp_mask(torch.from_numpy(rgb_image), 2.0)
    assert calls


@pytest.mark.parametrize("layout", ["u8", "f32"])
def test_high_pass_against_jax(rgb_image, layout):
    img = rgb_image if layout == "u8" else np.moveaxis(rgb_image, -1, 0).astype(np.float32)
    got = models.high_pass(torch.from_numpy(np.ascontiguousarray(img)), 4.0)
    want = np.asarray(j_models.high_pass(jnp.asarray(img), 4.0))
    assert got.dtype == torch.float32 and got.shape == want.shape == (3, 96, 80)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)


@pytest.mark.parametrize("sigmas", [(1.0, 11.0, 11.0), (5.0, 5.0, 7.0), (0, 5.0, None)])
def test_channel_smooth_rgb_against_jax(rgb_image, sigmas):
    got = models.channel_smooth(rgb_image, sigmas, device="cpu")
    _u8_close(got, j_models.channel_smooth(rgb_image, sigmas))


def test_channel_smooth_untouched_channels_and_oracle(rgb_image):
    got = models.channel_smooth(rgb_image, (0, 5.0, None), device="cpu")
    np.testing.assert_array_equal(got[..., 0], rgb_image[..., 0])
    np.testing.assert_array_equal(got[..., 2], rgb_image[..., 2])
    _u8_close(models.channel_smooth(rgb_image, (5.0, 5.0, 5.0), device="cpu"),
              oracle.blur_u8(rgb_image, 5.0))


@pytest.mark.parametrize("colorspace", ["lab", "ycrcb"])
def test_channel_smooth_colorspaces_against_jax(rgb_image, colorspace, monkeypatch):
    """Within 1 count in the working colour space (the planes handed to the
    conversion back to RGB, which can widen a 1-count step)."""
    cv2 = pytest.importorskip("cv2")
    real, seen = cv2.cvtColor, []

    def spy(img, code):
        seen.append(img.copy())
        return real(img, code)

    monkeypatch.setattr(cv2, "cvtColor", spy)
    got = models.channel_smooth(rgb_image, (5.0, 5.0, 7.0), colorspace=colorspace, device="cpu")
    want = j_models.channel_smooth(rgb_image, (5.0, 5.0, 7.0), colorspace=colorspace)
    assert len(seen) == 4  # to the working space and back, in each package
    np.testing.assert_array_equal(seen[0], seen[2])
    _u8_close(seen[1], seen[3])
    assert got.shape == rgb_image.shape and (got == want).all(axis=-1).mean() > 0.99


def test_channel_smooth_bad_inputs(rgb_image):
    for args, kw in [((rgb_image.astype(np.float32), (1, 1, 1)), {}), ((rgb_image, (1, 1)), {}),
                     ((rgb_image, (1, 1, 1)), {"colorspace": "hsv"})]:
        with pytest.raises(ValueError):
            models.channel_smooth(*args, device="cpu", **kw)


def test_channel_smooth_needs_a_card_unless_asked_for_the_cpu(rgb_image):
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            models.channel_smooth(rgb_image, (1.0, 1.0, 1.0))
        assert models.channel_smooth(rgb_image, (1.0, 1.0, 1.0), device="cpu").shape == rgb_image.shape


def test_models_export_the_jax_list():
    assert models.__all__ == j_models.__all__
