"""The cascade engine against the JAX package.

``cascade_sigmas`` must split a sigma into the same steps. ``blur_cascade``
and ``blur_cascade_u8`` run the same fused steps in both packages (the JAX
steps are its bf16x3 fused kernels, off a TPU its band-matmul fallback; the
port's are K2's plain f32 version): float outputs within 2e-3 at 0..255
scale, uint8 within 1 count. Both step limits are lowered to 224 on a
(300, 280) frame at sigma 80, as the JAX ``tests/test_cascade.py`` does, so
that the cascade takes several steps.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import blur_algorithms_tpu as jax_pkg  # noqa: E402
from blur_algorithms_tpu.ops import cascade as j_cascade  # noqa: E402
import blur_algorithms_tpu_torch as port  # noqa: E402
from blur_algorithms_tpu_torch.ops import cascade as t_cascade  # noqa: E402


@pytest.mark.parametrize("sigma", [1.0, 10.0, 155.0, 700.0, 1200.0, 1300.0, 2400.0])
def test_cascade_sigmas_equal_jax(sigma):
    assert t_cascade.cascade_sigmas(sigma) == j_cascade.cascade_sigmas(sigma)


def test_cascade_against_jax_with_a_lowered_step_limit(monkeypatch):
    monkeypatch.setattr(j_cascade, "_STEP_MAX_RADIUS", 224)
    monkeypatch.setattr(t_cascade, "_STEP_MAX_RADIUS", 224)
    rng = np.random.default_rng(0)
    x = (rng.random((300, 280)) * 255).astype(np.float32)
    sigma = 80.0
    assert len(t_cascade.cascade_sigmas(sigma)) >= 2
    got = t_cascade.blur_cascade(torch.from_numpy(x), sigma)
    want = np.asarray(j_cascade.blur_cascade(jnp.asarray(x), sigma))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)
    u = rng.integers(0, 256, size=(2, 300, 280), dtype=np.uint8)
    got_u8 = t_cascade.blur_cascade_u8(torch.from_numpy(u), sigma).numpy()
    want_u8 = np.asarray(j_cascade.blur_cascade_u8(jnp.asarray(u), sigma))
    assert got_u8.dtype == np.uint8
    assert np.abs(got_u8.astype(int) - want_u8.astype(int)).max() <= 1


def test_cascade_engine_through_the_api():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, size=(1, 64, 96, 3), dtype=np.uint8)
    got = port.blur_u8(torch.from_numpy(img), 12.0, engine="cascade").numpy()
    want = np.asarray(jax_pkg.blur_u8(jnp.asarray(img), 12.0, engine="cascade"))
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    x = (rng.random((2, 64, 96)) * 255).astype(np.float32)
    t = torch.from_numpy(x).requires_grad_()
    out = port.blur(t, 12.0, engine="cascade")
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(jax_pkg.blur(jnp.asarray(x), 12.0, engine="cascade")), rtol=0, atol=2e-3)
    out.sum().backward()  # differentiable through the fused steps
    assert t.grad is not None and t.grad.shape == t.shape


def test_cascade_refuses_an_anisotropic_sigma():
    x = torch.zeros((1, 24, 40, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="single scalar sigma"):
        port.blur_u8(x, (2.0, 3.0), engine="cascade")
    with pytest.raises(ValueError, match="single scalar sigma"):
        port.blur(x[..., 0].float(), (2.0, 3.0), engine="cascade")
