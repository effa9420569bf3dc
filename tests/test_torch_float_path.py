"""Slice 2 as a whole: the float path, custom taps, box blur, precision pins
and gradients, against the JAX package's functions of the same names.

On the CPU the port runs the plain versions of its kernels (K1's for the
exact int8 rung, K2's otherwise). JAX off a TPU runs the same math through
its band-matmul fallback in the bf16x3 accuracy class. Limits: float
outputs within 2e-3 at 0..255 scale (times the taps' gain for signed
filters, as in ``test_torch_fused_blur.py``), uint8 outputs within 1
count, gradients within rtol 1e-5 / atol 1e-4 for unit-scale cotangents.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import blur_algorithms_tpu as jax_pkg  # noqa: E402
import blur_algorithms_tpu_torch as port  # noqa: E402
from blur_algorithms_tpu_torch import api  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fused_blur as t_fused  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fused_dma as t_dma  # noqa: E402
from blur_algorithms_tpu_torch.utils.hw import device_spec  # noqa: E402

ASYM_ROW = [0.05, 0.1, 0.5, 0.2, 0.3, -0.1, 0.02]
ASYM_COL = [-0.2, 0.4, 0.9, 0.1, -0.05]
SHARPEN5 = [-0.125, -0.25, 1.75, -0.25, -0.125]


def _planar(shape, seed):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.float32)


def _frames(shape, seed):
    rng = np.random.default_rng(seed)
    b, h, w, c = shape
    yy, xx = np.mgrid[0:h, 0:w]
    base = 127 + 80 * np.sin(xx / 7.0) + 60 * np.cos(yy / 11.0)
    img = base[None, :, :, None] + rng.normal(0, 25, (b, h, w, c))
    return np.clip(img, 0, 255).astype(np.uint8)


def _close_f32(got: torch.Tensor, want, gain: float = 1.0):
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-3 * gain)


def _close_u8(got: torch.Tensor, want):
    assert got.dtype == torch.uint8
    assert np.abs(got.numpy().astype(int) - np.asarray(want).astype(int)).max() <= 1


@pytest.mark.parametrize("sigma", [3.0, 25.0, (2.0, 50.0), (0.1, 4.0)])
@pytest.mark.parametrize("engine", ["auto", "fused", "band"])
def test_blur_float_against_jax(sigma, engine):
    x = _planar((2, 3, 56, 160), seed=1)
    got = port.blur(torch.from_numpy(x), sigma, engine=engine)
    assert got.shape == x.shape
    _close_f32(got, jax_pkg.blur(jnp.asarray(x), sigma, engine=engine))


def test_gaussian_blur_float_against_jax():
    x = _planar((48, 96), seed=2)
    got = port.gaussian_blur(torch.from_numpy(x), 4.0)
    _close_f32(got, jax_pkg.gaussian_blur(jnp.asarray(x), 4.0))
    # float16 and uint8 planes are widened to float32 first, as in JAX
    _close_f32(port.blur(torch.from_numpy(x).half(), 4.0),
               jax_pkg.blur(jnp.asarray(x, jnp.float16), 4.0))


@pytest.mark.parametrize("taps_row, taps_col, gain", [
    (ASYM_ROW, ASYM_COL, 2.1), (SHARPEN5, None, 6.3), ([0.25, 0.5, 0.25], [1.0], 1.0),
])
@pytest.mark.parametrize("engine", ["auto", "band"])
def test_convolve_separable_float_against_jax(taps_row, taps_col, gain, engine):
    x = _planar((2, 40, 136), seed=3)
    got = port.convolve_separable(torch.from_numpy(x), taps_row, taps_col, engine=engine)
    want = jax_pkg.convolve_separable(jnp.asarray(x), taps_row, taps_col, engine=engine)
    _close_f32(got, want, gain)


@pytest.mark.parametrize("taps_row, taps_col", [
    (SHARPEN5, None), (ASYM_ROW, ASYM_COL), ([0.25, 0.5, 0.25], None), ([1.0], [0.25, 0.5, 0.25]),
])
def test_convolve_separable_uint8_against_jax(taps_row, taps_col):
    img = _frames((2, 40, 72, 3), seed=4)
    got = port.convolve_separable(torch.from_numpy(img), taps_row, taps_col)
    assert got.shape == img.shape
    _close_u8(got, jax_pkg.convolve_separable(jnp.asarray(img), taps_row, taps_col))


@pytest.mark.parametrize("nsmooth, passes", [(2.0, 2), (3.0, 2), (1.5, 3), (0.5, 2)])
def test_box_blur_against_jax(nsmooth, passes):
    img = _frames((1, 48, 80, 3), seed=5)
    _close_u8(port.box_blur(torch.from_numpy(img), nsmooth, passes),
              jax_pkg.box_blur(jnp.asarray(img), nsmooth, passes))
    x = _planar((2, 48, 80), seed=6)
    _close_f32(port.box_blur(torch.from_numpy(x), nsmooth, passes),
               jax_pkg.box_blur(jnp.asarray(x), nsmooth, passes))


@pytest.mark.parametrize("precision", ["int8", "bf16x3"])
@pytest.mark.parametrize("sigma", [3.0, (2.0, 5.0), (4.0, 0.1), (0.1, 3.0)])
def test_blur_u8_precision_pins_against_jax(precision, sigma):
    img = _frames((2, 40, 96, 3), seed=7)
    got = port.blur_u8(torch.from_numpy(img), sigma, precision=precision)
    _close_u8(got, jax_pkg.blur_u8(jnp.asarray(img), sigma, precision=precision))


def test_blur_u8_pins_pick_their_kernels():
    img = torch.from_numpy(_frames((1, 32, 48, 3), seed=8))
    plan = port.make_plan((32, 48), 3.0)
    planar = img.movedim(-1, -3).contiguous()
    int8 = port.blur_u8(img, 3.0, precision="int8")
    bf16x3 = port.blur_u8(img, 3.0, precision="bf16x3")
    assert torch.equal(int8, port.blur_u8(img, 3.0))  # AUTO runs int8 here
    assert torch.equal(int8.movedim(-1, -3), t_dma.blur_fused_u8_dma_ref(planar, plan))
    assert torch.equal(bf16x3.movedim(-1, -3),
                       t_fused.blur_fused_f32_ref(planar, plan, out_u8=True))


@pytest.mark.parametrize("sigma", [0.1, (0.1, 3.0), (3.0, 0.1)])
def test_blur_u8_radius_0_axes_against_jax(sigma):
    img = _frames((2, 40, 64, 3), seed=9)
    _close_u8(port.blur_u8(torch.from_numpy(img), sigma),
              jax_pkg.blur_u8(jnp.asarray(img), sigma))


def test_blur_u8_band_engine_against_jax():
    img = _frames((2, 40, 72, 3), seed=10)
    _close_u8(port.blur_u8(torch.from_numpy(img), 3.0, engine="band"),
              jax_pkg.blur_u8(jnp.asarray(img), 3.0, engine="band"))


# ---------------------------------------------------------------------------
# gradients


@pytest.mark.parametrize("sigma", [3.0, (2.0, 6.0)])
def test_blur_grad_against_jax_vjp(sigma):
    x = _planar((2, 40, 72), seed=11)
    g = np.random.default_rng(12).standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jax_pkg.blur(t, sigma), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(x).requires_grad_()
    (port.blur(t, sigma) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("engine", ["auto", "band"])
def test_convolve_separable_grad_against_jax_vjp(engine):
    """Both of the port's engines against JAX AUTO, whose backward is the
    exact adjoint (the JAX band engine differentiates through its bf16
    splits, so its gradient is only bf16-accurate; the port's band engine
    runs full float32 matmuls and torch differentiates them exactly)."""
    x = _planar((2, 40, 72), seed=13)
    g = np.random.default_rng(14).standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(
        lambda t: jax_pkg.convolve_separable(t, ASYM_ROW, ASYM_COL),
        jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(x).requires_grad_()
    out = port.convolve_separable(t, ASYM_ROW, ASYM_COL, engine=engine)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# routing, counters and the refused calls


def test_float_path_launches_nothing_on_the_cpu():
    k1, k2 = t_dma.blur_fused_u8_dma.launches, t_fused.blur_fused_f32.launches
    x = torch.from_numpy(_planar((2, 24, 40), seed=15))
    img = torch.from_numpy(_frames((1, 24, 40, 3), seed=16))
    port.blur(x, 2.0)
    port.convolve_separable(x, ASYM_ROW, ASYM_COL)
    port.convolve_separable(img, SHARPEN5)
    port.box_blur(img, 2.0)
    port.blur_u8(img, 2.0, precision="bf16x3")
    assert (t_dma.blur_fused_u8_dma.launches, t_fused.blur_fused_f32.launches) == (k1, k2)


@pytest.mark.parametrize("plan", [
    port.make_custom_plan((64, 64), SHARPEN5),  # signed taps
    port.make_custom_plan((64, 64), [1.0], [0.25, 0.5, 0.25]),  # radius-0 row axis
    port.make_plan((64, 64), (3.0, 0.1)),  # radius-0 row axis of a Gaussian
])
def test_u8_precision_is_bf16x3_where_int8_does_not_apply(plan):
    assert api._u8_dma_precision(plan, device_spec("cpu")) == "bf16x3"


@pytest.mark.parametrize("call, exc, match", [
    (lambda x: port.blur_u8(x, 3.0, precision="fp8"), ValueError, "precision"),
    (lambda x: port.blur_u8(x, 3.0, precision="int8", engine="band"), ValueError, "fused"),
    # served since K1's hybrid body was ported: the case keeps its id and
    # holds the call's result
    pytest.param(lambda x: port.blur_u8(x + 9, 3.0, precision="hybrid"), None, 9,
                 id="<lambda>-NotImplementedError-Next steps 2"),
    (lambda x: port.convolve_separable(x, SHARPEN5, engine="box"), ValueError, "custom taps"),
    (lambda x: port.convolve_separable(x, SHARPEN5, engine="cascade"), ValueError, "custom taps"),
    # served since ops/streamed was ported: the case keeps its id and holds
    # the call's result (a unit-sum filter keeps a constant frame)
    pytest.param(lambda x: port.convolve_separable(x + 5, SHARPEN5, engine="fft_stream"),
                 None, 5, id="<lambda>-NotImplementedError-fft_stream"),
    # served since the conv engine was ported: the case keeps its id and
    # holds the call's result (a unit-sum filter keeps a constant frame)
    pytest.param(lambda x: port.convolve_separable(x[..., 0].float() + 4, SHARPEN5,
                                                   engine="conv"),
                 None, 4.0, id="<lambda>-NotImplementedError-conv"),
    # served since the box and cascade engines were ported: these two cases
    # keep their ids and hold the call's result
    pytest.param(lambda x: port.blur(x[..., 0].float() + 3, 3.0, engine="box"), None, 3.0,
                 id="<lambda>-NotImplementedError-item 8"),
    pytest.param(lambda x: port.blur(x[..., 0].float() + 3, 3.0, engine="cascade"), None, 3.0,
                 id="<lambda>-NotImplementedError-item 9"),
    (lambda x: port.convolve_separable(x[0, 0], SHARPEN5), ValueError, "interleaved"),
])
def test_refused_calls(call, exc, match):
    x = torch.zeros((1, 24, 40, 3), dtype=torch.uint8)
    if exc is None:  # a served call: a constant frame stays constant
        out = call(x)
        is_u8 = out.dtype == torch.uint8  # the uint8 pin keeps the frame's layout
        assert out.shape == ((1, 24, 40, 3) if is_u8 else (1, 24, 40))
        assert out.dtype == (torch.uint8 if is_u8 else torch.float32)
        torch.testing.assert_close(out, torch.full_like(out, match))
        return
    with pytest.raises(exc, match=match):
        call(x)
