"""The port's slice as a whole: ``blur_u8`` AUTO against the JAX package.

On the CPU the port's ``blur_u8`` runs the plain version of K1. It must be
bit-equal to the JAX int8 DMA kernel (interpret mode) after the layout
moves, and within 1 count of JAX ``blur_u8`` (which off a TPU runs the
blocked f32 band path) and of the NumPy oracle. Every call outside the
slice's domain raises ``NotImplementedError``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import blur_algorithms_tpu as jax_pkg  # noqa: E402
import blur_algorithms_tpu_torch as port  # noqa: E402
from blur_algorithms_tpu import oracle  # noqa: E402
from blur_algorithms_tpu.ops.plan import make_plan as j_make_plan  # noqa: E402
from blur_algorithms_tpu.pallas_kernels import fused_dma as j_dma  # noqa: E402
from blur_algorithms_tpu_torch import api  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fused_dma as t_dma  # noqa: E402
from blur_algorithms_tpu_torch.utils.hw import device_spec  # noqa: E402


def _frames(shape, seed):
    rng = np.random.default_rng(seed)
    b, h, w, c = shape
    yy, xx = np.mgrid[0:h, 0:w]
    base = 127 + 80 * np.sin(xx / 7.0) + 60 * np.cos(yy / 11.0)
    img = base[None, :, :, None] + rng.normal(0, 25, (b, h, w, c))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("sigma, tile", [(3.0, (48, 256)), ((2.0, 5.0), (48, 128))])
def test_blur_u8_slice_against_jax(sigma, tile):
    img = _frames((2, 48, 640, 3), seed=7)
    got = port.blur_u8(torch.from_numpy(img), sigma)
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    assert tuple(got.shape) == img.shape
    got = got.numpy()

    # bit-equal to the JAX int8 DMA kernel after layout
    planar = jnp.asarray(np.moveaxis(img, -1, -3))
    k1 = j_dma._blur_fused_dma_impl(
        planar, j_make_plan((48, 640), sigma), "int8", True, tile=tile,
        direct=True,
    )
    np.testing.assert_array_equal(got, np.moveaxis(np.asarray(k1), -3, -1))

    # within 1 count of JAX blur_u8 and of the oracle
    jax_out = np.asarray(jax_pkg.blur_u8(jnp.asarray(img), sigma))
    assert np.abs(got.astype(int) - jax_out.astype(int)).max() <= 1
    for b in range(img.shape[0]):
        want = oracle.blur_u8(img[b], sigma)
        assert np.abs(got[b].astype(int) - want.astype(int)).max() <= 1


def test_gaussian_blur_single_frame_and_engine_fused():
    img = _frames((1, 40, 96, 3), seed=8)[0]
    x = torch.from_numpy(img)
    a = port.gaussian_blur(x, 2.5)
    b = port.blur_u8(x, 2.5, engine="fused")
    c = port.blur_u8(x, [2.5, 2.5], engine=port.Engine.AUTO)
    assert torch.equal(a, b) and torch.equal(a, c)
    want = oracle.blur_u8(img, 2.5)
    assert np.abs(a.numpy().astype(int) - want.astype(int)).max() <= 1


def test_routing_picks_fused_int8_on_this_device():
    plan = port.make_plan((2160, 3840), 10.0)
    assert api._resolve_engine("auto", plan) is api.Engine.FUSED
    assert api._u8_dma_precision(plan, device_spec("cpu")) == "int8"
    custom = port.make_custom_plan((64, 64), [-0.25, 1.5, -0.25])
    assert api._u8_dma_precision(custom, device_spec("cpu")) == "bf16x3"


def test_blur_u8_launches_nothing_on_the_cpu():
    before = t_dma.blur_fused_u8_dma.launches
    port.blur_u8(torch.from_numpy(_frames((1, 24, 40, 3), seed=9)), 2.0)
    assert t_dma.blur_fused_u8_dma.launches == before


@pytest.mark.parametrize("call", [
    lambda x: port.blur_u8(x, 200.0),  # AUTO past radius 600
    lambda x: port.blur_u8(x, 200.0, engine="fused"),
    lambda x: port.blur_u8(x, 0.1),  # radius-0 axes
    lambda x: port.blur_u8(x, 3.0, precision="int8"),
    lambda x: port.gaussian_blur(x.float(), 3.0),  # float input
    lambda x: api.blur(x.float(), 3.0),
    lambda x: api.box_blur(x, 2.0),
    lambda x: api.dft_spectrum(x, 2.0),
    lambda x: api.convolve_separable(x, [-0.25, 1.5, -0.25]),
])
def test_outside_the_domain_raises(call):
    x = torch.zeros((1, 1300, 1300, 3), dtype=torch.uint8)  # sigma 200: r = 650
    with pytest.raises(NotImplementedError):
        call(x)


@pytest.mark.parametrize("engine", [
    e for e in api.Engine if e not in (api.Engine.AUTO, api.Engine.FUSED)
])
def test_unported_engines_raise(engine):
    x = torch.zeros((20, 30, 3), dtype=torch.uint8)
    with pytest.raises(NotImplementedError, match=engine.value):
        port.blur_u8(x, 2.0, engine=engine)


def test_blur_u8_rejects_bad_inputs():
    with pytest.raises(TypeError):
        port.blur_u8(np.zeros((8, 8, 3), np.uint8), 1.0)
    with pytest.raises(TypeError):
        port.blur_u8(torch.zeros((8, 8, 3), dtype=torch.int16), 1.0)
    with pytest.raises(ValueError):
        port.blur_u8(torch.zeros((8, 8), dtype=torch.uint8), 1.0)
    with pytest.raises(ValueError):
        port.blur_u8(torch.zeros((8, 8, 3), dtype=torch.uint8), (1.0, 2.0, 3.0))


def test_engine_names_match_the_jax_package():
    assert [e.value for e in api.Engine] == [e.value for e in jax_pkg.Engine]
