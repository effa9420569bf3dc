"""The port's slice 1 as a whole: ``blur_u8`` AUTO against the JAX package.

On the CPU the port's ``blur_u8`` runs the plain version of K1. It must be
bit-equal to the JAX int8 DMA kernel (interpret mode) after the layout
moves, and within 1 count of JAX ``blur_u8`` (which off a TPU runs the
blocked f32 band path) and of the NumPy oracle. Every call outside the
port's domain raises ``NotImplementedError``. Slice 2 (the float path,
custom taps, box blur, precision pins) is tested in
``test_torch_float_path.py``, slice 3 (the FFT engines) in
``test_torch_fft_mxu.py`` and ``test_torch_fft_conv.py``.
"""

from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402
import blur_algorithms_tpu as jax_pkg  # noqa: E402
import blur_algorithms_tpu_torch as port  # noqa: E402
from blur_algorithms_tpu import oracle  # noqa: E402
from blur_algorithms_tpu.ops.plan import make_plan as j_make_plan  # noqa: E402
from blur_algorithms_tpu.pallas_kernels import fused_dma as j_dma  # noqa: E402
from blur_algorithms_tpu_torch import api  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fused_dma as t_dma  # noqa: E402
from blur_algorithms_tpu_torch.utils.frames import make_frames  # noqa: E402
from blur_algorithms_tpu_torch.utils.hw import DeviceSpec, device_spec  # noqa: E402


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


def _served_split_u8(x):
    # r 650 on the rows of a thin frame: the int8 two-pass split
    img = x[:, :24].contiguous()
    got = port.blur_u8(img, 200.0, engine="fused")
    want = oracle.blur_u8(img[0].numpy(), 200.0)
    assert np.abs(got[0].numpy().astype(int) - want.astype(int)).max() <= 1


def _served_split_f32(x):
    # an FFT_MXU transform past 16384: K3f's cluster form (its plain
    # version here) since it was ported, the split before
    out = api.blur(torch.zeros(()).expand(1, 8, 20000), 200.0)
    assert out.shape == (1, 8, 20000) and not bool(out.abs().max())


def _served_box_scan(x):
    # box support radius 1250 > 600: the scan, K4's plain version here
    out = api.box_blur(x, 25.0)
    assert out.shape == x.shape and out.dtype == torch.uint8
    assert not bool(out.any())


def _served_hybrid_pin(x):
    # K1's hybrid body: its plain version here, a constant frame stays constant
    out = port.blur_u8(x + 9, 3.0, precision="hybrid")
    assert out.shape == x.shape and out.dtype == torch.uint8
    assert bool((out == 9).all())


def _past_both_budgets(device):
    """A spec whose FFT_MXU and split budgets the thin frames below exceed."""
    return DeviceSpec(name="cpu", sm_count=0, smem_optin_bytes=0,
                      fft_mxu_byte_budget=1 << 16, split_hbm_budget=1 << 16)


def _served_streamed_u8(x):
    # AUTO past r 600 and past both budgets: strip-streamed FFT_MXU (the
    # plain version of K3f here), within 1 count of the oracle
    img = torch.from_numpy(_frames((1, 24, 1300, 3), seed=12))
    ran, real = [], api.blur_fft_mxu_streamed_u8
    with mock.patch.object(api, "device_spec", _past_both_budgets), mock.patch.object(
            api, "blur_fft_mxu_streamed_u8", lambda *a: ran.append(1) or real(*a)):
        assert api._resolve_engine("auto", port.make_plan((24, 1300), 200.0), 1, "cpu",
                                   3) is api.Engine.FFT_MXU
        got = port.blur_u8(img, 200.0)
    assert ran == [1]
    want = oracle.blur_u8(img[0].numpy(), 200.0)
    assert np.abs(got[0].numpy().astype(int) - want.astype(int)).max() <= 1


def _served_streamed_f32(x):
    # the same on float planes: within 2e-2 of the whole-frame FFT_MXU
    planes = torch.from_numpy(_frames((1, 24, 1300, 3), seed=13)[0]).movedim(-1, 0).float()
    ran, real = [], api.blur_fft_mxu_streamed
    with mock.patch.object(api, "device_spec", _past_both_budgets), mock.patch.object(
            api, "blur_fft_mxu_streamed", lambda *a: ran.append(1) or real(*a)):
        got = api.blur(planes, 200.0)
    assert ran == [1]
    want = api.blur(planes, 200.0, engine="fft_mxu")  # not past the CPU's budget
    torch.testing.assert_close(got, want, rtol=0, atol=2e-2)


def _served_past_the_cluster_form(x):
    # rows of 270000 at sigma 3 (n 524288): zero rows blur to zeros
    out = api.blur(torch.zeros(()).expand(1, 2, 270000), 3.0, engine="fft_mxu")
    assert out.shape == (1, 2, 270000) and not bool(out.abs().max())


_SERVED = (_served_split_u8, _served_split_f32, _served_box_scan, _served_hybrid_pin,
           _served_streamed_u8, _served_streamed_f32, _served_past_the_cluster_form)


@pytest.mark.parametrize("call", [
    # AUTO past radius 600 and past FFT_MXU's byte budget and the split's:
    # strip-streamed FFT_MXU since ops/streamed was ported (these cases keep
    # their ids and hold the result, on thin frames under patched budgets)
    pytest.param(_served_streamed_u8, id="<lambda>0"),
    pytest.param(_served_split_u8, id="<lambda>1"),
    pytest.param(_served_split_f32, id="<lambda>2"),
    pytest.param(_served_hybrid_pin, id="<lambda>3"),
    # float past radius 600 and past both budgets
    pytest.param(_served_streamed_f32, id="<lambda>4"),
    pytest.param(_served_box_scan, id="<lambda>5"),
    # past the cluster form's longest transform: K3f's staged form since it
    # was ported (its plain version here)
    pytest.param(_served_past_the_cluster_form, id="<lambda>6"),
])
def test_outside_the_domain_raises(call):
    """Calls outside the port's domain raise; the cases that later slices
    serve (the split past r 600, K4 past r 600, the hybrid pin) hold their
    results."""
    x = torch.zeros((1, 1300, 1300, 3), dtype=torch.uint8)  # sigma 200: r = 650
    if call in _SERVED:
        call(x)
        return
    with pytest.raises(NotImplementedError):
        call(x)


@pytest.mark.parametrize("engine", [
    api.Engine.FFT_STREAM, api.Engine.BOX, api.Engine.BOX_SCAN, api.Engine.CONV,
    api.Engine.CASCADE, api.Engine.DERICHE,
])
def test_unported_engines_raise(engine):
    """Every engine of this list raised once; each is ported now and keeps
    a constant frame constant (deriche at its smallest sigma, 16, on a
    frame that holds its reflect pad)."""
    x = torch.zeros((20, 30, 3), dtype=torch.uint8)
    sigma = 2.0
    if engine is api.Engine.DERICHE:
        x, sigma = torch.zeros((80, 90, 3), dtype=torch.uint8), 16.0
        # the engine names its domain where the frame cannot hold the pad
        with pytest.raises(ValueError, match="deriche"):
            port.blur_u8(x + 7, sigma, engine=engine)
        x = torch.zeros((260, 270, 3), dtype=torch.uint8)
    out = port.blur_u8(x + 7, sigma, engine=engine)
    assert out.shape == x.shape and bool((out == 7).all())


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


def test_make_frames_is_bench_make_frames_bit_for_bit():
    """The port's copy of the benchmark frames (``chip_smoke.py`` drives
    them) equals ``bench.make_frames``."""
    for shape in ((2, 48, 80), (1, 7, 5)):
        want = bench.make_frames(*shape)
        got = make_frames(*shape)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_int8_pin_runs_k1_int8_where_it_applies(monkeypatch):
    """On the H100's spec the uint8 split runs from r 82 (with the hybrid
    pass 2 there); the ``precision="int8"`` pin still runs K1's exact int8 body
    wherever ``dma_form_applicable`` holds, as the JAX pin does, and equals
    what JAX ``blur_u8(..., precision="int8")`` runs there,
    ``fused_dma.blur_fused_u8_dma(..., precision="int8")`` (interpret mode),
    bit for bit. (Off a TPU, the JAX ``dma_form_applicable`` is False and
    its pin runs the blocked int8 kernel: within 1 count.)"""
    from blur_algorithms_tpu_torch.cuda_kernels import fused_blur as t_fused
    from blur_algorithms_tpu_torch.utils.hw import spec_for

    spec = spec_for("NVIDIA H100 80GB HBM3", 132, 232448, 80 << 30)
    monkeypatch.setattr(api, "device_spec", lambda device: spec)
    monkeypatch.setattr(t_fused, "device_spec", lambda device: spec)
    plan = port.make_plan((192, 256), 26.0)
    assert plan.row.support_radius == 85
    assert t_fused._split_wins(plan, 1, "int8", "cpu")  # AUTO would split here
    calls = []
    real = api.blur_fused_u8_dma

    def k1(*args, **kw):
        calls.append(kw.get("precision"))
        return real(*args, **kw)

    def split(*args, **kw):
        raise AssertionError("the int8 pin ran the split")

    monkeypatch.setattr(api, "blur_fused_u8_dma", k1)
    monkeypatch.setattr(t_fused, "_blur_fused_split", split)
    img = _frames((1, 192, 256, 3), seed=12)[0]
    got = port.blur_u8(torch.from_numpy(img), 26.0, precision="int8")
    assert calls == ["int8"]
    planar = jnp.asarray(np.moveaxis(img, -1, -3))
    want = j_dma.blur_fused_u8_dma(planar, j_make_plan((192, 256), 26.0), precision="int8")
    np.testing.assert_array_equal(got.numpy(), np.moveaxis(np.asarray(want), -3, -1))
    blocked = np.asarray(jax_pkg.blur_u8(jnp.asarray(img), 26.0, precision="int8"))
    assert np.abs(got.numpy().astype(int) - blocked.astype(int)).max() <= 1
