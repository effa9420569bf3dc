"""The port's ``ops/streamed`` (strip streaming, the ``fft_stream`` engine,
FFT_MXU past its byte budget) and AUTO's streamed rule, against the JAX
package on the CPU.

Limits at 0..255 scale: the tiles streamer within 1e-3 of JAX's (as JAX's
own ``tests/test_streamed.py`` holds it to its whole-frame path), the MXU
streamer (K3f/K3's plain version here) within 2e-2 of JAX's
``blur_fft_mxu_streamed`` (its four-step Pallas kernels in interpret mode,
bf16x3 splits) and of the whole-frame path; uint8 within 1 count of
``oracle.blur_u8`` and of JAX; gradients rtol 1e-5 / atol 1e-4. K3/K3f's
plain version at the cluster form's lengths against JAX's HIGHEST einsum
within 1e-2.
"""

from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from blur_algorithms_tpu import Engine as JEngine  # noqa: E402
from blur_algorithms_tpu import oracle  # noqa: E402
from blur_algorithms_tpu import api as j_api  # noqa: E402
from blur_algorithms_tpu.ops import fft_mxu as j_fft  # noqa: E402
from blur_algorithms_tpu.ops import plan as j_plan  # noqa: E402
from blur_algorithms_tpu.ops import streamed as j_streamed  # noqa: E402
from blur_algorithms_tpu.utils import hw as j_hw  # noqa: E402
import blur_algorithms_tpu_torch as port  # noqa: E402
from blur_algorithms_tpu_torch import api  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fft4step as t_k3  # noqa: E402
from blur_algorithms_tpu_torch.ops import plan as t_plan  # noqa: E402
from blur_algorithms_tpu_torch.ops import streamed as t_streamed  # noqa: E402
from blur_algorithms_tpu_torch.ops.fft_mxu import transform_length  # noqa: E402
from blur_algorithms_tpu_torch.ops.kernels import gaussian_kernel  # noqa: E402
from blur_algorithms_tpu_torch.utils.hw import DeviceSpec, spec_for  # noqa: E402

HIGHEST = jax.lax.Precision.HIGHEST
ASYM_ROW = [0.05, 0.1, 0.5, 0.2, 0.3, -0.1, 0.02]
ASYM_COL = [-0.2, 0.4, 0.9, 0.1, -0.05]


def _plans(spec):
    if len(spec) == 2:
        return t_plan.make_plan(*spec), j_plan.make_plan(*spec)
    shape, tr, tc = spec
    return (t_plan.make_custom_plan(shape, tr, tc),
            j_plan.make_custom_plan(shape, tr, tc))


def _planar(shape, seed):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.float32)


def _u8(shape, seed):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.uint8)


@pytest.mark.parametrize("spec, strip", [
    (((70, 90), 6.0), 16),
    (((70, 90), 6.0), 64),
    (((70, 90), 6.0), 128),  # larger than both axes: one strip each
    (((33, 47), 2.0), 10),  # divides neither axis: the last strip clamps
    (((33, 47), ASYM_ROW, ASYM_COL), 10),  # complex half-spectrum
])
def test_tiles_streamer_against_jax(spec, strip):
    plan, jplan = _plans(spec)
    x = _planar((2, *plan.shape), seed=strip)
    got = t_streamed.blur_fft_tiles_streamed(torch.from_numpy(x), plan, strip)
    assert got.dtype == torch.float32 and got.shape == x.shape
    want = np.asarray(j_streamed.blur_fft_tiles_streamed(jnp.asarray(x), jplan, strip))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
    whole = port.blur(torch.from_numpy(x), spec[1], engine="fft_tiles") if len(spec) == 2 \
        else port.convolve_separable(torch.from_numpy(x), spec[1], spec[2], engine="fft_tiles")
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=0, atol=1e-3)


@pytest.mark.parametrize("shape, sigma, strip", [((40, 56), 4.0, 512), ((53, 47), 3.0, 16)])
def test_tiles_streamer_u8_against_jax_and_oracle(shape, sigma, strip):
    img = _u8((*shape, 3), seed=strip)
    plan, jplan = _plans((shape, sigma))
    planar = torch.from_numpy(img).movedim(-1, -3).contiguous()
    got = t_streamed.blur_fft_tiles_streamed_u8(planar, plan, strip)
    assert got.dtype == torch.uint8 and got.shape == planar.shape
    got = got.movedim(-3, -1).numpy().astype(int)
    want = np.asarray(j_streamed.blur_fft_tiles_streamed_u8(
        jnp.moveaxis(jnp.asarray(img), -1, -3), jplan, strip))
    assert np.abs(got - np.moveaxis(want, 0, -1).astype(int)).max() <= 1
    assert np.abs(got - oracle.blur_u8(img, sigma).astype(int)).max() <= 1


@pytest.mark.parametrize("spec, strip", [(((40, 60), 3.0), 16), (((33, 47), ASYM_ROW, ASYM_COL), 10)])
def test_mxu_streamer_against_jax_interpret_mode(spec, strip):
    """The MXU streamer (K3/K3f's plain version per strip) against the JAX
    one, whose strips run the four-step Pallas kernels in interpret mode,
    and against the port's whole-frame FFT_MXU."""
    plan, jplan = _plans(spec)
    x = _planar((1, *plan.shape), seed=3)
    counts = (t_k3.fft_conv_rows.launches, t_k3.fft_conv_rows_framed.launches)
    got = t_streamed.blur_fft_mxu_streamed(torch.from_numpy(x), plan, strip).numpy()
    assert counts == (t_k3.fft_conv_rows.launches, t_k3.fft_conv_rows_framed.launches)
    want = np.asarray(j_streamed.blur_fft_mxu_streamed(jnp.asarray(x), jplan, strip))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
    whole = t_k3.blur_fft_mxu_cuda(torch.from_numpy(x), plan).numpy()
    np.testing.assert_allclose(got, whole, rtol=0, atol=1e-3)


def test_mxu_streamer_u8_against_oracle():
    img = _u8((2, 45, 70, 3), seed=4)
    plan = t_plan.make_plan((45, 70), 5.0)
    planar = torch.from_numpy(img).movedim(-1, -3).contiguous()
    got = t_streamed.blur_fft_mxu_streamed_u8(planar, plan, 32)
    assert got.dtype == torch.uint8
    got = got.movedim(-3, -1).numpy().astype(int)
    for b in range(2):
        assert np.abs(got[b] - oracle.blur_u8(img[b], 5.0).astype(int)).max() <= 1


@pytest.mark.parametrize("fn", ["blur_fft_tiles_streamed", "blur_fft_mxu_streamed"])
def test_streamed_grad_against_jax_vjp(fn):
    """Backward is the whole-frame adjoint, as JAX's ``_streamed_bwd``."""
    plan, jplan = _plans(((24, 40), ASYM_ROW, ASYM_COL))
    x = _planar((2, 24, 40), seed=5)
    g = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda t: j_streamed.blur_fft_tiles_streamed(t, jplan, 16),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(x).requires_grad_()
    (getattr(t_streamed, fn)(t, plan, 16) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape, sigma", [((1080, 1920), 10.0), ((24000, 14500), 155.0)])
def test_estimate_fft_tiles_bytes_equals_jax(shape, sigma):
    plan, jplan = _plans((shape, sigma))
    assert t_streamed.estimate_fft_tiles_bytes(plan) == \
        j_streamed.estimate_fft_tiles_bytes(jplan)


@pytest.mark.parametrize("n", [32768, 65536])
def test_plain_version_past_16384_against_jax_einsum(n):
    """K3's plain version (what K3/K3f's cluster form is held to on the
    card) at the cluster form's lengths, against JAX's HIGHEST einsum."""
    taps = gaussian_kernel(300.0, 1801)
    plan, jplan = _plans(((8, n), taps, [1.0]))
    rows = _planar((3, n), seed=n)
    got = t_k3.fft_conv_rows(torch.from_numpy(rows), n, plan.row).numpy()
    want = np.asarray(j_fft._conv_rows_einsum(jnp.asarray(rows), n, jplan.row, HIGHEST))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)


class _Budgets:
    """The JAX budget set with some fields replaced."""

    def __init__(self, base, **fields):
        self._base = base
        self.__dict__.update(fields)

    def __getattr__(self, name):
        return getattr(self._base, name)


_ROUTES = [
    ((200, 300), 10.0, 100, 80, (100, 80), 80 << 30),  # r 32 under both
    ((200, 1300), 200.0, 600, 600, (600, 600), 80 << 30),  # r 650 past: FFT_MXU
    ((200, 1300), 200.0, 700, 700, (700, 700), 80 << 30),  # under: the split
    ((200, 1300), 200.0, 600, 600, (700, 700), 1 << 16),  # streams, under its crossover
    ((200, 1300), 200.0, 600, 600, (640, 640), 1 << 16),  # streams, past it
    ((200, 1300), 200.0, 600, 600, (700, 700), 80 << 30),  # no stream: its crossover unread
    ((2, 140000), 200.0, 600, 600, (600, 600), 80 << 30),  # rows past n 131072: FFT_MXU
]


# float at r 4992 on a giant frame, past the split's budget: no fused tile
# in either package (uint8 there JAX's int8 single kernel fits a TPU's VMEM,
# a domain the port's fused engine, the split to r 4096, does not have)
@pytest.mark.parametrize("shape, sigma, u8x, f32x, streamed, budget, split_budget, in_bytes", [
    *((*case, 80 << 30, b) for case in _ROUTES for b in (1, 4)),
    ((24000, 14500), 1500.0, 5000, 5000, (5000, 5000), 1 << 40, 1 << 16, 4),
])
def test_auto_follows_the_jax_rule(monkeypatch, shape, sigma, u8x, f32x, streamed, budget,
                                   split_budget, in_bytes):
    """AUTO's choice against JAX ``_resolve_engine`` under equal crossovers
    and budgets (three planes: the JAX rule's estimate)."""
    fields = dict(auto_fused_max_radius_u8=u8x, auto_fused_max_radius_f32=f32x,
                  auto_fused_max_radius_u8_streamed=streamed[0],
                  auto_fused_max_radius_f32_streamed=streamed[1],
                  fft_mxu_byte_budget=budget, split_hbm_budget=split_budget)
    base = j_hw.spec_for_kind("TPU v5 lite")
    monkeypatch.setattr(j_hw, "budgets", lambda: _Budgets(base, **fields))
    spec = DeviceSpec(name="test card", sm_count=132, smem_optin_bytes=232448, **fields)
    plan, jplan = _plans((shape, sigma))
    got = api._resolve_with_spec("auto", plan, in_bytes, spec, 3)
    want = j_api._resolve_engine(JEngine.AUTO, jplan, in_bytes)
    assert got.value == want.value


@pytest.mark.parametrize("lead, budget, want", [
    (3, 1 << 16, "fft_mxu"),  # streams: the streamed crossover (500) holds
    (3, 80 << 30, "fused"),  # no stream: the whole-frame crossover (700)
])
def test_auto_reads_a_streamed_crossover_under_the_whole_frame_one(lead, budget, want):
    """Where the streamed crossover is the lower (the split loses to the
    streamer earlier than to the whole-frame FFT), AUTO reads it wherever
    FFT_MXU streams; JAX reads it only past the whole-frame crossover."""
    spec = DeviceSpec(name="test card", sm_count=132, smem_optin_bytes=232448,
                      auto_fused_max_radius_u8=700, auto_fused_max_radius_f32=700,
                      auto_fused_max_radius_u8_streamed=500,
                      auto_fused_max_radius_f32_streamed=500,
                      fft_mxu_byte_budget=budget)
    plan = t_plan.make_plan((200, 1300), 200.0)  # r 665
    for in_bytes in (1, 4):
        assert api._resolve_with_spec("auto", plan, in_bytes, spec, lead).value == want


def test_streamed_crossovers_by_device_name():
    """The H100's from the sweep (uint8 under its whole-frame crossover,
    float over it); an unmeasured card takes its whole-frame values."""
    h100 = spec_for("NVIDIA H100 80GB HBM3", 132, 232448, 80 << 30)
    assert (h100.auto_fused_max_radius_u8_streamed,
            h100.auto_fused_max_radius_f32_streamed) == (1397, 232)
    assert h100.auto_fused_max_radius_u8_streamed < h100.auto_fused_max_radius_u8
    assert h100.auto_fused_max_radius_f32_streamed > h100.auto_fused_max_radius_f32
    other = spec_for("unmeasured card", 132, 232448, 80 << 30)
    assert (other.auto_fused_max_radius_u8_streamed,
            other.auto_fused_max_radius_f32_streamed) == (
        other.auto_fused_max_radius_u8, other.auto_fused_max_radius_f32)


def test_auto_past_the_longest_transform_takes_the_split(monkeypatch):
    """AUTO past transform length 131072 takes FFT_MXU, as the JAX
    ``_resolve_engine`` does (a row of 140000 at r 665: n 262144, K3f's
    wide cluster form; JAX's rule under the CPU spec's crossovers and budgets),
    within 2e-2 of ``torch.fft`` (the fft_tiles engine)."""
    x = torch.from_numpy(_planar((1, 2, 140000), seed=21))
    plan, jplan = _plans(((2, 140000), 200.0))
    assert t_k3.kernel_length(262144) and transform_length(plan.row) == 262144
    spec = api.device_spec("cpu")
    base = j_hw.spec_for_kind("TPU v5 lite")
    monkeypatch.setattr(j_hw, "budgets", lambda: _Budgets(base, **{
        f: getattr(spec, f) for f in (
            "auto_fused_max_radius_u8", "auto_fused_max_radius_f32",
            "auto_fused_max_radius_u8_streamed", "auto_fused_max_radius_f32_streamed",
            "fft_mxu_byte_budget", "split_hbm_budget")}))
    got_engine = api._resolve_engine("auto", plan, 4, "cpu", 3)
    assert got_engine is api.Engine.FFT_MXU
    assert j_api._resolve_engine(JEngine.AUTO, jplan, 4).value == got_engine.value
    ran, real = [], api.blur_fft_mxu_cuda
    with mock.patch.object(api, "blur_fft_mxu_cuda", lambda *a: ran.append(1) or real(*a)):
        got = port.blur(x, 200.0)
    assert ran == [1]
    want = port.blur(x, 200.0, engine="fft_tiles")
    torch.testing.assert_close(got, want, rtol=0, atol=2e-2)


def test_fft_stream_engine_against_jax_api():
    img = _u8((2, 36, 52, 3), seed=7)
    got = port.blur_u8(torch.from_numpy(img), 4.0, engine="fft_stream").numpy().astype(int)
    from blur_algorithms_tpu import blur_u8 as j_blur_u8

    want = np.asarray(j_blur_u8(jnp.asarray(img), 4.0, engine="fft_stream")).astype(int)
    assert np.abs(got - want).max() <= 1
    x = _planar((3, 36, 52), seed=8)
    got = port.blur(torch.from_numpy(x), 4.0, engine="fft_stream").numpy()
    from blur_algorithms_tpu import blur as j_blur

    np.testing.assert_allclose(got, np.asarray(j_blur(jnp.asarray(x), 4.0, engine="fft_stream")),
                               rtol=0, atol=1e-3)
