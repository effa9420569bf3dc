"""The FFT_MXU engine of the port: the four-step constants, K3 and K3f's
plain versions, the adjoint's wide branch, AUTO past the fused crossover,
against the JAX package on the CPU.

The JAX Pallas kernels run in interpret mode (as the JAX package's own
tests run them off a TPU); they compute in bf16x3 splits, the port's plain
versions in full float32. Limits at 0..255 scale: plain K3 / K3f against
the Pallas kernels within 5e-2 (the JAX package's framed-vs-einsum bound,
``tests/test_fft_mxu.py``), against JAX's full-float32 einsum within 1e-2;
blurs within 2e-2 (the JAX bound for its FFT engines); uint8 within 1
count; gradients within rtol 1e-5 / atol 1e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import blur_algorithms_tpu as jax_pkg  # noqa: E402
import blur_algorithms_tpu_torch as port  # noqa: E402
from blur_algorithms_tpu import oracle  # noqa: E402
from blur_algorithms_tpu.ops import adjoint as j_adjoint  # noqa: E402
from blur_algorithms_tpu.ops import fft_mxu as j_fft  # noqa: E402
from blur_algorithms_tpu.ops import plan as j_plan  # noqa: E402
from blur_algorithms_tpu.pallas_kernels import fft4step as j_k3  # noqa: E402
from blur_algorithms_tpu_torch import api  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fft4step as t_k3  # noqa: E402
from blur_algorithms_tpu_torch.ops import adjoint as t_adjoint  # noqa: E402
from blur_algorithms_tpu_torch.ops import fft_mxu as t_fft  # noqa: E402
from blur_algorithms_tpu_torch.ops import plan as t_plan  # noqa: E402
from blur_algorithms_tpu_torch.ops.kernels import gaussian_kernel  # noqa: E402
from blur_algorithms_tpu_torch.utils.hw import DeviceSpec  # noqa: E402

HIGHEST = jax.lax.Precision.HIGHEST
ASYM_ROW = [0.05, 0.1, 0.5, 0.2, 0.3, -0.1, 0.02]
ASYM_COL = [-0.2, 0.4, 0.9, 0.1, -0.05]


def _wide_asym(width: int) -> np.ndarray:
    """Asymmetric unit-sum taps of odd ``width``: a Gaussian on a ramp."""
    t = gaussian_kernel(width / 6.0, width).astype(np.float64)
    t *= np.linspace(0.6, 1.4, width)
    return (t / t.sum()).astype(np.float32)


def _plans(spec):
    """(port plan, JAX plan) from ``(shape, sigma)`` or
    ``(shape, taps_row, taps_col)``."""
    if len(spec) == 2:
        return t_plan.make_plan(*spec), j_plan.make_plan(*spec)
    shape, tr, tc = spec
    return (t_plan.make_custom_plan(shape, tr, tc),
            j_plan.make_custom_plan(shape, tr, tc))


def _planar(shape, seed):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.float32)


def _frames(shape, seed):
    rng = np.random.default_rng(seed)
    b, h, w, c = shape
    yy, xx = np.mgrid[0:h, 0:w]
    base = 127 + 80 * np.sin(xx / 7.0) + 60 * np.cos(yy / 11.0)
    img = base[None, :, :, None] + rng.normal(0, 25, (b, h, w, c))
    return np.clip(img, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# host constants


@pytest.mark.parametrize("n", [256, 512, 1024, 2048, 4096, 5120, 6144, 7168,
                               15360, 16384, 32768])
def test_factor_and_stage_consts_equal_jax(n):
    assert t_fft._factor(n) == j_fft._factor(n)
    factors = [None] + ([(n // 128, 128)] if t_k3.framed_applicable(n) else [])
    for f in factors:
        got, want = t_fft._stage_consts(n, f), j_fft._stage_consts(n, f)
        assert got[:2] == want[:2]
        for a, b in zip(got[2:], want[2:]):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("need", [256, 300, 1000, 2048, 2176, 4096, 4097, 4902,
                                  8000, 12289, 15360, 16384, 16385, 20000])
def test_transform_length_and_bytes_equal_jax(need):
    pad = min(100, need // 4)
    taps = gaussian_kernel(pad / 3.0, 2 * pad + 1)
    plan, jplan = _plans(((9, need - 2 * pad), taps, [1.0]))
    assert plan.row.dim + 2 * plan.row.pad == need
    assert t_fft.transform_length(plan.row) == j_fft.transform_length(jplan.row)
    for lead in (1, 3, 12):
        assert t_fft.estimate_bytes(plan, lead) == j_fft.estimate_bytes(jplan, lead)


@pytest.mark.parametrize("n", [256, 512, 4096, 6144])
@pytest.mark.parametrize("taps", ["symmetric", "asymmetric"])
def test_perm_spectrum_equals_jax(n, taps):
    t = gaussian_kernel(9.0, 41) if taps == "symmetric" else _wide_asym(41)
    plan, jplan = _plans(((8, 300), t, [1.0]))
    factors = [None] + ([(n // 128, 128)] if t_k3.framed_applicable(n) else [])
    for f in factors:
        got = t_fft._perm_spectrum_c(plan.row, n, f)
        want = j_fft._perm_spectrum_c(jplan.row, n, f)
        np.testing.assert_array_equal(got[0], want[0])
        if taps == "symmetric":
            assert got[1] is None and want[1] is None
        else:
            np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("n", [256, 2048, 2176, 3968, 4096, 5120, 15360, 16384, 32768])
def test_framed_applicable_equals_jax(n):
    assert t_k3.framed_applicable(n) == j_k3.framed_applicable(n)


@pytest.mark.parametrize("n", [256, 512, 2048, 6144, 7168, 11264, 15360, 16384, 32768, 65536])
def test_kernel_bin_order_is_the_digit_reversed_dif_output(n):
    """A NumPy model of the kernel's forward passes (``csrc/fft4step.cu``:
    decimation in frequency, past 16384 the cluster pass's radix C first,
    radix Q, then radix R0, then radix-32 passes,
    each leaving digit q of its R-point DFT at base + q s) leaves frequency
    ``_kernel_bin_order(n)[p]`` at position p."""
    radices = t_k3._radices(n)
    assert radices[-1] == 32 and np.prod(radices) == n
    assert all(r in (3, 5, 7, 9, 11, 13, 15) for r in radices[:-2] if r % 2)
    x = np.array([1, 1j]) @ np.random.default_rng(n).standard_normal((2, n))
    span = n
    for r in t_k3._radices(n):
        s = span // r
        cube = x.reshape(n // span, r, s)
        q = np.arange(r)
        y = np.einsum("qm,bmj->bqj", np.exp(-2j * np.pi * np.outer(q, q) / r), cube)
        x = (y * np.exp(-2j * np.pi * np.outer(q, np.arange(s)) / span)).reshape(n)
        span = s
    want = np.fft.fft(np.array([1, 1j]) @ np.random.default_rng(n).standard_normal((2, n)))
    np.testing.assert_allclose(x, want[t_k3._kernel_bin_order(n)], atol=1e-8 * n)


# ---------------------------------------------------------------------------
# K3 and K3f: plain versions against the Pallas kernels


@pytest.mark.parametrize("n", [256, 512])
@pytest.mark.parametrize("taps", ["symmetric", "asymmetric"])
def test_k3_plain_against_pallas_and_einsum(n, taps):
    t = gaussian_kernel(8.0, 51) if taps == "symmetric" else _wide_asym(51)
    plan, jplan = _plans(((8, 200), t, [1.0]))
    rows = _planar((7, n), seed=n)  # odd R: a zero row rides along
    got = t_k3.fft_conv_rows(torch.from_numpy(rows), n, plan.row).numpy()
    assert got.shape == rows.shape
    pallas = np.asarray(j_k3._conv_rows_pallas(jnp.asarray(rows), n, jplan.row))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=5e-2)
    einsum = np.asarray(j_fft._conv_rows_einsum(jnp.asarray(rows), n, jplan.row, HIGHEST))
    np.testing.assert_allclose(got, einsum, rtol=0, atol=1e-2)


@pytest.mark.parametrize("taps", ["symmetric", "asymmetric"])
def test_k3f_plain_against_pallas_framed_and_einsum(taps):
    """n = 4096: rows of dim 1100 at sigma 400 (pad 550)."""
    shape = (4, 1100)
    if taps == "symmetric":
        plan, jplan = _plans((shape, 400.0))
    else:
        plan, jplan = _plans((shape, _wide_asym(1101), [1.0]))
    n = t_fft.transform_length(plan.row)
    assert n == 4096 and t_k3.framed_applicable(n)
    rows = _planar((5, 1100), seed=3)
    got = t_k3.fft_conv_rows_framed(torch.from_numpy(rows), n, plan.row).numpy()
    pallas = np.asarray(j_k3._conv_rows_pallas_framed(jnp.asarray(rows), n, jplan.row))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=5e-2)
    einsum = np.asarray(j_fft.conv_axis(
        jnp.asarray(rows), jplan.row, -1,
        lambda r, m, ap: j_fft._conv_rows_einsum(r, m, ap, HIGHEST)))
    np.testing.assert_allclose(got, einsum, rtol=0, atol=1e-2)


def test_k3_wrappers_on_cpu_count_no_launch_and_reject_bad_inputs():
    plan = t_plan.make_plan((4, 1100), 400.0)
    rows = torch.from_numpy(_planar((3, 1100), seed=4))
    k3, k3f = t_k3.fft_conv_rows.launches, t_k3.fft_conv_rows_framed.launches
    out = t_k3.fft_conv_rows_framed(rows, 4096, plan.row)
    assert torch.equal(out, t_k3.fft_conv_rows_framed_ref(rows, 4096, plan.row))
    t_k3.fft_conv_rows(torch.zeros((3, 256)), 256, plan.col)
    assert (t_k3.fft_conv_rows.launches, t_k3.fft_conv_rows_framed.launches) == (k3, k3f)
    with pytest.raises(TypeError):
        t_k3.fft_conv_rows(torch.zeros((3, 256), dtype=torch.float64), 256, plan.row)
    with pytest.raises(ValueError):
        t_k3.fft_conv_rows(torch.zeros((3, 255)), 256, plan.row)
    with pytest.raises(ValueError):
        t_k3.fft_conv_rows_framed(rows, 8192, plan.row)  # not the axis length
    with pytest.raises(ValueError):  # neither CUDA nor CPU: no silent move
        t_k3.fft_conv_rows(torch.zeros((3, 256), device="meta"), 256, plan.row)
    # the cluster form's lengths (32768 .. 262144) and, past 262144, the
    # staged form's: the plain version on the CPU, no launch of any form
    counts = (t_k3.fft_conv_rows.cluster_launches, t_k3.fft_conv_rows_framed.cluster_launches,
              t_k3.fft_conv_rows.staged_launches, t_k3.fft_conv_rows_framed.staged_launches)
    t_k3.fft_conv_rows(torch.zeros((3, 32768)), 32768, plan.row)
    out = t_k3.fft_conv_rows(torch.zeros((3, 262144)), 262144, plan.row)
    assert out.shape == (3, 262144) and not bool(out.abs().max())
    out = t_k3.fft_conv_rows(torch.zeros((1, 524288)), 524288, plan.row)
    assert out.shape == (1, 524288) and not bool(out.abs().max())
    assert (t_k3.fft_conv_rows.launches, t_k3.fft_conv_rows.cluster_launches,
            t_k3.fft_conv_rows_framed.cluster_launches, t_k3.fft_conv_rows.staged_launches,
            t_k3.fft_conv_rows_framed.staged_launches) == (k3, *counts)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        t_k3.fft_conv_rows(torch.zeros((3, 32768), device="meta"), 32768, plan.row)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        t_k3.fft_conv_rows(torch.zeros((3, 262144), device="meta"), 262144, plan.row)


@pytest.mark.parametrize("framed", [False, True])
def test_k3_staged_lengths_take_zero_rows(framed):
    """No rows at a length of the staged form (n 524288): a (0, dim) result
    and no launch counted; on neither CUDA nor the CPU still a raise."""
    n = 524288
    dim = 300000 if framed else n
    plan = t_plan.make_plan((4, 300000), 200.0)
    assert t_fft.transform_length(plan.row) == n
    fn = t_k3.fft_conv_rows_framed if framed else t_k3.fft_conv_rows
    before = (fn.launches, fn.cluster_launches, fn.staged_launches)
    out = fn(torch.zeros((0, dim)), n, plan.row)
    assert out.shape == (0, dim) and out.dtype == torch.float32
    assert (fn.launches, fn.cluster_launches, fn.staged_launches) == before
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fn(torch.zeros((0, dim), device="meta"), n, plan.row)


# ---------------------------------------------------------------------------
# the engine: forward, uint8, gradients, routing


@pytest.mark.parametrize("spec", [
    ((50, 70), 5.0),
    ((40, 300), (3.0, 60.0)),
    ((33, 47), ASYM_ROW, ASYM_COL),
    ((4, 1100), 400.0),  # K3f's geometry on the rows axis
])
def test_blur_fft_mxu_against_jax_and_oracle(spec):
    plan, jplan = _plans(spec)
    x = _planar((2, *plan.shape), seed=5)
    if len(spec) == 2:
        got = port.blur(torch.from_numpy(x), spec[1], engine="fft_mxu")
    else:
        got = port.convolve_separable(torch.from_numpy(x), spec[1], spec[2],
                                      engine="fft_mxu")
    assert got.dtype == torch.float32 and got.shape == x.shape
    got = got.numpy()
    want = np.asarray(j_fft.blur_fft_mxu(jnp.asarray(x), jplan, precision=HIGHEST))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
    np.testing.assert_allclose(got, oracle.blur_direct(x, jplan), rtol=0, atol=2e-2)
    if len(spec) == 2:
        api_jax = np.asarray(jax_pkg.blur(jnp.asarray(x), spec[1], engine="fft_mxu"))
        np.testing.assert_allclose(got, api_jax, rtol=0, atol=2e-2)


@pytest.mark.parametrize("sigma", [4.0, (2.0, 9.0)])
def test_blur_u8_fft_mxu_against_jax_and_oracle(sigma):
    img = _frames((2, 40, 96, 3), seed=6)
    got = port.blur_u8(torch.from_numpy(img), sigma, engine="fft_mxu")
    assert got.dtype == torch.uint8 and got.shape == img.shape
    got = got.numpy().astype(int)
    want = np.asarray(jax_pkg.blur_u8(jnp.asarray(img), sigma, engine="fft_mxu"))
    assert np.abs(got - want.astype(int)).max() <= 1
    for b in range(img.shape[0]):
        assert np.abs(got[b] - oracle.blur_u8(img[b], sigma).astype(int)).max() <= 1


@pytest.mark.parametrize("spec", [((20, 30), 2.0), ((24, 40), ASYM_ROW, ASYM_COL)])
def test_blur_fft_mxu_grad_against_jax_vjp(spec):
    """The autograd Function's backward (the adjoint) against ``jax.vjp``
    of the JAX ``blur_fft_mxu_pallas`` (its ``custom_vjp``)."""
    plan, jplan = _plans(spec)
    x = _planar((2, *plan.shape), seed=7)
    g = np.random.default_rng(8).standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda t: j_k3.blur_fft_mxu_pallas(t, jplan), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(x).requires_grad_()
    (t_k3.blur_fft_mxu_cuda(t, plan) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    # the public entry takes the same path
    t2 = torch.from_numpy(x).requires_grad_()
    if len(spec) == 2:
        out = port.blur(t2, spec[1], engine="fft_mxu")
    else:
        out = port.convolve_separable(t2, spec[1], spec[2], engine="fft_mxu")
    (out * torch.from_numpy(g)).sum().backward()
    assert torch.equal(t2.grad, t.grad)


def test_adjoint_wide_branch_against_jax():
    """Past support radius 1024 a symmetric axis goes through the FFT
    (K3's plain version here): a (1, 4, 1100) plane, row radius 1049."""
    plan, jplan = _plans(((4, 1100), gaussian_kernel(400.0, 2099), [0.25, 0.5, 0.25]))
    assert plan.row.support_radius > t_adjoint._ADJOINT_FFT_MIN_RADIUS
    ct = np.random.default_rng(9).standard_normal((1, 4, 1100)).astype(np.float32)
    got = t_adjoint.blur_adjoint(torch.from_numpy(ct), plan).numpy()
    want = np.asarray(j_adjoint.blur_adjoint(jnp.asarray(ct), jplan))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_fft_mxu_past_the_cluster_form_against_jax_and_oracle():
    """A row of 270000 at sigma 200 (r 665: n 524288, a length of K3f's
    staged form; its plain version here): ``blur(engine="fft_mxu")``
    against the JAX API's FFT_MXU and the direct oracle within 2e-2, and
    ``blur_u8`` against the JAX ``blur_u8`` within 1 count."""
    plan, jplan = _plans(((1, 270000), 200.0))
    assert t_fft.transform_length(plan.row) == 524288 > t_k3.CLUSTER_LONGEST
    x = _planar((1, 1, 270000), seed=22)
    got = port.blur(torch.from_numpy(x), 200.0, engine="fft_mxu")
    assert got.dtype == torch.float32 and got.shape == x.shape
    got = got.numpy()
    want = np.asarray(jax_pkg.blur(jnp.asarray(x), 200.0, engine="fft_mxu"))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
    np.testing.assert_allclose(got, oracle.blur_direct(x, jplan), rtol=0, atol=2e-2)
    img = _frames((1, 1, 270000, 1), seed=23)
    got = port.blur_u8(torch.from_numpy(img), 200.0, engine="fft_mxu")
    assert got.dtype == torch.uint8 and got.shape == img.shape
    want = np.asarray(jax_pkg.blur_u8(jnp.asarray(img), 200.0, engine="fft_mxu"))
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1


def test_adjoint_wide_branch_past_the_cluster_form_against_jax(monkeypatch):
    """The adjoint's wide branch with its padded rows past 262144: a (1, 1,
    270000) plane at row radius 1131 (270000 + 4 r: n 524288, a length of
    K3's staged form; its plain version here) against the JAX
    ``blur_adjoint``."""
    plan, jplan = _plans(((1, 270000), (1.0, 340.0)))
    r = plan.row.support_radius
    assert r > t_adjoint._ADJOINT_FFT_MIN_RADIUS and plan.row.symmetric
    lengths, real = [], t_k3.fft_conv_rows
    monkeypatch.setattr(t_k3, "fft_conv_rows", lambda rows, n, p: lengths.append(n) or real(
        rows, n, p))
    ct = np.random.default_rng(24).standard_normal((1, 1, 270000)).astype(np.float32)
    got = t_adjoint.blur_adjoint(torch.from_numpy(ct), plan).numpy()
    assert lengths == [524288]
    want = np.asarray(j_adjoint.blur_adjoint(jnp.asarray(ct), jplan))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def _spec(u8: int, f32: int, budget: int = 80 << 30) -> DeviceSpec:
    return DeviceSpec(name="test card", sm_count=132, smem_optin_bytes=232448,
                      fft_mxu_byte_budget=budget, auto_fused_max_radius_u8=u8,
                      auto_fused_max_radius_f32=f32)


@pytest.mark.parametrize("spec, in_bytes, lead, want", [
    (_spec(100, 80), 1, 12, "fused"),  # r 32 <= both crossovers
    (_spec(20, 600), 1, 12, "fft_mxu"),  # past the uint8 crossover
    (_spec(600, 20), 1, 12, "fused"),  # the float crossover does not apply
    (_spec(600, 20), 4, 12, "fft_mxu"),
    (_spec(20, 20, budget=1 << 20), 4, 12, "fused"),  # FFT over budget, r <= 600
])
def test_resolve_engine_past_the_crossover(monkeypatch, spec, in_bytes, lead, want):
    monkeypatch.setattr(api, "device_spec", lambda device: spec)
    plan = t_plan.make_plan((2160, 3840), 10.0)  # r = 32
    assert api._resolve_engine("auto", plan, in_bytes, "cpu", lead).value == want


def test_resolve_engine_on_the_cpu_keeps_the_fused_domain():
    """The CPU has no measured crossover: fused up to radius 600, FFT_MXU
    past it (the H100's crossover is in utils/hw.py)."""
    assert api._resolve_engine("auto", t_plan.make_plan((1400, 1400), 180.0)) \
        is api.Engine.FUSED
    wide = t_plan.make_plan((1400, 1400), 200.0)  # r = 665
    assert api._resolve_engine("auto", wide) is api.Engine.FFT_MXU
    assert api._resolve_engine("auto", wide, 4) is api.Engine.FFT_MXU


def _tiny_budget(device):
    return DeviceSpec(name="cpu", sm_count=0, smem_optin_bytes=0, fft_mxu_byte_budget=1 << 16)


def _streamed(monkeypatch, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` under a byte budget the frame exceeds; the
    streamer's calls counted."""
    ran = []
    for name in ("blur_fft_mxu_streamed", "blur_fft_mxu_streamed_u8"):
        real = getattr(api, name)
        monkeypatch.setattr(api, name, lambda *a, _real=real, _n=name: ran.append(_n)
                            or _real(*a))
    monkeypatch.setattr(api, "device_spec", _tiny_budget)
    return fn(*args, **kwargs), ran


def _served_u8_auto(monkeypatch):
    img = _frames((2, 24, 1300, 3), seed=14)  # r 665 on the rows
    out, ran = _streamed(monkeypatch, port.blur_u8, torch.from_numpy(img), 200.0)
    assert ran == ["blur_fft_mxu_streamed_u8"]
    for b in range(2):
        want = oracle.blur_u8(img[b], 200.0).astype(int)
        assert np.abs(out[b].numpy().astype(int) - want).max() <= 1


def _served_f32(monkeypatch, sigma, engine):
    x = _planar((2, 3, 24, 1300), seed=15)
    jplan = j_plan.make_plan((24, 1300), sigma)
    out, ran = _streamed(monkeypatch, port.blur, torch.from_numpy(x), sigma, engine=engine)
    assert ran == ["blur_fft_mxu_streamed"]
    want = np.asarray(j_fft.blur_fft_mxu(jnp.asarray(x), jplan, precision=HIGHEST))
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=2e-2)


@pytest.mark.parametrize("call, match", [
    # past the byte budget: strip-streamed since ops/streamed was ported
    # (these cases keep their ids and hold the result, on thin frames under a
    # patched budget); AUTO uint8, AUTO float, pinned FFT_MXU
    pytest.param(_served_u8_auto, None, id="<lambda>-ops/streamed"),
    pytest.param(lambda mp: _served_f32(mp, 200.0, "auto"), None, id="<lambda>-budget0"),
    pytest.param(lambda mp: _served_f32(mp, 5.0, "fft_mxu"), None, id="<lambda>-budget1"),
    # a transform past 16384: K3/K3f's cluster form since it was ported
    # (its plain version here), through AUTO and pinned
    pytest.param(lambda mp: port.blur(torch.zeros(()).expand(1, 8, 20000), 200.0), None,
                 id="<lambda>-16384_0"),
    pytest.param(lambda mp: port.blur(torch.zeros(()).expand(1, 8, 20000), 3.0,
                                      engine="fft_mxu"), None, id="<lambda>-16384_1"),
    # past the cluster form's longest transform (n 524288): K3f's staged
    # form since it was ported (its plain version here)
    pytest.param(lambda mp: port.blur(torch.zeros(()).expand(1, 8, 270000), 3.0,
                                      engine="fft_mxu"), None, id="<lambda>-item 11"),
])
def test_fft_mxu_refuses_what_it_cannot_serve(monkeypatch, call, match):
    if match is None:
        out = call(monkeypatch)
        if out is not None:  # the 20000- and 270000-wide zero rows
            assert out.shape[:2] == (1, 8) and out.shape[2] in (20000, 270000)
            assert not bool(out.abs().max())
        return
    with pytest.raises(NotImplementedError, match=match):
        call(monkeypatch)


def test_auto_past_radius_600_runs_fft_mxu_on_the_cpu():
    img = _frames((1, 16, 1300, 3), seed=10)
    sigma = 200.0  # r = 665 on the rows axis
    plan = t_plan.make_plan((16, 1300), sigma)
    assert plan.row.support_radius > 600
    got = port.blur_u8(torch.from_numpy(img), sigma).numpy().astype(int)
    want = oracle.blur_u8(img[0], sigma).astype(int)
    assert np.abs(got[0] - want).max() <= 1
