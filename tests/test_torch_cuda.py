"""Tests of the port that need an NVIDIA card (marked ``cuda``).

They skip where ``torch.cuda.is_available()`` is false. The file imports no
jax, so it also runs where jax is not installed; on the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blur_algorithms_tpu_torch import (  # noqa: E402
    blur,
    blur_u8,
    make_custom_plan,
    make_plan,
)
from blur_algorithms_tpu_torch.cuda_kernels import fused_blur, fused_dma  # noqa: E402
from blur_algorithms_tpu_torch.ops.layout import from_planar  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, size=shape, dtype=np.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("shape, sigma", [
    ((1080, 1920), 10.0),
    ((1001, 1777), (5.0, 11.0)),
    ((541, 963), 150.0),
    ((37, 1300), 1.0),
    ((1210, 1205), 180.0),
])
def test_k1_equals_plain_version_on_the_card(cuda_device, shape, sigma):
    plan = make_plan(shape, sigma)
    x = _planes((3, *shape), seed=6).to(cuda_device)
    before = fused_dma.blur_fused_u8_dma.launches
    got = fused_dma.blur_fused_u8_dma(x, plan, direct=True)
    want = fused_dma.blur_fused_u8_dma_ref(x, plan)
    torch.cuda.synchronize()
    assert fused_dma.blur_fused_u8_dma.launches == before + 1
    assert got.device == x.device
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_blur_u8_on_the_card_runs_k1_and_matches_the_cpu(cuda_device):
    # the int8 pin: AUTO on the card takes the rung the device certified
    img = _planes((2, 120, 200, 3), seed=7)
    before = fused_dma.blur_fused_u8_dma.launches
    got = blur_u8(img.to(cuda_device), 4.0, precision="int8")
    torch.cuda.synchronize()
    assert fused_dma.blur_fused_u8_dma.launches == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.uint8
    assert torch.equal(got.cpu(), blur_u8(img, 4.0))
    planar = img.movedim(-1, -3).contiguous()
    want = from_planar(fused_dma.blur_fused_u8_dma_ref(planar, make_plan((120, 200), 4.0)))
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_k1_rejects_a_non_contiguous_tensor(cuda_device):
    plan = make_plan((64, 96), 2.0)
    x = _planes((3, 96, 64), seed=8).to(cuda_device).transpose(-1, -2)
    with pytest.raises(ValueError, match="contiguous"):
        fused_dma.blur_fused_u8_dma(x, plan)


def _f32_planes(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.random(shape) * 255).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [
    make_plan((1080, 1920), 10.0),
    make_plan((541, 963), (3.0, 150.0)),
    make_plan((1210, 1205), 180.0),
    make_custom_plan((300, 517), [0.05, 0.1, 0.5, 0.2, 0.3, -0.1, 0.02],
                     [-0.2, 0.4, 0.9, 0.1, -0.05]),
    make_custom_plan((257, 301), [1.0], [0.25, 0.5, 0.25]),
    make_custom_plan((129, 77), [0.25, 0.5, 0.25], [1.0]),
], ids=["sigma10", "aniso-wide", "r598", "asymmetric", "row-radius-0", "col-radius-0"])
def test_k2_equals_plain_version_on_the_card(cuda_device, plan):
    """f32 within 1e-3 * max|x| / 255 (3xTF32 band products against one
    fmaf a tap: ~1e-4 apart at 0..255 scale)."""
    x = _f32_planes((3, *plan.shape), seed=11).to(cuda_device)
    before = fused_blur.blur_fused_f32.launches
    got = fused_blur.blur_fused_f32(x, plan)
    want = fused_blur.blur_fused_f32_ref(x, plan)
    torch.cuda.synchronize()
    assert fused_blur.blur_fused_f32.launches == before + 1
    assert got.dtype == torch.float32 and got.device == x.device
    assert float((got - want).abs().max()) <= 1e-3 * float(x.abs().max()) / 255


@pytest.mark.cuda
def test_k2_uint8_rung_within_one_count_on_the_card(cuda_device):
    plan = make_custom_plan((480, 640), [-0.25, 1.5, -0.25])
    x = _planes((3, 480, 640), seed=12).to(cuda_device)
    got = fused_blur.blur_fused_f32(x, plan, out_u8=True)
    want = fused_blur.blur_fused_f32_ref(x, plan, out_u8=True)
    torch.cuda.synchronize()
    assert got.dtype == torch.uint8
    assert int((got.int() - want.int()).abs().max()) <= 1


@pytest.mark.cuda
def test_blur_on_the_card_launches_k2_once(cuda_device):
    x = _f32_planes((2, 3, 96, 160), seed=13)
    k1, k2 = fused_dma.blur_fused_u8_dma.launches, fused_blur.blur_fused_f32.launches
    got = blur(x.to(cuda_device), 4.0)
    torch.cuda.synchronize()
    assert fused_blur.blur_fused_f32.launches == k2 + 1
    assert fused_dma.blur_fused_u8_dma.launches == k1
    assert float((got.cpu() - blur(x, 4.0)).abs().max()) <= 1e-3


@pytest.mark.cuda
def test_backward_on_the_card_equals_the_cpu(cuda_device):
    rng = np.random.default_rng(14)
    x = _f32_planes((3, 80, 120), seed=15)
    g = torch.from_numpy(rng.standard_normal((3, 80, 120)).astype(np.float32))
    taps_r, taps_c = [0.1, 0.6, 0.2, 0.3, -0.2], [0.3, 0.9, -0.2]
    from blur_algorithms_tpu_torch import convolve_separable

    grads = []
    for dev in ("cpu", cuda_device):
        t = x.to(dev, copy=True).requires_grad_()
        (convolve_separable(t, taps_r, taps_c) * g.to(dev)).sum().backward()
        grads.append(t.grad.cpu())
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_k2_rejects_a_non_contiguous_tensor(cuda_device):
    plan = make_plan((64, 96), 2.0)
    x = _f32_planes((3, 96, 64), seed=16).to(cuda_device).transpose(-1, -2)
    with pytest.raises(ValueError, match="contiguous"):
        fused_blur.blur_fused_f32(x, plan)


# ---------------------------------------------------------------------------
# K3, K3f, K5: the FFT engines' kernels against their plain versions. The
# plain K3/K3f run the four-step einsums in full float32 on the card; the
# kernel runs radix-Q / R0 / 32 f32 passes, so the two differ by rounding:
# limit 2e-2 at 0..255 scale (the JAX package's bound for its FFT engines).

def _k3_plan(width, asymmetric, dim=300):
    from blur_algorithms_tpu_torch.ops.kernels import gaussian_kernel

    t = gaussian_kernel(width / 6.0, width).astype(np.float64)
    if asymmetric:
        t *= np.linspace(0.6, 1.4, width)
    return make_custom_plan((8, dim), (t / t.sum()).astype(np.float32), [1.0])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 512, 1024, 2048, 4096, 5120, 6144, 7168, 8192,
                               12288, 15360, 16384])
@pytest.mark.parametrize("asymmetric", [False, True])
def test_k3_against_plain_version_on_the_card(cuda_device, n, asymmetric):
    from blur_algorithms_tpu_torch.cuda_kernels import fft4step

    plan = _k3_plan(201, asymmetric)
    rows = _f32_planes((33, n), seed=17).to(cuda_device)  # odd row count
    before = fft4step.fft_conv_rows.launches
    got = fft4step.fft_conv_rows(rows, n, plan.row)
    want = fft4step.fft_conv_rows(rows.cpu(), n, plan.row)
    torch.cuda.synchronize()
    assert fft4step.fft_conv_rows.launches == before + 1
    assert float((got.cpu() - want).abs().max()) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dim, width", [(1100, 1101), (3840, 1663), (2160, 1663),
                                        (3840, 2661), (2160, 2661)])
@pytest.mark.parametrize("asymmetric", [False, True])
def test_k3f_against_plain_version_on_the_card(cuda_device, dim, width, asymmetric):
    from blur_algorithms_tpu_torch.cuda_kernels import fft4step
    from blur_algorithms_tpu_torch.ops.fft_mxu import transform_length

    plan = _k3_plan(width, asymmetric, dim)
    n = transform_length(plan.row)
    assert fft4step.framed_applicable(n)
    rows = _f32_planes((7, dim), seed=18).to(cuda_device)
    before = fft4step.fft_conv_rows_framed.launches
    got = fft4step.fft_conv_rows_framed(rows, n, plan.row)
    want = fft4step.fft_conv_rows_framed(rows.cpu(), n, plan.row)
    torch.cuda.synchronize()
    assert fft4step.fft_conv_rows_framed.launches == before + 1
    assert float((got.cpu() - want).abs().max()) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 40, 33), (3, 41, 33), (1, 6, 8), (5, 7, 1)])
@pytest.mark.parametrize("offset", [0, 1])
def test_k5_equals_plain_version_on_the_card(cuda_device, shape, offset):
    """Even and odd h * wf over several planes (pairs that straddle a row
    end, a scalar head and tail), on an aligned base and on one 8 bytes
    past a 16-byte boundary."""
    from blur_algorithms_tpu_torch.cuda_kernels import spectral_multiply as k5

    rng = np.random.default_rng(19)
    n = int(np.prod(shape))
    flat = (rng.standard_normal(n + 1) + 1j * rng.standard_normal(n + 1)).astype(np.complex64)
    spec = torch.from_numpy(flat)
    col = rng.standard_normal(shape[1]).astype(np.float32)
    row = rng.standard_normal(shape[2]).astype(np.float32)
    dev = spec.to(cuda_device)[offset:offset + n].view(shape)
    assert dev.data_ptr() % 16 == 8 * offset
    before = k5.spectral_multiply_2d.launches
    got = k5.spectral_multiply_2d(dev, col, row, 0.5)
    torch.cuda.synchronize()
    assert k5.spectral_multiply_2d.launches == before + 1
    want = k5.spectral_multiply_2d(spec[offset:offset + n].view(shape), col, row, 0.5)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_fft_engines_on_the_card_match_the_cpu(cuda_device):
    from blur_algorithms_tpu_torch import convolve_separable
    from blur_algorithms_tpu_torch.cuda_kernels import fft4step

    x = _f32_planes((2, 3, 90, 1300), seed=20)
    k3f = fft4step.fft_conv_rows_framed.launches
    got = blur(x.to(cuda_device), 200.0)  # r = 650 > 600: AUTO runs FFT_MXU
    torch.cuda.synchronize()
    assert fft4step.fft_conv_rows_framed.launches > k3f
    assert float((got.cpu() - blur(x, 200.0, engine="fft_mxu")).abs().max()) <= 2e-2
    taps_r, taps_c = [0.1, 0.6, 0.2, 0.3, -0.2], [0.3, 0.9, -0.2]
    for engine in ("fft_mxu", "fft2", "fft_tiles"):
        got = convolve_separable(x.to(cuda_device), taps_r, taps_c, engine=engine)
        want = convolve_separable(x, taps_r, taps_c, engine=engine)
        assert float((got.cpu() - want).abs().max()) <= 2e-2, engine


# ---------------------------------------------------------------------------
# K4 (box scan), the int8 split forms and K2's single-axis wide form against
# their plain versions. K4 and its plain version both sum in float64 and
# round each pass to f32: f32 within 1e-3 * max|x| / 255, uint8 within 1.
# The int8 forms are bit-equal; the single-axis form (3xTF32 band products)
# within 1e-3 * max|x| / 255 of its plain version in float64 (the f32 mode
# rounds each of its up to 8193 taps and drifts ~1e-3 from the exact sum at
# r 4000 by itself), uint8 within 1.


@pytest.mark.cuda
@pytest.mark.parametrize("shape, r, passes", [
    ((3, 257, 1920), 5, 2), ((3, 1080, 301), 40, 3), ((2, 64, 9000), 1700, 2),
    ((2, 33, 20000), 4000, 3), ((3, 120, 130), 200, 1), ((2, 20000, 33), 4000, 3),
    ((6, 301, 517), 40, 2), ((2, 9, 15000), 3500, 2),
], ids=["small", "3-pass", "tiled-rows", "lines-rows", "clamped", "tall-cols", "6-planes",
        "rows-runs-of-63"])
@pytest.mark.parametrize("axis", [-1, -2])
def test_k4_against_plain_version_on_the_card(cuda_device, shape, r, passes, axis):
    from blur_algorithms_tpu_torch.cuda_kernels import box_blur as k4

    for x in (_planes(shape, seed=21), _f32_planes(shape, seed=22)):
        x = x.to(cuda_device)
        for out_u8 in (False, True):
            before = k4.box_blur_scan_axis.launches
            got = k4.box_blur_scan_axis(x, r, passes, axis, out_u8=out_u8)
            want = k4.box_blur_scan_axis_ref(x, r, passes, axis, out_u8=out_u8)
            torch.cuda.synchronize()
            assert k4.box_blur_scan_axis.launches == before + 1
            d = float((got.double() - want.double()).abs().max())
            assert d <= (1 if out_u8 else 1e-3 * float(x.float().abs().max()) / 255)


@pytest.mark.cuda
@pytest.mark.parametrize("shape, sigma, planes", [
    ((300, 517), 3.0, 3), ((1080, 1920), 250.0, 3), ((64, 5000), 1000.0, 3),
    ((301, 2500), (150.0, 700.0), 3), ((37, 1300), 0.55, 3), ((50, 8400), (15.0, 1230.05), 2),
    ((1001, 1777), 15.0, 5), ((8200, 40), (1230.65, 1.0), 2), ((37, 1300), (0.55, 300.0), 3),
    ((1001, 1777), (100.0, 3.0), 5),
], ids=["r9", "r831", "r2500", "r1250-aniso", "r1", "r4094", "ragged-5-planes", "cols-r4096",
        "cols-r1-wide-rows", "cols-r332-5-planes"])
def test_int8_split_forms_equal_plain_versions_on_the_card(cuda_device, shape, sigma, planes):
    from blur_algorithms_tpu_torch.cuda_kernels import fused_split as fs

    plan = make_plan(shape, sigma)
    rows, cols = fused_blur._split_plans(plan)
    x = _planes((planes, *shape), seed=23).to(cuda_device)
    e = fs.fused_split_rows_int8(x, rows, out_e32=True)
    assert torch.equal(e, fs.fused_split_rows_int8_ref(x, rows, out_e32=True))
    y = fs.fused_split_rows_int8(x, rows, out_e32=False)
    assert torch.equal(y, fs.fused_split_rows_int8_ref(x, rows, out_e32=False))
    for out_u8 in (True, False):
        got = fs.fused_split_cols_int8(e, cols, out_u8=out_u8)
        assert torch.equal(got, fs.fused_split_cols_int8_ref(e, cols, out_u8=out_u8))


@pytest.mark.cuda
@pytest.mark.parametrize("shape, sigma", [
    ((300, 517), 3.0), ((1080, 1920), 400.0), ((64, 9000), 1200.0),
])
@pytest.mark.parametrize("in_u8", [False, True])
def test_k2_single_axis_form_on_the_card(cuda_device, shape, sigma, in_u8):
    plan = make_plan(shape, sigma)
    x = (_planes if in_u8 else _f32_planes)((3, *shape), seed=24).to(cuda_device)
    for axis_plan in fused_blur._split_plans(plan):
        for out_u8 in (False, True):
            before = fused_blur.blur_fused_axis_f32.launches
            got = fused_blur.blur_fused_axis_f32(x, axis_plan, out_u8=out_u8)
            want = fused_blur.blur_fused_f32_ref(x.double(), axis_plan, out_u8=out_u8)
            torch.cuda.synchronize()
            assert fused_blur.blur_fused_axis_f32.launches == before + 1
            d = float((got.double() - want.double()).abs().max())
            assert d <= (1 if out_u8 else 1e-3 * float(x.float().abs().max()) / 255)


@pytest.mark.cuda
def test_slice_4_paths_on_the_card_match_the_cpu(cuda_device):
    from blur_algorithms_tpu_torch import box_blur

    img = _planes((1, 48, 1400, 3), seed=25)
    for call in (lambda t: blur_u8(t, 200.0, engine="fused"),
                 lambda t: box_blur(t, 25.0),
                 lambda t: blur_u8(t, 30.0, engine="cascade")):
        got = call(img.to(cuda_device))
        torch.cuda.synchronize()
        assert int((got.cpu().int() - call(img).int()).abs().max()) <= 1
    x = _f32_planes((2, 48, 1400), seed=26)
    got = blur(x.to(cuda_device), 200.0, engine="fused")
    assert float((got.cpu() - blur(x, 200.0, engine="fused")).abs().max()) <= 1e-3


# ---------------------------------------------------------------------------
# K1's bf16 body sums in its plain version's ascending order, so it is
# bit-equal for f32 and uint8 out. K1's hybrid body and the split's hybrid
# pass 2 sum on the tensor cores in aligned groups of 16 taps: within 2e-2
# at 0..255 scale of their plain versions (ascending order) on the f32
# store, 1 count on the uint8 store, and bit-equal to themselves over any
# tiling of the rows (K1's: in every form).

HYBRID_TOL = 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("shape, sigma", [
    ((1080, 1920), 10.0), ((1001, 1777), (5.0, 11.0)), ((541, 963), 150.0),
    ((37, 1300), 1.0), ((1210, 1205), 180.0), ((64, 300), (2.0, 60.0)),
])
@pytest.mark.parametrize("rung", ["hybrid", "bf16"])
def test_k1_rungs_equal_plain_versions_on_the_card(cuda_device, shape, sigma, rung):
    fn = fused_dma.blur_fused_u8_hybrid if rung == "hybrid" else fused_dma.blur_fused_u8_bf16
    ref = (fused_dma.blur_fused_u8_hybrid_ref if rung == "hybrid"
           else fused_dma.blur_fused_u8_bf16_ref)
    plan = make_plan(shape, sigma)
    x = _planes((3, *shape), seed=27).to(cuda_device)
    for out_u8 in (True, False):
        before = fn.launches
        got = fn(x, plan, out_u8)
        want = ref(x, plan, out_u8)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert got.dtype == want.dtype and got.shape == want.shape
        if rung == "bf16":
            assert torch.equal(got, want)
        else:
            d = float((got.double() - want.double()).abs().max())
            assert d <= (1 if out_u8 else HYBRID_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape, sigma, planes", [
    ((300, 517), 3.0, 3), ((1080, 1920), 250.0, 3), ((5000, 64), 1000.0, 3),
    ((9000, 40), (1230.0, 2.0), 3), ((300, 517), (0.55, 3.0), 3),
    ((8400, 40), (1230.05, 0.55), 2), ((1001, 1777), 15.0, 5),
], ids=["r9", "r831", "r2500", "r4093", "r1", "r4094", "ragged-5-planes"])
def test_split_hybrid_pass2_equals_plain_version_on_the_card(cuda_device, shape, sigma,
                                                             planes):
    from blur_algorithms_tpu_torch.cuda_kernels import fused_split as fs

    plan = make_plan(shape, sigma)
    rows, cols = fused_blur._split_plans(plan)
    x = _planes((planes, *shape), seed=28).to(cuda_device)
    e = fs.fused_split_rows_int8(x, rows, out_e32=True)
    for out_u8 in (True, False):
        before = fs.fused_split_cols_hybrid.launches
        got = fs.fused_split_cols_hybrid(e, cols, out_u8=out_u8)
        want = fs.fused_split_cols_hybrid_ref(e, cols, out_u8=out_u8)
        torch.cuda.synchronize()
        assert fs.fused_split_cols_hybrid.launches == before + 1
        assert got.dtype == want.dtype and got.shape == want.shape
        d = float((got.double() - want.double()).abs().max())
        assert d <= (1 if out_u8 else HYBRID_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", [15.0, 50.0, 250.0])
def test_split_hybrid_pass2_is_tiling_invariant_on_the_card(cuda_device, sigma):
    """The pre-padded pass 2 over a shard's rows (origins 0, 7, 135, 251,
    465, 1001) is bit-equal to the same rows of the single call."""
    from blur_algorithms_tpu_torch.cuda_kernels import fused_split as fs
    from blur_algorithms_tpu_torch.ops.pad import reflect_101
    from blur_algorithms_tpu_torch.parallel.sharded import _local_plan

    shape = (2160, 640)
    plan = make_plan(shape, sigma)
    rows, cols = fused_blur._split_plans(plan)
    rh = cols.col.support_radius
    e = fs.fused_split_rows_int8(_planes((3, *shape), seed=47).to(cuda_device), rows)
    ep = reflect_101(e, [(rh, rh)], axes=[-2])
    for out_u8 in (False, True):
        whole = fs.fused_split_cols_hybrid(e, cols, out_u8=out_u8)
        for origin, h_loc in ((0, 135), (7, 300), (135, 135), (251, 251), (465, 465),
                              (1001, 1159)):
            _, lcols = fused_blur._split_plans(_local_plan(plan, h_loc, shape[1]))
            part = ep[:, origin : origin + h_loc + 2 * rh].contiguous()
            got = fs.fused_split_cols_hybrid(part, lcols, out_u8=out_u8, pre_padded_col=True)
            torch.cuda.synchronize()
            assert torch.equal(got, whole[:, origin : origin + h_loc])


@pytest.mark.cuda
def test_auto_on_the_card_runs_the_certified_rung(cuda_device):
    from blur_algorithms_tpu_torch.api import _u8_dma_precision
    from blur_algorithms_tpu_torch.utils.hw import device_spec

    img = _planes((2, 120, 200, 3), seed=30)
    plan = make_plan((120, 200), 4.0)
    rung = _u8_dma_precision(plan, device_spec(cuda_device))
    got = blur_u8(img.to(cuda_device), 4.0)
    planar = img.movedim(-1, -3).contiguous()
    ref = {"int8": fused_dma.blur_fused_u8_dma_ref, "hybrid": fused_dma.blur_fused_u8_hybrid_ref,
           "bf16": fused_dma.blur_fused_u8_bf16_ref}[rung]
    want = from_planar(ref(planar, plan))
    if rung == "hybrid":  # tensor-core groups of 16 taps: within 1 count
        assert int((got.cpu().int() - want.int()).abs().max()) <= 1
    else:
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_hybrid_pin_on_the_card_matches_the_cpu(cuda_device):
    img = _planes((2, 120, 200, 3), seed=29)
    before = fused_dma.blur_fused_u8_hybrid.launches
    got = blur_u8(img.to(cuda_device), 4.0, precision="hybrid")
    torch.cuda.synchronize()
    assert fused_dma.blur_fused_u8_hybrid.launches == before + 1
    # the CPU runs the plain version (taps one by one): within 1 count
    assert int((got.cpu().int() - blur_u8(img, 4.0, precision="hybrid").int()).abs().max()) <= 1


# ---------------------------------------------------------------------------
# K1's staging forms (strip, assembled with A5, pipelined, resident): each
# computes K1's function from the same terms, so each equals K1 direct bit
# for bit, and the int8 and bf16 bodies' plain versions too (the hybrid
# one's within 2e-2 / 1 count); a form that does not fit raises.

_FORM_KW = {"strip": {"strip": True}, "assembled": {"direct": False},
            "pipelined": {"pipelined": True}, "resident": {"resident": True}}


def _form_counter(form):
    return {"strip": fused_dma.blur_fused_u8_strip,
            "assembled": fused_dma.blur_fused_u8_assembled,
            "pipelined": fused_dma.blur_fused_u8_pipelined,
            "resident": fused_dma.blur_fused_u8_resident}[form]


def _rung_ref(rung):
    return {"int8": fused_dma.blur_fused_u8_dma_ref,
            "hybrid": fused_dma.blur_fused_u8_hybrid_ref,
            "bf16": fused_dma.blur_fused_u8_bf16_ref}[rung]


@pytest.mark.cuda
@pytest.mark.parametrize("shape, sigma", [
    ((1080, 1920), 10.0), ((1001, 1777), (5.0, 11.0)), ((541, 963), 150.0),
    ((37, 1300), 1.0), ((300, 4000), 3.0), ((700, 700), 180.0),
])
@pytest.mark.parametrize("form", ["strip", "assembled", "pipelined", "resident"])
@pytest.mark.parametrize("rung", ["int8", "hybrid", "bf16"])
def test_k1_forms_equal_plain_versions_on_the_card(cuda_device, shape, sigma, form, rung):
    from blur_algorithms_tpu_torch.cuda_kernels import assemble

    plan = make_plan(shape, sigma)
    x = _planes((3, *shape), seed=31).to(cuda_device)
    geo = fused_dma.k1_geometry(form, rung, plan, 3, device=cuda_device)
    counter = _form_counter(form)
    for out_u8 in (True, False):
        if geo is None:
            with pytest.raises(ValueError, match="="):
                fused_dma.blur_fused_u8_dma(x, plan, precision=rung, out_u8=out_u8,
                                            **_FORM_KW[form])
            continue
        before, a5 = counter.launches, assemble.assemble_padded.launches
        got = fused_dma.blur_fused_u8_dma(x, plan, precision=rung, out_u8=out_u8,
                                          **_FORM_KW[form])
        direct = fused_dma.blur_fused_u8_dma(x, plan, precision=rung, out_u8=out_u8,
                                             direct=True)
        want = _rung_ref(rung)(x, plan, out_u8)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        assert assemble.assemble_padded.launches == a5 + (form in ("assembled", "pipelined"))
        assert torch.equal(got, direct)
        if rung == "hybrid":
            d = float((got.double() - want.double()).abs().max())
            assert d <= (1 if out_u8 else HYBRID_TOL)
        else:
            assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("h, w, rh, rw, orh, orw, hp, wp", [
    # the JAX _align_geometry frames of test_band_fused.py's A5 cases
    (96, 256, 4, 4, 8, 128, 112, 512), (100, 200, 7, 3, 8, 128, 160, 512),
    (9, 129, 8, 128, 8, 128, 32, 512), (70, 250, 1, 140, 8, 256, 88, 768),
    (256, 384, 130, 5, 136, 128, 528, 768),
    (1001, 1777, 33, 33, 33, 33, 1104, 1856),  # the port's K1a geometry: (rh, rw)
])
def test_a5_equals_plain_version_on_the_card(cuda_device, h, w, rh, rw, orh, orw, hp, wp):
    from blur_algorithms_tpu_torch.cuda_kernels import assemble

    x = _planes((3, h, w), seed=32)
    before = assemble.assemble_padded.launches
    got = assemble.assemble_padded(x.to(cuda_device), rh, rw, orh, orw, hp, wp)
    torch.cuda.synchronize()
    assert assemble.assemble_padded.launches == before + 1
    assert torch.equal(got.cpu(), assemble.assemble_padded_ref(x, rh, rw, orh, orw, hp, wp))


@pytest.mark.cuda
def test_int8_pin_on_the_card_runs_k1_int8_past_the_split_radius(cuda_device):
    from blur_algorithms_tpu_torch.cuda_kernels import fused_split as fs

    img = _planes((1, 160, 200, 3), seed=33)
    counters = (fused_dma.blur_fused_u8_dma, fused_dma.blur_fused_u8_strip,
                fused_dma.blur_fused_u8_resident, fused_dma.blur_fused_u8_assembled,
                fs.fused_split_rows_int8, fs.fused_split_cols_hybrid, fs.fused_split_cols_int8)
    before = [c.launches for c in counters]
    got = blur_u8(img.to(cuda_device), 15.0, precision="int8")  # r 49
    torch.cuda.synchronize()
    ran = [c.launches - b for c, b in zip(counters, before)]
    assert sum(ran[:4]) == 1 and not any(ran[4:])
    assert torch.equal(got.cpu(), blur_u8(img, 15.0, precision="int8"))


# ---------------------------------------------------------------------------
# the sharded path's per-shard kernels (slice 7)


@pytest.mark.cuda
@pytest.mark.parametrize("hs, w, rw, hp, wp", [
    (1144, 3840, 32, 1216, 3936), (70, 250, 1, 96, 272), (1001, 1777, 598, 1800, 2992),
    (80, 256, 3, 80, 272),  # hp <= 8 * (hs // 8): the frame grows by 8 rows
])
def test_a4_equals_plain_version_on_the_card(cuda_device, hs, w, rw, hp, wp):
    from blur_algorithms_tpu_torch.cuda_kernels import assemble

    x = _planes((3, hs, w), seed=41)
    before = assemble.assemble_padded_prepad.launches
    got = assemble.assemble_padded_prepad(x.to(cuda_device), rw, rw, hp, wp)
    torch.cuda.synchronize()
    assert assemble.assemble_padded_prepad.launches == before + 1
    assert torch.equal(got.cpu(), assemble.assemble_padded_prepad_ref(x, rw, rw, hp, wp))


@pytest.mark.cuda
@pytest.mark.parametrize("shape, sigma", [((540, 1920), 10.0), ((135, 3840), 50.0),
                                          ((251, 777), (5.0, 11.0))])
@pytest.mark.parametrize("rung", ["int8", "hybrid", "bf16"])
def test_haloed_dma_equals_plain_version_on_the_card(cuda_device, shape, sigma, rung):
    from blur_algorithms_tpu_torch.cuda_kernels import assemble

    plan = make_plan(shape, sigma)
    rh = plan.col.support_radius
    x = _planes((3, shape[0] + 2 * rh, shape[1]), seed=42)
    xd = x.to(cuda_device)
    for out_u8 in (True, False):
        a4, k1a = assemble.assemble_padded_prepad.launches, fused_dma.blur_fused_u8_assembled.launches
        got = fused_dma.blur_fused_haloed_dma(xd, plan, rung, out_u8=out_u8)
        torch.cuda.synchronize()
        assert assemble.assemble_padded_prepad.launches == a4 + 1
        assert fused_dma.blur_fused_u8_assembled.launches == k1a + 1
        want = fused_dma.blur_fused_haloed_dma(x, plan, rung, out_u8=out_u8)
        if rung == "hybrid":  # the CPU's plain version sums tap by tap
            d = float((got.cpu().double() - want.double()).abs().max())
            assert d <= (1 if out_u8 else HYBRID_TOL)
        else:
            assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", [3.0, 9.0, 50.0, 150.0])
def test_k1_hybrid_is_tiling_invariant_on_the_card(cuda_device, sigma):
    """K1a on caller rows at shard origins 0, 7, 135, 251, 465, 1001 (A4's
    frame, the sharded step) is bit-equal to the same rows of K1 hybrid
    direct over the whole frame: every output row sums its own tap groups
    in the same order wherever its tile starts."""
    from blur_algorithms_tpu_torch.ops.pad import reflect_101
    from blur_algorithms_tpu_torch.parallel.sharded import _local_plan

    shape = (2160, 640)
    plan = make_plan(shape, sigma)
    rh = plan.col.support_radius
    x = _planes((3, *shape), seed=48).to(cuda_device)
    xp = reflect_101(x, [(rh, rh)], axes=[-2])
    for out_u8 in (False, True):
        whole = fused_dma.blur_fused_u8_hybrid(x, plan, out_u8)
        for origin, h_loc in ((0, 135), (7, 300), (135, 135), (251, 251), (465, 465),
                              (1001, 1159)):
            local = _local_plan(plan, h_loc, shape[1])
            part = xp[:, origin : origin + h_loc + 2 * rh].contiguous()
            got = fused_dma.blur_fused_haloed_dma(part, local, "hybrid", out_u8=out_u8)
            torch.cuda.synchronize()
            assert torch.equal(got, whole[:, origin : origin + h_loc])


@pytest.mark.cuda
@pytest.mark.parametrize("shape, sigma", [((540, 1920), 10.0), ((300, 517), (3.0, 150.0)),
                                          ((135, 1000), 180.0)])
@pytest.mark.parametrize("in_u8", [False, True])
def test_pre_padded_k2_on_the_card(cuda_device, shape, sigma, in_u8):
    plan = make_plan(shape, sigma)
    rh = plan.col.support_radius
    x = (_planes if in_u8 else _f32_planes)((3, shape[0] + 2 * rh, shape[1]), seed=43)
    xd = x.to(cuda_device)
    for out_u8 in (False, True):
        before = fused_blur.blur_fused_f32.launches
        got = fused_blur.blur_fused_f32(xd, plan, out_u8=out_u8, pre_padded_col=True)
        want = fused_blur.blur_fused_f32_ref(xd, plan, out_u8=out_u8, pre_padded_col=True)
        torch.cuda.synchronize()
        assert fused_blur.blur_fused_f32.launches == before + 1
        assert got.shape == (3, *shape)
        d = float((got.double() - want.double()).abs().max())
        assert d <= (1 if out_u8 else 1e-3 * float(x.float().abs().max()) / 255)


@pytest.mark.cuda
@pytest.mark.parametrize("shape, sigma", [((135, 3840), 50.0), ((540, 1000), 1200.0)])
def test_pre_padded_split_forms_on_the_card(cuda_device, shape, sigma):
    from blur_algorithms_tpu_torch.cuda_kernels import fused_split as fs

    plan = make_plan((shape[0], shape[1]), sigma)
    rh = plan.col.support_radius
    rows_h = fused_blur._haloed_rows_plan(plan)
    _, cols = fused_blur._split_plans(plan)
    x = _planes((3, shape[0] + 2 * rh, shape[1]), seed=44).to(cuda_device)
    e = fs.fused_split_rows_int8(x, rows_h, out_e32=True)
    y = fused_blur.blur_fused_axis_f32(x.float(), rows_h)
    for out_u8 in (True, False):
        got = fs.fused_split_cols_int8(e, cols, out_u8=out_u8, pre_padded_col=True)
        assert torch.equal(got, fs.fused_split_cols_int8_ref(e, cols, out_u8=out_u8,
                                                             pre_padded_col=True))
        got = fs.fused_split_cols_hybrid(e, cols, out_u8=out_u8, pre_padded_col=True)
        want = fs.fused_split_cols_hybrid_ref(e, cols, out_u8=out_u8, pre_padded_col=True)
        d = float((got.double() - want.double()).abs().max())
        assert d <= (1 if out_u8 else HYBRID_TOL)
        got = fused_blur.blur_fused_axis_f32(y, cols, out_u8=out_u8, pre_padded_col=True)
        want = fused_blur.blur_fused_f32_ref(y.double(), cols, out_u8=out_u8,
                                             pre_padded_col=True)
        torch.cuda.synchronize()
        d = float((got.double() - want.double()).abs().max())
        assert d <= (1 if out_u8 else 1e-3 * float(y.abs().max()) / 255)


@pytest.mark.cuda
@pytest.mark.parametrize("origin, h_loc", [(7, 300), (135, 135), (465, 75)])
def test_int8_cols_pass_on_halo_rows_at_an_odd_shard_origin(cuda_device, origin, h_loc):
    """The int8 pass 2 on a shard's E with its halo rows (``pre_padded_col``)
    at a shard origin that no tile boundary of the whole frame meets:
    ``torch.equal`` to its plain version and to the whole frame's rows."""
    from blur_algorithms_tpu_torch.cuda_kernels import fused_split as fs
    from blur_algorithms_tpu_torch.ops.pad import reflect_101
    from blur_algorithms_tpu_torch.parallel.sharded import _local_plan

    shape = (540, 1000)
    plan = make_plan(shape, 250.0)
    rows, cols = fused_blur._split_plans(plan)
    rh = cols.col.support_radius
    x = _planes((3, *shape), seed=47).to(cuda_device)
    e = fs.fused_split_rows_int8(x, rows, out_e32=True)
    _, lcols = fused_blur._split_plans(_local_plan(plan, h_loc, shape[1]))
    part = reflect_101(e, [(rh, rh)], axes=[-2])[:, origin : origin + h_loc + 2 * rh]
    part = part.contiguous()
    for out_u8 in (True, False):
        whole = fs.fused_split_cols_int8(e, cols, out_u8=out_u8)
        got = fs.fused_split_cols_int8(part, lcols, out_u8=out_u8, pre_padded_col=True)
        torch.cuda.synchronize()
        assert torch.equal(got, fs.fused_split_cols_int8_ref(part, lcols, out_u8, True))
        assert torch.equal(got, whole[:, origin : origin + h_loc])


@pytest.mark.cuda
@pytest.mark.parametrize("dp, sp, sigma", [(2, 2, 3.0), (1, 4, 10.0), (1, 8, 20.0)])
def test_sharded_on_a_repeated_device_mesh(cuda_device, dp, sp, sigma):
    """A mesh of one card repeated: the halo exchange, the gathers and every
    shard's step on the card, equal to the single-device fused engine on
    the rung the sharded path routes (the split past the card's split
    radius, at sigma 20, K1 below it)."""
    from blur_algorithms_tpu_torch.parallel import blur_sharded, blur_sharded_u8, make_mesh

    mesh = make_mesh(dp=dp, sp=sp, devices=[cuda_device] * (dp * sp))
    img = _planes((4, 240, 320, 3), seed=45).to(cuda_device)
    plan = make_plan((240, 320), sigma)
    got = blur_sharded_u8(img, plan, mesh)
    from blur_algorithms_tpu_torch.api import _u8_dma_precision
    from blur_algorithms_tpu_torch.parallel.sharded import _local_plan
    from blur_algorithms_tpu_torch.utils.hw import device_spec

    rung = _u8_dma_precision(_local_plan(plan, 240 // sp, 320), device_spec(cuda_device))
    want = fused_blur.blur_fused_u8(img.movedim(-1, -3).contiguous(), plan, rung)
    want = want.movedim(-3, -1)
    torch.cuda.synchronize()
    assert got.device == img.device and torch.equal(got, want)
    x = _f32_planes((4, 3, 240, 320), seed=46).to(cuda_device)
    got = blur_sharded(x, plan, mesh)
    assert float((got - blur(x, sigma)).abs().max()) <= 1e-3 * float(x.abs().max()) / 255


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["mma_sync", "wgmma"])
@pytest.mark.parametrize("m, k, n", [(120, 1144, 384), (1024, 1024, 1024), (200, 256, 512)])
def test_b1_chain_equals_plain_version_on_the_card(cuda_device, path, m, k, n):
    from blur_algorithms_tpu_torch.benchmarks import mxu_dot_rate as b1

    a, b = (t.to(cuda_device) for t in b1.operands(m, k, n, "int8", seed=2))
    before = b1.chain.launches[path]
    got = b1.chain(a, b, 3, 2, path=path)
    torch.cuda.synchronize()
    assert b1.chain.launches[path] == before + 1
    assert torch.equal(got, b1.chain_ref(a, b, 3))
    a, b = (t.to(cuda_device) for t in b1.operands(m, k, n, "bf16", seed=2))
    got, want = b1.chain(a, b, 1, path=path), b1.chain_ref(a, b, 1)
    torch.cuda.synchronize()
    assert ((got.double() - want.double()).abs() <= b1.bf16_bound(a, b, want)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["mma_sync", "wgmma"])
@pytest.mark.parametrize("resident", [False, True])
def test_b1_card_filling_launches_equal_plain_version(cuda_device, path, resident):
    """The launches the rates time: one block for each the card holds, the
    rhs streamed, or resident (against the plain chain on resident_rhs)."""
    from blur_algorithms_tpu_torch.benchmarks import mxu_dot_rate as b1

    a, b = (t.to(cuda_device) for t in b1.operands(120, 1144, 384, "int8", seed=3))
    rhs = b1.resident_rhs(b) if resident else b
    got = b1.chain(a, b, 3, 2, path=path, resident=resident, copies=True)
    torch.cuda.synchronize()
    assert torch.equal(got, b1.chain_ref(a, rhs, 3))
    a, b = (t.to(cuda_device) for t in b1.operands(120, 1144, 384, "bf16", seed=3))
    rhs = b1.resident_rhs(b) if resident else b
    got = b1.chain(a, b, 1, path=path, resident=resident, copies=True)
    want = b1.chain_ref(a, rhs, 1)
    torch.cuda.synchronize()
    assert ((got.double() - want.double()).abs() <= b1.bf16_bound(a, rhs, want)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("sigma, n, framed", [(250.0, 6144, True), (400.0, 8192, False)])
def test_b2_full_mode_equals_the_production_kernel(cuda_device, sigma, n, framed):
    from blur_algorithms_tpu_torch.benchmarks import fft_mxu_ablation as b2
    from blur_algorithms_tpu_torch.cuda_kernels import fft4step

    ax = make_plan((64, 3840), sigma).row
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (37, ax.dim if framed else n), dtype=np.float32)).to(cuda_device)
    want = (fft4step.fft_conv_rows_framed if framed else fft4step.fft_conv_rows)(x, n, ax)
    assert torch.equal(b2.conv_rows_ablation(x, n, ax, "full", framed), want)
    for mode in ("nodot", "norot", "io_only"):  # timing only: they run
        assert b2.conv_rows_ablation(x, n, ax, mode, framed).shape == x.shape


@pytest.mark.cuda
def test_b3_stores_equal_their_plain_versions(cuda_device):
    from blur_algorithms_tpu_torch.benchmarks import dma_fetch_rate as b3
    from blur_algorithms_tpu_torch.cuda_kernels.assemble import assemble_padded

    frame = _planes((2, b3.HP, b3.WP), seed=9).to(cuda_device)
    for kw in ({}, {"tma": True}, {"strip": True}):
        assert torch.equal(b3.fetch_windows(frame, **kw),
                           b3.fetch_windows_ref(frame, kw.get("strip", False)))
    planar = _planes((3, 541, 963), seed=10).to(cuda_device)
    plan = make_plan((541, 963), 10.0)
    for form in ("direct", "assembled"):
        lo = b3.k1_loader(plan, form, cuda_device, planes=3)
        padded = (assemble_padded(planar, lo.rh, lo.rw, lo.rh, lo.rw, lo.xh, lo.xw)
                  if lo.slots else None)
        assert torch.equal(b3.fetch_k1(planar, lo, padded),
                           b3.fetch_k1_ref(planar, lo, padded))
