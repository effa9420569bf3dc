"""K1's staging forms against the JAX package, on the CPU.

The port's strip (K1s), assembled (K1a, with A5 and the pipelined variant)
and rows-resident (K1r) forms (``cuda_kernels/fused_dma.py``,
``cuda_kernels/assemble.py``) run CUDA kernels on a card and their plain
versions on a CPU tensor. Here:

- ``blur_fused_u8_dma`` with each form's keyword is bit-identical to the JAX
  ``_blur_fused_dma_impl`` with the same keyword, its Pallas kernel running
  in interpret mode (the hybrid column radii here are at most 60, where
  XLA's CPU dot sums in ascending order, as the port does);
- A5's plain version equals the JAX ``_assemble_padded`` at the JAX
  geometries, and ``blur_fused_u8_padded_ref`` on an assembled frame equals
  K1's plain version;
- a NumPy model of K1r's ring walk (the kernel's own index arithmetic:
  ring rows, mirror, step targets) equals K1's plain version, a last column
  window past the frame's width included;
- the forms' gates: one geometry policy serves each form's check and its
  launch; a pinned form that does not fit raises; the device's measured
  rule routes the forms, and the CPU's runs K1 direct.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from blur_algorithms_tpu.ops.plan import make_plan as j_make_plan  # noqa: E402
from blur_algorithms_tpu.pallas_kernels import fused_dma as j_dma  # noqa: E402
from blur_algorithms_tpu_torch import api, blur_u8, make_plan  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import assemble  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fused_dma as t_dma  # noqa: E402
from blur_algorithms_tpu_torch.ops.layout import from_planar  # noqa: E402
from blur_algorithms_tpu_torch.utils import hw  # noqa: E402


def _frames(shape, seed, planes=3):
    rng = np.random.default_rng(seed)
    return (rng.random((planes, *shape)) * 255).astype(np.uint8)


def _plain(x, plan, rung, out_u8=True):
    if rung == "int8":
        return t_dma.blur_fused_u8_dma_ref(x, plan)
    ref = t_dma.blur_fused_u8_hybrid_ref if rung == "hybrid" else t_dma.blur_fused_u8_bf16_ref
    return ref(x, plan, out_u8)


def _jax(x, shape, sigma, rung, **kw):
    return np.asarray(j_dma._blur_fused_dma_impl(jnp.asarray(x), j_make_plan(shape, sigma),
                                                 rung, True, **kw))


# ---------------------------------------------------------------------------
# each form against its JAX counterpart in interpret mode


@pytest.mark.parametrize("rung", ["int8", "hybrid"])
def test_strip_form_equals_the_jax_strip_kernel(rung):
    shape, sigma = (96, 1024), 4.0
    x = _frames(shape, seed=1)
    got = t_dma.blur_fused_u8_dma(torch.from_numpy(x), make_plan(shape, sigma),
                                  precision=rung, strip=True)
    np.testing.assert_array_equal(got.numpy(), _jax(x, shape, sigma, rung, strip=True))


@pytest.mark.parametrize("pipelined", [False, True])
def test_assembled_forms_equal_the_jax_assembled_kernels(pipelined):
    shape, sigma = (48, 1024), 4.0
    x = _frames(shape, seed=2)
    got = t_dma.blur_fused_u8_dma(torch.from_numpy(x), make_plan(shape, sigma),
                                  direct=False, pipelined=pipelined)
    want = _jax(x, shape, sigma, "int8", direct=False, pipelined=pipelined)
    np.testing.assert_array_equal(got.numpy(), want)


RESIDENT_CASES = [
    # (h, w, sigma, th): the JAX test's cases (r 12 over 16-row steps, a
    # ragged 200 / 48, an anisotropic plan), steps a multiple of 16 rows
    # (the tensor-core bodies' fragments)
    (96, 640, 4.0, 16),
    (200, 384, 11.0, 48),
    (104, 896, (2.0, 13.0), 32),
]


@pytest.mark.parametrize("h, w, sigma, th", RESIDENT_CASES)
@pytest.mark.parametrize("rung", ["int8", "hybrid"])
def test_resident_form_equals_the_jax_resident_kernel(h, w, sigma, th, rung):
    x = _frames((h, w), seed=3)
    got = t_dma.blur_fused_u8_dma(torch.from_numpy(x), make_plan((h, w), sigma),
                                  tile=(th, 0), precision=rung, resident=True)
    want = _jax(x, (h, w), sigma, rung, tile=(th, 0), resident=True)
    np.testing.assert_array_equal(got.numpy(), want)


A5_CASES = [
    # (h, w, rh, rw, th, tw): the JAX test's geometries
    (96, 256, 4, 4, 48, 128),
    (100, 200, 7, 3, 48, 128),
    (9, 129, 8, 128, 8, 128),
    (70, 250, 1, 140, 24, 128),
    (256, 384, 130, 5, 64, 256),
]


@pytest.mark.parametrize("h, w, rh, rw, th, tw", A5_CASES)
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_a5_plain_equals_jax_assemble_padded(h, w, rh, rw, th, tw, dtype):
    orh, orw, _, _, _, _, shp, swp = j_dma._align_geometry(th, tw, rh, rw)
    hp = (-(-h // th) - 1) * th + shp
    wp = (-(-w // tw) - 1) * tw + swp
    x = (np.random.default_rng(4).random((2, h, w)) * 255).astype(dtype)
    want = np.asarray(j_dma._assemble_padded(jnp.asarray(x), rh, rw, orh, orw, hp, wp))
    got = assemble.assemble_padded(torch.from_numpy(x), rh, rw, orh, orw, hp, wp)
    assert got.dtype == torch.from_numpy(x).dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        assemble.assemble_padded_ref(torch.from_numpy(x), rh, rw, orh, orw, hp, wp).numpy(),
        want)


@pytest.mark.parametrize("rung", ["int8", "hybrid", "bf16"])
@pytest.mark.parametrize("geometry", ["jax", "port"])
def test_padded_ref_equals_k1_plain(rung, geometry):
    shape, sigma = (60, 200), (3.0, 5.0)
    plan = make_plan(shape, sigma)
    rh, rw = plan.col.support_radius, plan.row.support_radius
    x = torch.from_numpy(_frames(shape, seed=5, planes=2))
    if geometry == "jax":
        orh, orw, _, _, _, _, shp, swp = j_dma._align_geometry(24, 128, rh, rw)
        hp, wp = 2 * 24 + shp, swp + 128
    else:
        geo = t_dma.k1_geometry("assembled", rung, plan, 2)
        orh, orw, hp, wp = rh, rw, geo.hp, geo.wp
    frame = assemble.assemble_padded(x, rh, rw, orh, orw, hp, wp)
    for out_u8 in (True, False) if rung != "int8" else (True,):
        got = t_dma.blur_fused_u8_padded_ref(frame, plan, orh, orw, rung, out_u8)
        assert torch.equal(got, _plain(x, plan, rung, out_u8))


# ---------------------------------------------------------------------------
# K1r's ring walk, modelled with the kernel's index arithmetic


def _r16(n):
    return (n + 15) & ~15


def _resident_model(x, plan, th, tw):
    """``k1_resident``'s walk for the int8 body: per column window, the rows
    output of rows-output row m (image row m - rh) at ring row m % R, R =
    round16(th + 2rh); step i computes rows up to R + i th, then its cols
    pass reads, for output row i th + ii, the ring rows of window rows ii +
    t in 16-row chunks from b0 = (i th) % R: chunk c at ring row (b0 + 16 c)
    % R, contiguous (R and b0 are multiples of 16, so no chunk straddles the
    wrap)."""
    ops = t_dma.int8_operands(plan)
    h, w = plan.shape
    rh, rw = plan.col.support_radius, plan.row.support_radius
    ring = _r16(th + 2 * rh)
    b_hi, b_lo = ops.q_col >> 7, ops.q_col & 127
    c1, c2, c3 = ops.epilogue_constants()
    nbh, nbw = -(-h // th), -(-w // tw)

    def refl(i, n):
        i = np.abs(i)
        i = np.where(i > n - 1, 2 * (n - 1) - i, i)
        return np.clip(i, 0, n - 1)

    out = np.zeros((h, w), np.uint8)
    xc = x.astype(np.int64) - 128
    for jw in range(nbw):  # one block per column window
        j0 = jw * tw
        cols = refl(np.arange(j0 - rw, j0 + tw + rw), w)
        d1 = np.full((ring, tw), -999, np.int64)
        d0 = np.full((ring, tw), -999, np.int64)
        for i in range(nbh):
            r_begin = 0 if i == 0 else ring + (i - 1) * th
            for m in range(r_begin, ring + i * th):
                row = xc[refl(np.array(m - rh), h)][cols]
                r = np.array([np.dot(row[c : c + 2 * rw + 1], ops.q_row) for c in range(tw)])
                e = (r + (1 << (ops.rows_shift - 1))) >> ops.rows_shift
                e1 = (e + 64) >> 7
                d1[m % ring], d0[m % ring] = e1, e - e1 * 128
            b0 = (i * th) % ring
            assert b0 % 16 == 0 and ring % 16 == 0
            for ii in range(th):
                gi = i * th + ii
                if gi >= h:
                    break
                offs = ii + np.arange(2 * rh + 1)
                rows = (b0 + offs // 16 * 16) % ring + offs % 16
                assert (rows < ring).all()
                s1, s0 = d1[rows], d0[rows]
                assert (s1 != -999).all()
                p1 = b_hi @ s1
                p23 = b_hi @ s0 + b_lo @ s1
                p4 = b_lo @ s0
                y = (np.float32(p1) * c1 + np.float32(p23) * c2) + np.float32(p4) * c3
                y = np.float32(y) + np.float32(128.0)
                v = np.clip(y + np.float32(0.5), 0, 255.5).astype(np.int32)
                keep = j0 + np.arange(tw) < w
                out[gi, j0 : j0 + tw][: keep.sum()] = v[keep].astype(np.uint8)
    return out


@pytest.mark.parametrize("h, w, sigma, th, tw", [
    (70, 100, 3.0, 16, 32),  # w % tw = 4: the last window is rows-passed whole
    (45, 70, (4.0, 2.0), 16, 32),  # th < 2rh: the ring wraps inside a cols read
])
def test_resident_ring_model_equals_k1_plain(h, w, sigma, th, tw):
    plan = make_plan((h, w), sigma)
    x = _frames((h, w), seed=6, planes=1)
    want = t_dma.blur_fused_u8_dma_ref(torch.from_numpy(x), plan)[0].numpy()
    np.testing.assert_array_equal(_resident_model(x[0], plan, th, tw), want)
    geo = t_dma.k1_geometry("resident", "int8", plan, 1, (th, tw))
    assert -(-w // geo.tw) * geo.tw >= w  # the launch covers every column
    assert t_dma.tc_layout("resident", "int8", th, tw, plan.col.support_radius,
                           plan.row.support_radius).rows == _r16(th + 2 * plan.col.support_radius)


# ---------------------------------------------------------------------------
# gates


def test_one_policy_serves_the_check_and_the_launch(monkeypatch):
    """The dispatcher's choice and the form wrapper's launch ask
    ``k1_geometry`` the same question and get the same geometry (the JAX
    impl asks two chunk policies, ADVICE.md)."""
    calls = []
    real = t_dma.k1_geometry

    def spy(*args, **kw):
        geo = real(*args, **kw)
        calls.append((args, geo))
        return geo

    monkeypatch.setattr(t_dma, "k1_geometry", spy)
    plan = make_plan((96, 640), 4.0)
    x = torch.from_numpy(_frames((96, 640), seed=7))
    for kw in (dict(resident=True), dict(strip=True), dict(direct=False)):
        calls.clear()
        t_dma.blur_fused_u8_dma(x, plan, **kw)
        assert len(calls) == 2 and calls[0] == calls[1], kw
        assert calls[0][1] is not None


@pytest.mark.parametrize("kw, match", [
    (dict(strip=True), "strip=True"),  # r 332: the window does not fit
    (dict(resident=True, tile=(2048, 0)), "resident=True"),  # a ring too tall
    (dict(resident=True, precision="bf16"), "resident=True"),  # no bf16 ring
    (dict(pipelined=True, precision="hybrid"), "pipelined=True"),  # int8 only
    (dict(strip=True, resident=True), "exclude"),
    (dict(direct=True, pipelined=True), "exclude"),
])
def test_pinned_forms_raise_where_they_do_not_serve(kw, match):
    plan = make_plan((2160, 1200), 100.0)
    x = torch.zeros((12, 2160, 1200), dtype=torch.uint8)
    with pytest.raises(ValueError, match=match):
        t_dma.blur_fused_u8_dma(x, plan, **kw)


def test_pipelined_needs_two_windows():
    plan = make_plan((40, 60), 2.0)
    with pytest.raises(ValueError, match="pipelined=True"):
        t_dma.blur_fused_u8_dma(torch.zeros((3, 40, 60), dtype=torch.uint8), plan,
                                pipelined=True)


def test_geometry_sized_by_the_device(monkeypatch):
    plan = make_plan((512, 512), 20.0)  # r 65
    small = dataclasses.replace(hw.device_spec("cpu"), smem_optin_bytes=48 * 1024)
    assert t_dma.k1_geometry("strip", "int8", plan, 12) is not None
    monkeypatch.setattr(t_dma, "device_spec", lambda device: small)
    assert t_dma.k1_geometry("strip", "int8", plan, 12) is None
    geo = t_dma.k1_geometry("resident", "int8", plan, 12)
    assert geo.smem <= small.smem_optin_bytes
    assert t_dma.k1_geometry("resident", "int8", plan, 12, (256, 0)) is None
    with pytest.raises(ValueError, match="strip=True"):
        t_dma.blur_fused_u8_dma(torch.zeros((12, 512, 512), dtype=torch.uint8), plan,
                                strip=True)


def test_layout_matches_the_kernels_formula():
    """``layout_bytes`` is ``tc_layout`` of ``csrc/fused_dma.cu``: the int8
    direct form at 4K r 32 (240 x 64 tiles): the digit planes of 336 rows
    (the cols pass's fragments read 256 - 16 + 3 k-steps of 32), two staged
    groups of 64 rows of 144 window bytes (3 k-steps of 32 past 48), and the
    host's tap tables: a 16-byte header (128 Q) and the two digits' four tap
    copies of 40 words (8 a step, 4 more, = 8 mod 32) an axis: 64,016
    bytes."""
    plan = make_plan((2160, 3840), 10.0)
    geo = t_dma.k1_geometry("direct", "int8", plan, 12)
    assert (geo.th, geo.tw) == (240, 64)
    plane, stage, taps = 2 * 64 * 336, 2 * 64 * 144, 16 + 4 * 8 * 40 * 2
    assert geo.smem == plane + stage + taps == 64016
    assert t_dma.tc_tables(plan, "int8", False).numel() * 4 == taps
    hyb = t_dma.k1_geometry("direct", "hybrid", plan, 12)
    # bf16 y of 256 + 16 * 5 rows at 144 bytes a row, the header, one tap
    # copy table and 5 + 14 tap groups of 12 words
    assert hyb.smem == 336 * 144 + stage + 16 + 4 * 8 * 40 + 4 * 12 * 19 == 69024


# ---------------------------------------------------------------------------
# routing by the device's measured rule


def _route(monkeypatch, **fields):
    spec = dataclasses.replace(hw.device_spec("cpu"), **fields)
    monkeypatch.setattr(t_dma, "device_spec", lambda device: spec)
    ran = []
    for name in ("blur_fused_u8_strip", "blur_fused_u8_resident", "blur_fused_u8_assembled"):
        real = getattr(t_dma, name)

        def spy(*args, _real=real, _name=name, **kw):
            ran.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(t_dma, name, spy)
    return ran


def _rows(steps, planes=1, rungs=("int8", "hybrid")):
    """A ``k1_forms`` table with the same steps for each rung."""
    return tuple((rung, planes, steps) for rung in rungs)


_RES, _ASM = "resident", "assembled"


@pytest.mark.parametrize("table, planes, want", [
    (_rows(((10, _RES),)), 3, ["blur_fused_u8_resident"]),
    (_rows(((20, _RES),)), 3, []),
    (_rows(((10, _RES), (11, "direct"))), 3, []),
    (_rows(((10, _RES),), planes=12), 12, ["blur_fused_u8_resident"]),
    (_rows(((10, _RES),), planes=12), 3, []),
    (_rows(((12, _ASM),)), 3, ["blur_fused_u8_assembled"]),
    (_rows(((13, _ASM),)), 3, []),
    (_rows(((10, _RES), (12, _ASM))), 3, ["blur_fused_u8_assembled"]),
    (_rows(((10, _ASM),), 3) + _rows(((10, _RES),), 12), 12, ["blur_fused_u8_resident"]),
    (_rows(((10, _ASM),), 3) + _rows(((10, _RES),), 12), 3, ["blur_fused_u8_assembled"]),
    (_rows(((10, _ASM),), 3) + _rows(((10, _RES),), 12), 6, ["blur_fused_u8_assembled"]),
    ((), 12, []),
])
def test_auto_routes_the_measured_form(monkeypatch, table, planes, want):
    ran = _route(monkeypatch, k1_forms=table)
    shape = (48, 160)
    plan = make_plan(shape, 4.0)  # r 12
    img = torch.from_numpy(np.moveaxis(_frames(shape, seed=8, planes=planes), 0, -1).copy())
    img = img.reshape(planes // 3, *shape, 3)
    for rung in ("int8", "hybrid"):
        ran.clear()
        got = blur_u8(img, 4.0, precision=rung)
        assert ran == want, (rung, ran)
        assert torch.equal(got, from_planar(_plain(img.movedim(-1, -3).contiguous(), plan,
                                                   rung)))


def test_the_rule_is_per_rung(monkeypatch):
    ran = _route(monkeypatch, k1_forms=_rows(((10, _RES),), rungs=("int8",))
                 + _rows(((10, _ASM),), rungs=("hybrid",)))
    img = torch.from_numpy(np.moveaxis(_frames((48, 160), seed=10), 0, -1).copy())
    for rung, want in (("int8", "blur_fused_u8_resident"),
                       ("hybrid", "blur_fused_u8_assembled")):
        ran.clear()
        blur_u8(img, 4.0, precision=rung)
        assert ran == [want], rung


def test_strip_runs_by_keyword_only(monkeypatch):
    """No rule routes K1s; ``strip=True`` does, with K1's result."""
    ran = _route(monkeypatch, k1_forms=_rows(((0, _RES),)))
    plan = make_plan((48, 160), 4.0)
    x = torch.from_numpy(_frames((48, 160), seed=11, planes=12))
    for rung in ("int8", "hybrid"):
        ran.clear()
        got = t_dma.blur_fused_u8_dma(x, plan, precision=rung, strip=True)
        assert ran == ["blur_fused_u8_strip"]
        assert torch.equal(got, _plain(x, plan, rung))
        ran.clear()
        t_dma.blur_fused_u8_dma(x, plan, precision=rung, strip=None)
        assert ran == ["blur_fused_u8_resident"]


def test_k1_form_reads_the_nearest_measured_point_below():
    spec = dataclasses.replace(
        hw.device_spec("cpu"),
        k1_forms=_rows(((50, _ASM), (100, _RES), (200, "direct")), 3, ("int8",))
        + _rows(((20, _RES),), 12, ("int8",)))
    assert [spec.k1_form("int8", 3, r) for r in (49, 50, 99, 100, 199, 200)] == [
        "direct", _ASM, _ASM, _RES, _RES, "direct"]
    assert spec.k1_form("int8", 2, 150) == "direct"  # fewer planes than any row
    assert spec.k1_form("int8", 11, 150) == _RES  # the 3-plane row
    assert spec.k1_form("int8", 48, 150) == _RES and spec.k1_form("int8", 48, 10) == "direct"
    assert spec.k1_form("hybrid", 12, 150) == "direct"  # no row for the rung


def _form(plan, planes, rung="hybrid"):
    return t_dma._resolve_form(plan, rung, planes, None, "cpu", direct=None, strip=None,
                               pipelined=False, resident=None).form


def test_the_cpu_spec_runs_k1_direct():
    spec = hw.device_spec("cpu")
    assert spec.k1_forms == ()
    for sigma in (10.0, 50.0, 180.0):
        assert _form(make_plan((2160, 3840), sigma), 12) == "direct"


@pytest.mark.parametrize("sigma, planes, rung, want", [
    (10.0, 12, "hybrid", "direct"),  # r 32
    (15.0, 12, "int8", "direct"),  # r 49
    (30.0, 12, "hybrid", "resident"),  # r 99
    (100.0, 12, "int8", "resident"),  # r 332
    (100.0, 12, "hybrid", "resident"),
    (75.0, 3, "int8", "assembled"),  # r 248 on 3 planes
    (100.0, 3, "hybrid", "resident"),  # r 332
    (100.0, 6, "int8", "resident"),  # r 332 on 6 planes
    (20.0, 9, "hybrid", "resident"),  # 9 planes: the 6-plane row, r 65
    (30.0, 9, "hybrid", "direct"),  # ... r 99, back to direct there
    (10.0, 1, "hybrid", "direct"),  # fewer planes than any row
    (180.0, 12, "int8", "resident"),  # r 598
    (75.0, 3, "hybrid", "assembled"),  # r 248
])
def test_the_h100_rule(monkeypatch, sigma, planes, rung, want):
    spec = hw.spec_for("NVIDIA H100 80GB HBM3", 132, 232448, 80 << 30)
    monkeypatch.setattr(t_dma, "device_spec", lambda device: spec)
    assert _form(make_plan((2160, 3840), sigma), planes, rung) == want


def test_measured_form_rule_holds_devicespec_fields():
    fields = {f.name for f in dataclasses.fields(hw.DeviceSpec)}
    for name, entry in hw._MEASURED_K1_FORM.items():
        assert set(entry) <= fields, name
        spec = hw.spec_for(name, 132, 232448, 80 << 30)
        for k, v in entry.items():
            assert getattr(spec, k) == v


def test_auto_through_the_api_keeps_its_result(monkeypatch):
    """AUTO's rung through ``blur_u8`` with a form routed equals the same
    call with none routed (the forms compute K1's function)."""
    img = torch.from_numpy(np.moveaxis(_frames((48, 160), seed=9), 0, -1).copy())
    base = blur_u8(img, 4.0)
    _route(monkeypatch, k1_forms=_rows(((1, _RES),)))
    assert torch.equal(blur_u8(img, 4.0), base)
    assert api._u8_dma_precision(make_plan((48, 160), 4.0), hw.device_spec("cpu")) == "int8"


# ---------------------------------------------------------------------------
# the uint8 split radius, AUTO's rung and the route floor on the H100's spec


def _h100(monkeypatch):
    from blur_algorithms_tpu_torch.cuda_kernels import fused_blur

    spec = hw.spec_for("NVIDIA H100 80GB HBM3", 132, 232448, 80 << 30)
    for mod in (api, fused_blur, t_dma):
        monkeypatch.setattr(mod, "device_spec", lambda device: spec)
    return spec


def test_uint8_has_its_own_split_radius(monkeypatch):
    """On the H100's spec K1's uint8 path splits from r 82 (the phase 13
    uint8 sweep from r 1), the float path from r 19 (the float sweep from r
    2, K2 on 3xTF32); K2's uint8 path (the bf16x3 rung) keeps the float
    radius; an unmeasured device has no uint8 entry and splits uint8 where
    it splits float."""
    from blur_algorithms_tpu_torch.cuda_kernels import fused_blur

    assert hw.device_spec("cpu").fused_split_min_radius_u8 is None
    spec = _h100(monkeypatch)
    assert (spec.fused_split_min_radius_u8, spec.fused_split_min_radius) == (82, 19)
    r65, r82 = make_plan((2160, 3840), 20.0), make_plan((2160, 3840), 25.0)
    assert (r65.row.support_radius, r82.row.support_radius) == (65, 82)
    assert not fused_blur._split_wins(r65, 1, "int8", "cpu")
    assert fused_blur._split_wins(r82, 1, "int8", "cpu")
    assert fused_blur._split_wins(r65, 4, "bf16x3", "cpu")  # float: from r 19
    assert fused_blur._split_wins(r65, 1, "bf16x3", "cpu")  # K2's uint8 path too
    other = dataclasses.replace(spec, fused_split_min_radius_u8=None)
    monkeypatch.setattr(fused_blur, "device_spec", lambda device: other)
    assert fused_blur._split_wins(r65, 1, "int8", "cpu")


@pytest.mark.parametrize("sigma, want", [
    (10.0, ["hybrid"]),  # r 32: K1's hybrid body, no split
    (26.0, ["split"]),  # r 85: past the uint8 split radius
])
def test_auto_runs_k1_hybrid_under_the_uint8_split_radius(monkeypatch, sigma, want):
    from blur_algorithms_tpu_torch.cuda_kernels import fused_blur

    _h100(monkeypatch)
    ran = []
    real_k1, real_split = t_dma.blur_fused_u8_dma, fused_blur._blur_fused_split

    def k1(*args, **kw):
        ran.append(kw.get("precision", "int8"))
        return real_k1(*args, **kw)

    def split(*args, **kw):
        ran.append("split")
        return real_split(*args, **kw)

    monkeypatch.setattr(t_dma, "blur_fused_u8_dma", k1)
    monkeypatch.setattr(api, "blur_fused_u8_dma", k1)
    monkeypatch.setattr(fused_blur, "_blur_fused_split", split)
    img = torch.from_numpy(np.moveaxis(_frames((192, 256), seed=13), 0, -1).copy())
    plan = make_plan((192, 256), sigma)
    assert api._u8_dma_precision(plan, hw.spec_for("NVIDIA H100 80GB HBM3", 132, 232448,
                                                   80 << 30)) == "hybrid"
    got = blur_u8(img, sigma)
    assert ran == want
    if want == ["hybrid"]:
        assert torch.equal(got, from_planar(_plain(img.movedim(-1, -3).contiguous(), plan,
                                                   "hybrid")))


def test_route_floor_counts_only_the_radii_k1_runs_at():
    """The route section's floor for a rung reads K1's times under the
    device's uint8 split radius (the record's ``k1_ceiling``) only: past it
    AUTO runs the split. The H100's times in turns: hybrid faster than int8
    to r 64, slower at r 104, 331 and 597."""
    from blur_algorithms_tpu_torch import certify

    k1 = {7: (6, 0.3686, 0.3297), 33: (32, 0.5192, 0.4412), 65: (64, 0.6999, 0.6662),
          105: (104, 1.0450, 1.1212), 332: (331, 4.9113, 5.0410),
          598: (597, 20.2976, 31.5824)}
    route = {"k1": {rt: {"radius": r, "int8": a, "hybrid": b} for rt, (r, a, b) in k1.items()},
             "split": {831: {"radius": 831, "int8": 2.29, "hybrid": 1.40}}}
    assert certify.entry({"route": {**route, "k1_ceiling": None}}) == {
        "hybrid_route_min_radius": None}
    assert certify.entry({"route": {**route, "k1_ceiling": 82}}) == {
        "hybrid_route_min_radius": 0}
    assert certify.k1_ceiling(hw.spec_for("NVIDIA H100 80GB HBM3", 132, 232448,
                                          80 << 30)) == 82
    assert certify.k1_ceiling(hw.device_spec("cpu")) is None
