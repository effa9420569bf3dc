"""The hybrid and bf16 rungs of the precision ladder against the JAX package.

K1's hybrid and bf16 bodies (``cuda_kernels/fused_dma.py``) and the
split's hybrid pass 2 (``cuda_kernels/fused_split.py``) run CUDA kernels on
a card and their plain PyTorch versions on a CPU tensor. Here, on the CPU:

- the port's tap vectors equal every column of the JAX ``_band_operands``;
- the K1 plain versions are bit-identical to the JAX bodies
  ``_blur_fused_dma_impl(x, plan, rung, out_u8, direct=True)`` in interpret
  mode (a bf16 product is exact in f32, so a sum in the same order is the
  same number), for float32 and uint8 output: always with the bodies' dots
  summed in ascending order, as the kernels sum, and as the bodies run
  where XLA's CPU dot sums in that order too;
- the split's hybrid pass 2 is within two f32 ulps at 128..256 (3.1e-5) of
  the JAX ``_kernel_int8`` ``hybrid_cols`` form, which adds one partial sum
  per neighbour block, uint8 within 1, constant frames exact;
- AUTO routes a rung only inside the floor of the plan's own tap family
  (the fake ``DeviceSpec`` cases), the hybrid pin raises where K1's body
  cannot serve, and ``certify.py`` keeps the JAX protocol's patterns,
  oracle and boundary rules.
"""

import pathlib
import sys
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from blur_algorithms_tpu.ops.plan import make_plan as j_make_plan  # noqa: E402
from blur_algorithms_tpu.pallas_kernels import fused_blur as j_fused  # noqa: E402
from blur_algorithms_tpu.pallas_kernels import fused_dma as j_dma  # noqa: E402
from blur_algorithms_tpu_torch import api, certify  # noqa: E402
from blur_algorithms_tpu_torch import blur_u8, box_blur, make_custom_plan, make_plan  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fused_blur as t_fused  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fused_dma as t_dma  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fused_split as t_split  # noqa: E402
from blur_algorithms_tpu_torch.ops.layout import from_planar  # noqa: E402
from blur_algorithms_tpu_torch.utils.hw import DeviceSpec  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "benchmarks"))
import certify_device as j_certify_device  # noqa: E402
import default_prec_cert as j_cert  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test. The plain versions sum tap by tap in small
    torch ops; beside the suite's other workers their intra-op threads wait
    on one another (the r 4096 rows case of test_torch_split_tiling.py: 0.1 s
    alone, 65 s beside seven busy processes, on 8 cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

RUNGS = ("hybrid", "bf16")
PLAIN = {"hybrid": t_dma.blur_fused_u8_hybrid_ref, "bf16": t_dma.blur_fused_u8_bf16_ref}
# (h, w), sigma: single and multi tile, anisotropic both ways, ragged
# widths; the last two have long sums on both axes
CASES = [
    ((48, 256), 2.0),
    ((64, 300), (7.0, 3.0)),
    ((96, 384), 18.0),
    ((41, 199), 5.0),
    ((80, 257), (2.5, 12.0)),
    ((96, 640), 30.0),
    ((256, 200), 40.0),
]


def _long_sums(plan, rung) -> bool:
    """Whether the JAX body's f32 sums are long enough that XLA's CPU dot
    (oneDNN, bf16 products; AMX-BF16 on x86 hosts that have it) may take
    them in its own blocked order: the bf16 rung's rows sums (128 columns
    of the chunk + 2rw terms) from rw ~20, the hybrid's column sums
    (24..48 rows + 2rh) from rh ~60. There the plain version, which sums
    in ascending order as the kernels do, may differ by a rounding of those
    sums; ``_ascending_dot`` shows that this order is the whole difference.
    On an x86 host with AMX-BF16 and jax 0.9 the bodies as they run differ
    from the plain versions in this many f32 values of ``CASES`` (hybrid,
    bf16): 96x384 sigma 18 (0, 95 of 73,728), 80x257 sigma (2.5, 12)
    (0, 15 of 41,120), 96x640 sigma 30 (1,778, 81,798 of 122,880),
    256x200 sigma 40 (1,983, 76,223 of 102,400); none in the others."""
    if rung == "bf16":
        return plan.row.support_radius > 16
    return plan.col.support_radius > 60


def _frames(shape, seed, planes=2):
    rng = np.random.default_rng(seed)
    return (rng.random((planes, *shape)) * 255).astype(np.uint8)


def _jax_body(x, shape, sigma, rung, out_u8):
    return np.asarray(j_dma._blur_fused_dma_impl(
        jnp.asarray(x), j_make_plan(shape, sigma), rung, out_u8, direct=True))


def _ascending_dot(lhs, rhs, dimension_numbers, precision=None,
                   preferred_element_type=None, **_):
    """``jax.lax.dot_general`` (one contracting axis, no batch axes) summed
    in ascending order of the contracting index, one rounding per term:
    the order of the plain versions and the kernels. The band operands'
    zeros add nothing, and a bf16 or int8 product is exact."""
    (ca, cb), (ba, bb) = dimension_numbers
    assert len(ca) == len(cb) == 1 and not ba and not bb
    t = preferred_element_type
    a = jnp.moveaxis(lhs, ca[0], 0).astype(t)
    b = jnp.moveaxis(rhs, cb[0], 0).astype(t)
    return jax.lax.fori_loop(0, a.shape[0], lambda k, acc: acc + a[k][:, None] * b[k][None, :],
                             jnp.zeros((a.shape[1], b.shape[1]), t))


def _jax_body_ascending(monkeypatch, x, shape, sigma, rung, out_u8):
    """The JAX body with every dot summed in ascending order (traced anew:
    the caches are cleared before and after)."""
    jax.clear_caches()
    try:
        with monkeypatch.context() as m:
            m.setattr(jax.lax, "dot_general", _ascending_dot)
            return _jax_body(x, shape, sigma, rung, out_u8)
    finally:
        jax.clear_caches()


# ---------------------------------------------------------------------------
# operands


@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("shape, sigma", [
    ((48, 640), 3.0), ((2160, 3840), 10.0), ((1080, 1920), (5.0, 11.0)),
    ((1300, 1400), 180.0),
])
@pytest.mark.parametrize("chunks", [(128, 24), (256, 40)])
def test_rung_operands_equal_jax_band_operands(rung, shape, sigma, chunks):
    """Every column k of the JAX band operands holds the port's tap vector
    from row k on (int8 digits or the bf16 hi half), zeros elsewhere."""
    cw, ch = chunks
    plan = make_plan(shape, sigma)
    bw, bh, shift, scale = j_dma._band_operands(j_make_plan(shape, sigma), rung, cw, ch)
    bw, bh = np.asarray(bw).astype(np.float32), np.asarray(bh).astype(np.float32)
    if rung == "hybrid":
        ops = t_dma.hybrid_operands(plan)
        rows, cols = ops.q_row.astype(np.float32), ops.c_col
        bw = 128 * bw[0] + bw[1]
        assert (shift, scale) == (ops.rows_shift, 1)
        assert ops.scale == np.float32(1.0 / (127.0 * (1 << shift)))
    else:
        ops = t_dma.bf16_operands(plan)
        rows, cols = ops.c_row, ops.c_col
        bw = bw[0]
    for mat, taps, n in ((bw, rows, cw), (bh[0], cols, ch)):
        for k in range(n):
            col = np.zeros(mat.shape[0], np.float32)
            col[k : k + taps.size] = taps
            np.testing.assert_array_equal(mat[:, k], col)


# ---------------------------------------------------------------------------
# K1's hybrid and bf16 bodies


@pytest.mark.parametrize("out_u8", [True, False], ids=["uint8", "f32"])
@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("shape, sigma", CASES)
def test_plain_bodies_bit_identical_to_jax(monkeypatch, shape, sigma, rung, out_u8):
    """Bit for bit with the JAX body's dots summed in ascending order, at
    every case. With its dots as XLA's CPU runs them: bit for bit too where
    the sums are short; where they are long (``_long_sums``), within one f32
    rounding of the hybrid's column sum (two ulps at 128..256) or one bf16
    step (1.0 below 256) of one bf16 row intermediate times the largest
    column tap, and uint8 within 1."""
    x = _frames(shape, seed=shape[0] * 1000 + shape[1])
    plan = make_plan(shape, sigma)
    got = PLAIN[rung](torch.from_numpy(x), plan, out_u8=out_u8)
    assert got.dtype == (torch.uint8 if out_u8 else torch.float32)
    np.testing.assert_array_equal(
        got.numpy(), _jax_body_ascending(monkeypatch, x, shape, sigma, rung, out_u8))
    want = _jax_body(x, shape, sigma, rung, out_u8)
    if not _long_sums(plan, rung):
        np.testing.assert_array_equal(got.numpy(), want)
        return
    d = np.abs(got.numpy().astype(np.float64) - want.astype(np.float64))
    if out_u8:
        limit = 1
    elif rung == "hybrid":
        limit = 3.1e-5
    else:
        limit = 2 * float(t_dma.bf16_operands(plan).c_col.max())
    assert d.max() <= limit, (d.max(), limit)


@pytest.mark.parametrize("rung", RUNGS)
def test_plain_bodies_extreme_content(rung):
    """Saturated, constant and striped frames: bit-identical to JAX, and in
    [0, 255]; the hybrid rung keeps a constant frame constant."""
    shape, sigma = (48, 300), 4.0
    x = np.zeros((4, *shape), np.uint8)
    x[1], x[2], x[3, ::2] = 255, 77, 255
    want = _jax_body(x, shape, sigma, rung, True)
    got = PLAIN[rung](torch.from_numpy(x), make_plan(shape, sigma)).numpy()
    np.testing.assert_array_equal(got, want)
    if rung == "hybrid":
        assert (got[0] == 0).all() and (got[1] == 255).all() and (got[2] == 77).all()


@pytest.mark.parametrize("rung", RUNGS)
def test_wrappers_run_the_plain_version_on_the_cpu(rung):
    plan = make_plan((40, 96), 3.0)
    x = torch.from_numpy(_frames((40, 96), seed=3, planes=3))
    fn = t_dma.blur_fused_u8_hybrid if rung == "hybrid" else t_dma.blur_fused_u8_bf16
    before = fn.launches
    for out_u8 in (True, False):
        assert torch.equal(fn(x, plan, out_u8), PLAIN[rung](x, plan, out_u8))
    assert fn.launches == before


@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("plan, ok", [
    (make_plan((64, 64), 3.0), {"hybrid", "bf16"}),
    (make_plan((64, 64), (3.0, 0.1)), set()),  # radius-0 row axis
    (make_custom_plan((64, 64), [-0.25, 1.5, -0.25]), {"bf16"}),  # signed taps
    (make_plan((1400, 1400), 200.0), set()),  # r 665 > 600
])
def test_domain_per_rung(rung, plan, ok):
    assert t_dma.dma_form_applicable(torch.uint8, plan, rung) == (rung in ok)
    assert not t_dma.dma_form_applicable(torch.float32, plan, rung)
    if rung not in ok:
        x = torch.zeros((1, *plan.shape), dtype=torch.uint8)
        fn = t_dma.blur_fused_u8_hybrid if rung == "hybrid" else t_dma.blur_fused_u8_bf16
        with pytest.raises(ValueError, match=rung):
            fn(x, plan)


def _round_f32(q: Fraction) -> np.float32:
    """The float32 nearest the exact rational ``q`` (ties to even)."""
    f = np.float32(float(q))
    best = None
    for c in (np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))):
        d = abs(Fraction(float(c)) - q)
        even = int(np.float32(c).view(np.int32)) % 2 == 0
        if best is None or d < best[0] or (d == best[0] and even):
            best = (d, c)
    return best[1]


def test_fma_ref_rounds_once():
    """The plain versions' fma: one rounding of the exact ``a * b + c``
    (a separate product and sum round twice and differ on some values)."""
    rng = np.random.default_rng(0)
    a = (rng.standard_normal(4000) * 3e6).astype(np.float32)
    b, c = np.float32(1.0 / (127.0 * 2 ** 9)), np.float32(128.0)
    got = t_dma.fma_f32_ref(torch.from_numpy(a), b, c).numpy()
    want = np.array([_round_f32(Fraction(float(v)) * Fraction(float(b)) + 128)
                     for v in a], dtype=np.float32)
    np.testing.assert_array_equal(got, want)
    assert ((a * b + c).astype(np.float32) != got).any()


# ---------------------------------------------------------------------------
# the split's hybrid pass 2


@pytest.mark.parametrize("shape, sigma", [
    ((64, 80), 18.0),
    ((40, 200), 3.0),
    ((300, 24), (70.0, 2.0)),
])
def test_split_hybrid_pass2_against_jax(monkeypatch, shape, sigma):
    monkeypatch.setattr(j_fused, "_FORCE_INTERPRET", True)
    monkeypatch.setattr(j_fused, "_hybrid_cols_ok", lambda plan: True)
    plan, jplan = make_plan(shape, sigma), j_make_plan(shape, sigma)
    rows, cols = t_fused._split_plans(plan)
    x = _frames(shape, seed=11)
    e = t_split.fused_split_rows_int8_ref(torch.from_numpy(x), rows, out_e32=True)
    for out_u8 in (False, True):
        want = np.asarray(j_fused._blur_fused_split(jnp.asarray(x), jplan, "int8",
                                                    out_u8=out_u8))
        got = t_split.fused_split_cols_hybrid_ref(e, cols, out_u8=out_u8).numpy()
        d = np.abs(got.astype(np.float64) - want.astype(np.float64))
        assert d.max() <= (1 if out_u8 else 3.1e-5), d.max()


def test_split_hybrid_pass2_constant_frames():
    plan = make_plan((32, 32), 6.0)
    rows, cols = t_fused._split_plans(plan)
    for level in (0, 127, 255):
        x = torch.full((1, 32, 32), level, dtype=torch.uint8)
        e = t_split.fused_split_rows_int8(x, rows, out_e32=True)
        out = t_split.fused_split_cols_hybrid(e, cols)
        assert bool((out == level).all()), level


# ---------------------------------------------------------------------------
# routing under fake DeviceSpecs


def _spec(**kw):
    return DeviceSpec(name="fake", sm_count=1, smem_optin_bytes=1, **kw)


GAUSS = make_plan((256, 256), 10.0)  # r 32
BOX = api._box_plan(256, 256, 16, 2, "auto")  # box_fast, support 32


def test_box_taps_do_not_use_the_gaussian_floor():
    """The fault this slice repaired: a gaussian floor alone leaves box
    taps on int8 (and the split's pass 2 exact)."""
    spec = _spec(hybrid_cert_min_radius=2, hybrid_split_cert_max_radius=4096)
    assert api._u8_dma_precision(GAUSS, spec) == "hybrid"
    assert api._u8_dma_precision(BOX, spec) == "int8"
    assert spec.hybrid_split_cert_max_radius_for("box_fast") is None


@pytest.mark.parametrize("kw, gauss, box", [
    ({}, "int8", "int8"),  # an unmeasured device
    ({"hybrid_cert_min_radius": 3, "hybrid_cert_min_radius_box": 2}, "hybrid", "hybrid"),
    ({"hybrid_cert_min_radius": 3, "hybrid_cert_min_radius_box": 40}, "hybrid", "int8"),
    ({"hybrid_cert_min_radius": 40}, "int8", "int8"),  # under the floor
    # route floors: the rung runs only where it also wins on time
    ({"hybrid_cert_min_radius": 3, "hybrid_route_min_radius": 50}, "int8", "int8"),
    ({"hybrid_cert_min_radius": 3, "hybrid_route_min_radius": None}, "int8", "int8"),
    ({"hybrid_cert_min_radius": 3, "hybrid_route_min_radius": 32,
      "hybrid_cert_min_radius_box": 2}, "hybrid", "hybrid"),
    # bf16 after hybrid: one floor for both tap families, as in the JAX
    # package (it certifies bf16 on gaussian taps only)
    ({"bf16_cert_min_radius": 16}, "bf16", "bf16"),
    ({"bf16_cert_min_radius": 40}, "int8", "int8"),
    ({"bf16_cert_min_radius": 16, "bf16_route_min_radius": None}, "int8", "int8"),
    ({"bf16_cert_min_radius": 2, "hybrid_cert_min_radius": 2}, "hybrid", "bf16"),
])
def test_rung_floors_per_tap_family(kw, gauss, box):
    spec = _spec(**kw)
    assert api._u8_dma_precision(GAUSS, spec) == gauss
    assert api._u8_dma_precision(BOX, spec) == box


@pytest.mark.parametrize("plan, want", [
    (make_custom_plan((64, 64), [0.25, 0.5, 0.25]), "int8"),  # no tap family
    (make_custom_plan((64, 64), [-0.25, 1.5, -0.25]), "bf16x3"),
    (make_plan((64, 64), (3.0, 0.1)), "bf16x3"),  # radius-0 row axis
    (make_plan((64, 64), 1.0), "int8"),  # r 4, under the floor of 5
    (make_plan((1400, 1400), 200.0), "int8"),  # past K1's 600
])
def test_rungs_only_where_k1_serves_them(plan, want):
    spec = _spec(hybrid_cert_min_radius=5, bf16_cert_min_radius=5,
                 hybrid_cert_min_radius_box=5)
    assert api._u8_dma_precision(plan, spec) == want


@pytest.mark.parametrize("kw, kernel, radii, ok", [
    ({"hybrid_cert_min_radius": 10, "hybrid_split_cert_max_radius": 2000},
     "gaussian", (700, 40), True),
    ({"hybrid_cert_min_radius": 10, "hybrid_split_cert_max_radius": 2000},
     "gaussian", (2100, 40), False),  # past the ceiling
    ({"hybrid_cert_min_radius": 10, "hybrid_split_cert_max_radius": 2000},
     "gaussian", (700, 2), False),  # under the floor
    ({"hybrid_cert_min_radius": 10}, "gaussian", (700, 40), False),  # no ceiling
    ({"hybrid_cert_min_radius": 10, "hybrid_split_cert_max_radius": 2000,
      "hybrid_cert_min_radius_box": 2}, "box_fast", (700, 700), False),
    ({"hybrid_cert_min_radius": 10, "hybrid_split_cert_max_radius_box": 1022,
      "hybrid_cert_min_radius_box": 2}, "box_fast", (700, 700), True),
    ({"hybrid_cert_min_radius": 10, "hybrid_split_cert_max_radius": 2000,
      "hybrid_route_min_radius": None}, "gaussian", (700, 40), False),
])
def test_split_hybrid_gate(monkeypatch, kw, kernel, radii, ok):
    rh, rw = radii
    if kernel == "box_fast":
        plan = api._box_plan(2 * rh + 2, 2 * rw + 2, rh // 2, 2, "auto")
    else:
        plan = make_plan((2 * rh + 2, 2 * rw + 2), (rh / 3.3267, rw / 3.3267))
    monkeypatch.setattr(t_fused, "device_spec", lambda device: _spec(**kw))
    assert t_fused._hybrid_cols_ok(plan, "cpu") == ok


def test_split_runs_the_hybrid_pass2_where_the_gate_holds(monkeypatch):
    calls = []
    spy = lambda e, plan, out_u8=True: calls.append(plan) or t_split.fused_split_cols_hybrid_ref(  # noqa: E731
        e, plan, out_u8)
    monkeypatch.setattr(t_split, "fused_split_cols_hybrid", spy)
    plan = make_plan((24, 1400), 200.0)  # rows r 665: the split
    x = torch.from_numpy(_frames((24, 1400), seed=5, planes=1))
    exact = t_fused.blur_fused_u8(x, plan)
    assert not calls
    monkeypatch.setattr(t_fused, "device_spec", lambda device: _spec(
        hybrid_cert_min_radius=3, hybrid_split_cert_max_radius=4096))
    hybrid = t_fused.blur_fused_u8(x, plan, "hybrid")
    assert len(calls) == 1
    assert int((hybrid.int() - exact.int()).abs().max()) <= 1


def test_auto_runs_the_routed_rung(monkeypatch):
    spec = _spec(hybrid_cert_min_radius=3, hybrid_cert_min_radius_box=2,
                 bf16_cert_min_radius=2)
    monkeypatch.setattr(api, "device_spec", lambda device: spec)
    img = torch.from_numpy(np.moveaxis(_frames((40, 96), seed=8, planes=3), 0, -1).copy())
    planar = img.movedim(-1, -3).contiguous()
    got = blur_u8(img, 3.0)
    want = from_planar(t_dma.blur_fused_u8_hybrid_ref(planar, make_plan((40, 96), 3.0)))
    assert torch.equal(got, want)
    # a box plan through box_blur routes by the box floors
    got = box_blur(img, 2.0)
    want = from_planar(t_dma.blur_fused_u8_hybrid_ref(planar, api._box_plan(40, 96, 4, 2, "auto")))
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the hybrid pin


def test_hybrid_pin_equals_the_jax_body():
    shape, sigma = (48, 200), 4.0
    x = _frames(shape, seed=9, planes=3)
    img = torch.from_numpy(np.moveaxis(x, 0, -1).copy())
    got = blur_u8(img, sigma, precision="hybrid").movedim(-1, -3).numpy()
    np.testing.assert_array_equal(got, _jax_body(x, shape, sigma, "hybrid", True))
    assert torch.equal(blur_u8(img, sigma, engine="fused", precision="hybrid"),
                       blur_u8(img, sigma, precision="hybrid"))


@pytest.mark.parametrize("call", [
    # past K1's radius 600 (sigma 200: r 665)
    lambda: blur_u8(torch.zeros((1400, 1400, 3), dtype=torch.uint8), 200.0,
                    precision="hybrid"),
    # a radius-0 row axis: int8 does not apply
    lambda: blur_u8(torch.zeros((64, 64, 3), dtype=torch.uint8), (3.0, 0.1),
                    precision="hybrid"),
    # signed taps
    lambda: api._fused_u8_interleaved(torch.zeros((64, 64, 3), dtype=torch.uint8),
                                      make_custom_plan((64, 64), [-0.25, 1.5, -0.25]),
                                      "hybrid"),
])
def test_hybrid_pin_raises_where_k1_cannot_serve(call):
    with pytest.raises(ValueError, match="hybrid"):
        call()


def test_bf16_is_no_pin():
    """As in the JAX package, the bf16 rung runs only where AUTO routes it."""
    with pytest.raises(ValueError, match="precision"):
        blur_u8(torch.zeros((40, 96, 3), dtype=torch.uint8), 3.0, precision="bf16")


# ---------------------------------------------------------------------------
# certify.py against the JAX protocol


def test_certify_patterns_and_box_oracle_equal_the_jax_benchmark():
    mine, theirs = certify.patterns(40, 56, 5), j_cert.patterns(40, 56, 5)
    assert list(mine) == list(theirs)
    for name in theirs:
        np.testing.assert_array_equal(mine[name], theirs[name])
    img = theirs["uniform"]
    for radius in (1, 3, 17):
        np.testing.assert_array_equal(certify.box_oracle_u8(img, radius, 2),
                                      j_cert.box_oracle_u8(img, radius, 2))


def test_certify_entry_holds_only_devicespec_fields():
    """The entry to paste names DeviceSpec fields only: bf16's box sweep is
    a record, its one floor comes from the gaussian sweep."""
    rows = [{"radius": 2, "max": 2}, {"radius": 4, "max": 1}]
    split = [{"radius": 1, "max": {"int8": 1, "hybrid": 1}}]
    record = {"dma": {(p, k): rows for p in ("hybrid", "bf16") for k in ("gaussian", "box_fast")},
              "split": {"gaussian": split, "box_fast": split}}
    fields = certify.entry(record)
    assert fields == {"hybrid_cert_min_radius": 4, "hybrid_cert_min_radius_box": 4,
                      "bf16_cert_min_radius": 4, "hybrid_split_cert_max_radius": 1,
                      "hybrid_split_cert_max_radius_box": 1}
    _spec(**fields)


@pytest.mark.parametrize("kernel", ["gaussian", "box_fast"])
def test_certify_split_sweep_covers_every_radius_the_gate_admits(kernel):
    """The split's hybrid pass 2 runs at any column radius from the hybrid
    floor of the plan's tap family up to the ceiling (an anisotropic plan
    takes the split on its row radius), so the sweep whose first failure
    sets the ceiling starts at or under every measured floor."""
    from blur_algorithms_tpu_torch.utils import hw

    box = kernel == "box_fast"
    if box:
        smallest = certify._plan(certify.SPLIT_BOX_HW, kernel, min(certify.SPLIT_BOX_RADII))
    else:
        sigma = min(certify.SPLIT_GAUSS_R) / certify.R_PER_SIGMA
        smallest = certify._plan(certify.SPLIT_GAUSS_HW, kernel, (sigma, 10.0))
    for name in hw._MEASURED_PRECISION:
        spec = hw.spec_for(name, 1, 1, 80 << 30)
        if spec.hybrid_split_cert_max_radius_for(kernel) is not None:
            assert smallest.col.support_radius <= spec.hybrid_min_radius_for(kernel), name


def _jax_boundary(measured):
    # default_prec_cert.main's rule, as written there
    ok_from = None
    for row in sorted(measured, key=lambda r: r["radius"]):
        if all(q["max"] <= 1 for q in measured if q["radius"] >= row["radius"]):
            ok_from = row["radius"]
            break
    return ok_from


@pytest.mark.parametrize("maxes", [
    {3: 2, 5: 2, 9: 1, 12: 1, 40: 1},
    {3: 1, 5: 1, 9: 1},
    {3: 1, 5: 2, 9: 1, 12: 2, 40: 1},
    {3: 2, 5: 2},
])
def test_certify_boundary_and_route_rules_match_the_jax_protocol(maxes):
    rows = [{"radius": r, "max": m} for r, m in maxes.items()]
    assert certify.certified_min_radius(rows) == _jax_boundary(rows)
    # the split ceiling: the last passing radius before the first failure
    split_rows = [{"radius": r, "max": {"hybrid": m}} for r, m in maxes.items()]
    want = None
    for row in sorted(split_rows, key=lambda r: r["radius"]):
        if row["max"]["hybrid"] > 1:
            break
        want = row["radius"]
    assert certify.split_ceiling(split_rows) == want
    # the route floor on a synthetic timing table (None where JAX says 10**9)
    times = {r: {"radius": r + 1, "int8": 1.0, "hybrid": 1.0 + (m - 1.5)}
             for r, m in maxes.items()}
    theirs = j_certify_device.derive_route_floor(times, "hybrid")
    assert certify.route_floor(times, "hybrid") == (None if theirs == 10**9 else theirs)
