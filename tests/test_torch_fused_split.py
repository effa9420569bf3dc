"""The two-pass wide-radius split against the JAX package.

The JAX split runs ``fused_blur._kernel_int8`` in its split forms (and the
bf16x3 ``_kernel`` with one axis skipped); off a TPU the package's own
tests run those Pallas kernels in interpret mode, which ``_FORCE_INTERPRET``
(read at call time) switches on here. The port's plain versions, which the
wrappers run on a CPU tensor, must be:

- bit-equal for the int8 forms: the rows pass emitting int16 ``E``
  (``e32="out"``) or float32 ``fma(R, 1 / Sr, 128)``, the cols pass consuming
  ``E`` (``e32="in"``), and the whole uint8 split when both passes are int8;
- within 1 count where pass 2 is the f32 form (the JAX pass 2 is bf16x3);
- within 2e-3 at 0..255 scale times the taps' gain for the float split
  (bf16x3 in the JAX package, plain f32 ``fmaf`` order here);
- gradients within rtol 1e-5 / atol 1e-4 of ``jax.vjp``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from blur_algorithms_tpu.ops import plan as j_plan  # noqa: E402
from blur_algorithms_tpu.pallas_kernels import fused_blur as j_fused  # noqa: E402
from blur_algorithms_tpu_torch import oracle  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fused_blur as t_fused  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fused_split as t_split  # noqa: E402
from blur_algorithms_tpu_torch.ops import plan as t_plan  # noqa: E402
from blur_algorithms_tpu_torch.utils.hw import DeviceSpec  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test. The plain versions sum tap by tap in small
    torch ops; beside the suite's other workers their intra-op threads wait
    on one another (the r 4096 rows case: 0.1 s alone, 65 s beside seven
    busy processes, on 8 cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SHARPEN5 = [-0.125, -0.25, 1.75, -0.25, -0.125]
GAUSS7 = [0.03, 0.1, 0.22, 0.3, 0.22, 0.1, 0.03]

# (id, plan spec): (shape, sigma) or (shape, taps_row, taps_col)
CASES = [
    ("sigma3", ((40, 200), 3.0)),
    ("sigma6-aniso", ((48, 136), (2.0, 6.0))),
    ("ragged", ((41, 199), 5.0)),
    ("thin-r665", ((24, 1500), 200.0)),
]


def _plans(spec):
    if len(spec) == 2:
        shape, sigma = spec
        return t_plan.make_plan(shape, sigma), j_plan.make_plan(shape, sigma)
    shape, tr, tc = spec
    return (t_plan.make_custom_plan(shape, tr, tc),
            j_plan.make_custom_plan(shape, tr, tc))


def _u8(shape, seed, dark=False):
    rng = np.random.default_rng(seed)
    hi = 60 if dark else 256  # dark frames: negative accumulators throughout
    return rng.integers(0, hi, size=(2, *shape), dtype=np.uint8)


def _jax_pass(x, plan, precision, out_u8, e32=None):
    in_bytes = 2 if e32 == "in" else 1
    tile = j_fused._pick_tile(plan, in_bytes, precision)
    return np.asarray(j_fused._blur_fused_planar(
        jnp.asarray(x), plan, tile, precision, out_u8=out_u8, e32=e32))


@pytest.mark.parametrize("dark", [False, True])
@pytest.mark.parametrize("name, spec", CASES, ids=[c[0] for c in CASES])
def test_int8_split_forms_bit_equal_to_jax(monkeypatch, name, spec, dark):
    monkeypatch.setattr(j_fused, "_FORCE_INTERPRET", True)
    tp, jp = _plans(spec)
    t_rows, t_cols = t_fused._split_plans(tp)
    j_rows, j_cols = j_fused._split_plans(jp)
    x = _u8(tp.shape, seed=1, dark=dark)

    e = t_split.fused_split_rows_int8(torch.from_numpy(x), t_rows, out_e32=True)
    want_e = _jax_pass(x, j_rows, "int8", False, e32="out")
    assert e.dtype == torch.int16 and want_e.dtype == np.int16
    np.testing.assert_array_equal(e.numpy(), want_e)
    if dark:
        assert int(e.min()) < 0  # the arithmetic shift met negative sums

    y = t_split.fused_split_rows_int8(torch.from_numpy(x), t_rows, out_e32=False)
    np.testing.assert_array_equal(y.numpy(), _jax_pass(x, j_rows, "int8", False))

    got = t_split.fused_split_cols_int8(e, t_cols, out_u8=True)
    np.testing.assert_array_equal(
        got.numpy(), _jax_pass(want_e, j_cols, "int8", True, e32="in"))
    # the float32 store: the port rounds the epilogue as XLA compiles the
    # JAX expression (two multiply-adds contracted), so it is bit-equal too
    got = t_split.fused_split_cols_int8(e, t_cols, out_u8=False)
    np.testing.assert_array_equal(
        got.numpy(), _jax_pass(want_e, j_cols, "int8", False, e32="in"))

    whole = t_fused._blur_fused_split(torch.from_numpy(x), tp, "int8", out_u8=True)
    want = np.asarray(j_fused._blur_fused_split(jnp.asarray(x), jp, "int8", out_u8=True))
    np.testing.assert_array_equal(whole.numpy(), want)


def test_signed_column_taps_take_the_f32_pass_1(monkeypatch):
    """Signed column taps: e32 does not apply, pass 1 is the int8 rows form
    with an f32 result (bit-equal), pass 2 the f32 form (JAX: bf16x3)."""
    monkeypatch.setattr(j_fused, "_FORCE_INTERPRET", True)
    tp, jp = _plans(((40, 136), GAUSS7, SHARPEN5))
    assert not t_fused.e32_split_applicable(tp, "int8", 1)
    t_rows, _ = t_fused._split_plans(tp)
    j_rows, _ = j_fused._split_plans(jp)
    x = _u8(tp.shape, seed=2)
    y = t_split.fused_split_rows_int8(torch.from_numpy(x), t_rows, out_e32=False)
    np.testing.assert_array_equal(y.numpy(), _jax_pass(x, j_rows, "int8", False))
    got = t_fused._blur_fused_split(torch.from_numpy(x), tp, "int8", out_u8=True).numpy()
    want = np.asarray(j_fused._blur_fused_split(jnp.asarray(x), jp, "int8", out_u8=True))
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("spec", [((40, 200), 3.0), ((24, 1500), 200.0),
                                  ((40, 136), [0.05, 0.1, 0.5, 0.2, 0.3, -0.1, 0.02], SHARPEN5)],
                         ids=["sigma3", "thin-r665", "signed"])
def test_float_split_against_jax(monkeypatch, spec):
    monkeypatch.setattr(j_fused, "_FORCE_INTERPRET", True)
    tp, jp = _plans(spec)
    rng = np.random.default_rng(3)
    x = (rng.random((2, *tp.shape)) * 255).astype(np.float32)
    got = t_fused._blur_fused_split(torch.from_numpy(x), tp, "bf16x3", out_u8=False)
    want = np.asarray(j_fused._blur_fused_split(jnp.asarray(x), jp, "bf16x3", False))
    gain = max(1.0, float(np.abs(tp.row.taps).sum() * np.abs(tp.col.taps).sum()))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3 * gain)
    # and the plain f32 split against the float64 direct correlation
    np.testing.assert_allclose(got.numpy(), oracle.blur_direct(x, tp), rtol=0,
                               atol=1e-3 * gain)


@pytest.mark.parametrize("spec", [((40, 200), 3.0), ((24, 1500), 200.0),
                                  ((40, 136), GAUSS7, SHARPEN5), ((40, 136), [1.0], GAUSS7),
                                  ((900, 700), 250.0)])
@pytest.mark.parametrize("precision", ["int8", "bf16x3", None])
@pytest.mark.parametrize("in_bytes", [1, 4])
def test_split_estimates_equal_jax(spec, precision, in_bytes):
    tp, jp = _plans(spec)
    assert (t_fused.e32_split_applicable(tp, precision, in_bytes)
            == j_fused.e32_split_applicable(jp, precision, in_bytes))
    assert (t_fused.split_hbm_bytes(tp, in_bytes, precision)
            == j_fused.split_hbm_bytes(jp, in_bytes, precision))


def test_split_plans_are_the_jax_split_plans():
    tp, jp = _plans(((48, 300), (4.0, 9.0)))
    for t, j in zip(t_fused._split_plans(tp), j_fused._split_plans(jp)):
        for ax in ("row", "col"):
            ta, ja = getattr(t, ax), getattr(j, ax)
            np.testing.assert_array_equal(ta.taps, ja.taps)
            assert (ta.width, ta.pad, ta.dim) == (ja.width, ja.pad, ja.dim)


def test_float_split_grad_against_jax_vjp(monkeypatch):
    monkeypatch.setattr(j_fused, "_FORCE_INTERPRET", True)
    tp, jp = _plans(((24, 1400), 200.0))
    rng = np.random.default_rng(4)
    x = (rng.random((2, 24, 1400)) * 255).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda t: j_fused._blur_fused_split_diff(t, jp, "bf16x3"),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(x).requires_grad_()
    out = t_fused.blur_fused(t, tp)  # r 665 > 600: the split
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


def test_split_routing(monkeypatch):
    wide = t_plan.make_plan((24, 1500), 200.0)
    mid = t_plan.make_plan((800, 800), 100.0)  # r 332
    assert t_fused._split_wins(wide, 1, "int8", "cpu")
    assert not t_fused._split_wins(mid, 1, "int8", "cpu")  # unmeasured: K1
    spec = DeviceSpec(name="cpu", sm_count=0, smem_optin_bytes=0,
                      fused_split_min_radius=300)
    monkeypatch.setattr(t_fused, "device_spec", lambda device: spec)
    assert t_fused._split_wins(mid, 1, "int8", "cpu")
    assert not t_fused._split_wins(t_plan.make_plan((800, 800), 50.0), 1, "int8", "cpu")


def test_wrappers_on_cpu_run_plain_versions_and_count_no_launch():
    tp = t_plan.make_plan((24, 1500), 200.0)
    rows, cols = t_fused._split_plans(tp)
    x = torch.from_numpy(_u8(tp.shape, seed=5))
    counters = (t_split.fused_split_rows_int8, t_split.fused_split_cols_int8,
                t_fused.blur_fused_axis_f32)
    before = [c.launches for c in counters]
    e = t_split.fused_split_rows_int8(x, rows)
    assert torch.equal(e, t_split.fused_split_rows_int8_ref(x, rows))
    assert torch.equal(t_split.fused_split_cols_int8(e, cols),
                       t_split.fused_split_cols_int8_ref(e, cols))
    y = t_fused.blur_fused_axis_f32(x, rows)
    assert torch.equal(y, t_fused.blur_fused_f32_ref(x, rows))
    assert torch.equal(t_fused.blur_fused_f32(x, rows), y)  # dispatches past 600
    assert [c.launches for c in counters] == before


def test_split_refuses_what_it_does_not_serve():
    tp = t_plan.make_plan((24, 1500), 200.0)
    rows, cols = t_fused._split_plans(tp)
    x = torch.zeros((1, 24, 1500), dtype=torch.uint8)
    with pytest.raises(ValueError, match="only a cols radius"):
        t_split.fused_split_cols_int8(x.to(torch.int16), rows)
    with pytest.raises(ValueError, match="only a rows radius"):
        t_split.fused_split_rows_int8(x, cols)
    with pytest.raises(TypeError):
        t_split.fused_split_rows_int8(x.float(), rows)
    with pytest.raises(ValueError, match="non-negative"):
        signed = t_plan.make_custom_plan((24, 40), SHARPEN5, [1.0])
        t_split.fused_split_rows_int8(torch.zeros((1, 24, 40), dtype=torch.uint8), signed)
    huge = t_plan.make_plan((8, 30000), 1300.0)  # row support radius 4329
    # past the split's reach: a ValueError naming the engines that serve it,
    # as the JAX ``_pick_tile``
    with pytest.raises(ValueError, match="fft_stream"):
        t_fused._blur_fused_split(torch.zeros((1, 8, 30000)), huge, "bf16x3", False)
    with pytest.raises(ValueError, match="fft_stream"):
        t_fused.blur_fused(torch.zeros((1, 8, 30000)), huge)
