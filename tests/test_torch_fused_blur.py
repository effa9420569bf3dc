"""K2, the fused f32 blur, and its backward pass against the JAX package.

The plain PyTorch version of K2 (``blur_fused_f32_ref``, which the wrapper
runs for a CPU tensor) is held against the two JAX kernels whose math K2
ports, both run the way the JAX package's own tests run them on the CPU:

- the blocked kernel ``fused_blur._blur_fused_planar(..., "bf16x3")`` with
  ``_FORCE_INTERPRET`` set (the Pallas ``_kernel`` in interpret mode);
- K1's bf16x3 body, ``fused_dma._blur_fused_dma_impl(..., "bf16x3",
  direct=True)``.

Tolerances: bf16x3 is about 1e-3 from the exact correlation at 0..255
scale, and K2's f32 accumulation is closer, so f32 outputs agree within
2e-3 at that scale, and uint8 outputs within 1 count. The bf16 splits'
error is relative to the sums they round, so for taps whose gain
``sum|taps_row| * sum|taps_col|`` exceeds 1 (signed filters) the f32 limit
grows with it: the JAX kernel is 2.6e-3 from the exact correlation on the
asymmetric signed case (gain 2.1), the plain version 4.6e-5. Against the
float64 direct oracle the plain version is within 1e-3. The band engine and the adjoint are held
against the JAX ``ops/band_matmul`` and ``ops/adjoint``. The CUDA kernel
itself runs only on a card: its tests are in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from blur_algorithms_tpu.ops import adjoint as j_adjoint  # noqa: E402
from blur_algorithms_tpu.ops import band_matmul as j_band  # noqa: E402
from blur_algorithms_tpu.ops import plan as j_plan  # noqa: E402
from blur_algorithms_tpu.pallas_kernels import fused_blur as j_fused  # noqa: E402
from blur_algorithms_tpu.pallas_kernels import fused_dma as j_dma  # noqa: E402
from blur_algorithms_tpu_torch import oracle  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fft4step as t_k3  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fused_blur as t_fused  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fused_dma as t_dma  # noqa: E402
from blur_algorithms_tpu_torch.ops import adjoint as t_adjoint  # noqa: E402
from blur_algorithms_tpu_torch.ops import band_matmul as t_band  # noqa: E402
from blur_algorithms_tpu_torch.ops import plan as t_plan  # noqa: E402

ASYM_ROW = [0.05, 0.1, 0.5, 0.2, 0.3, -0.1, 0.02]
ASYM_COL = [-0.2, 0.4, 0.9, 0.1, -0.05]
GAUSS7 = [0.03, 0.1, 0.22, 0.3, 0.22, 0.1, 0.03]

# (id, plan spec, the JAX kernels' tile): a spec is (shape, sigma) or
# (shape, taps_row, taps_col) for a custom plan
CASES = [
    ("sigma3", ((40, 200), 3.0), (16, 128)),
    ("sigma25", ((64, 200), 25.0), (64, 128)),
    ("sigma2x50", ((48, 300), (2.0, 50.0)), (48, 128)),
    ("asymmetric-signed", ((40, 200), ASYM_ROW, ASYM_COL), (40, 128)),
    ("ragged", ((41, 199), 5.0), (24, 128)),
    ("row-radius-0", ((40, 136), [1.0], GAUSS7), (40, 128)),
    ("col-radius-0", ((32, 136), GAUSS7, [1.0]), (32, 128)),
]


def _plans(spec):
    """The port's plan and the JAX plan of one spec."""
    if len(spec) == 2:
        shape, sigma = spec
        return t_plan.make_plan(shape, sigma), j_plan.make_plan(shape, sigma)
    shape, tr, tc = spec
    return (t_plan.make_custom_plan(shape, tr, tc),
            j_plan.make_custom_plan(shape, tr, tc))


def _input(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.random((2, *shape)) * 255
    return x.astype(np.float32) if dtype == "f32" else x.astype(np.uint8)


def _assert_close(got: np.ndarray, want: np.ndarray, out_u8: bool, plan=None):
    if out_u8:
        assert got.dtype == want.dtype == np.uint8
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    else:
        gain = 1.0 if plan is None else max(
            1.0, float(np.abs(plan.row.taps).sum() * np.abs(plan.col.taps).sum()))
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-3 * gain)


@pytest.mark.parametrize("dtype", ["f32", "u8"])
@pytest.mark.parametrize("name, spec, tile", CASES, ids=[c[0] for c in CASES])
def test_plain_k2_against_jax_blocked_kernel(monkeypatch, name, spec, tile, dtype):
    """JAX K2 ``_kernel`` (bf16x3 branch) in interpret mode. Every call
    builds a new JAX plan, and plans hash by identity, so each case is
    traced afresh with the interpret flag set."""
    monkeypatch.setattr(j_fused, "_FORCE_INTERPRET", True)
    plan, jplan = _plans(spec)
    x = _input(plan.shape, dtype, seed=len(name))
    out_u8 = dtype == "u8"
    want = np.asarray(j_fused._blur_fused_planar(
        jnp.asarray(x), jplan, tile, "bf16x3", out_u8=out_u8))
    got = t_fused.blur_fused_f32_ref(torch.from_numpy(x), plan, out_u8=out_u8)
    assert tuple(got.shape) == x.shape
    _assert_close(got.numpy(), want, out_u8, plan)


@pytest.mark.parametrize("dtype", ["f32", "u8"])
@pytest.mark.parametrize(
    "name, spec, tile", [c for c in CASES if "radius-0" not in c[0]],
    ids=[c[0] for c in CASES if "radius-0" not in c[0]])
def test_plain_k2_against_jax_dma_bf16x3_body(name, spec, tile, dtype):
    """K1's ``_tile_bf16x3`` body in the direct DMA form (interpret mode;
    that form serves no radius-0 axis)."""
    plan, jplan = _plans(spec)
    x = _input(plan.shape, dtype, seed=len(name) + 1)
    out_u8 = dtype == "u8"
    want = np.asarray(j_dma._blur_fused_dma_impl(
        jnp.asarray(x), jplan, "bf16x3", out_u8, tile=tile, direct=True))
    got = t_fused.blur_fused_f32_ref(torch.from_numpy(x), plan, out_u8=out_u8)
    _assert_close(got.numpy(), want, out_u8, plan)


@pytest.mark.parametrize("name, spec, tile", CASES, ids=[c[0] for c in CASES])
def test_plain_k2_against_the_direct_oracle(name, spec, tile):
    plan, _ = _plans(spec)
    x = _input(plan.shape, "f32", seed=len(name) + 2)
    got = t_fused.blur_fused_f32_ref(torch.from_numpy(x), plan).numpy()
    np.testing.assert_allclose(got, oracle.blur_direct(x, plan), rtol=0, atol=1e-3)


def test_plain_k2_uint8_input_to_float_output():
    plan = t_plan.make_plan((24, 40), 2.0)
    x = _input(plan.shape, "u8", seed=3)
    got = t_fused.blur_fused_f32_ref(torch.from_numpy(x), plan)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), oracle.blur_direct(x, plan), atol=1e-3)


def test_plain_k2_rounds_like_one_fused_multiply_add_per_tap():
    """Each tap rounds once: a sum that float32 mul-then-add would round
    twice keeps the exact product here."""
    plan = t_plan.make_custom_plan((1, 3), [1.0], [1.0])
    x = torch.tensor([[[1.0, 2.0, 3.0]]])
    assert torch.equal(t_fused.blur_fused_f32_ref(x, plan), x)  # identity axes
    plan = t_plan.make_custom_plan((1, 3), [0.0, 1.0 + 2.0**-23, 0.0], [1.0])
    v = 1.0 + 2.0**-23
    x = torch.tensor([[[v, v, v]]], dtype=torch.float32)
    got = t_fused.blur_fused_f32_ref(x, plan)
    want = np.float32(np.float64(v) * np.float64(np.float32(v)))  # one rounding
    assert float(got[0, 0, 1]) == float(want)


def test_wrapper_on_cpu_runs_plain_version_and_counts_no_launch():
    plan = t_plan.make_custom_plan((24, 40), ASYM_ROW, ASYM_COL)
    x = torch.from_numpy(_input(plan.shape, "f32", seed=4))
    before = t_fused.blur_fused_f32.launches
    out = t_fused.blur_fused_f32(x, plan)
    out_u8 = t_fused.blur_fused_f32(x.to(torch.uint8), plan, out_u8=True)
    assert t_fused.blur_fused_f32.launches == before
    assert torch.equal(out, t_fused.blur_fused_f32_ref(x, plan))
    assert torch.equal(out_u8, t_fused.blur_fused_f32_ref(x.to(torch.uint8), plan, True))


def test_wrapper_rejects_bad_inputs():
    plan = t_plan.make_plan((24, 40), 2.0)
    with pytest.raises(TypeError):
        t_fused.blur_fused_f32(torch.zeros((3, 24, 40), dtype=torch.float16), plan)
    with pytest.raises(ValueError):
        t_fused.blur_fused_f32(torch.zeros((3, 24, 41)), plan)
    with pytest.raises(ValueError):  # neither CUDA nor CPU: no silent move
        t_fused.blur_fused_f32(torch.zeros((3, 24, 40), device="meta"), plan)
    wide = t_plan.make_plan((1400, 1400), 200.0)  # r = 665 on both axes
    for fn in (t_fused.blur_fused_f32, t_fused.blur_fused_f32_ref):
        with pytest.raises(NotImplementedError, match="two-pass split"):
            fn(torch.zeros((1, 1400, 1400)), wide)
    # blur_fused serves it through the split (a thin frame keeps it cheap)
    thin = t_plan.make_plan((12, 1400), 200.0)
    x = torch.from_numpy(_input(thin.shape, "f32", seed=3))
    np.testing.assert_allclose(t_fused.blur_fused(x, thin).numpy(),
                               oracle.blur_direct(x.numpy(), thin), rtol=0, atol=1e-3)


@pytest.mark.parametrize("spec, kernel", [
    (((24, 40), 2.0), "k1"),  # int8 applies: K1
    (((24, 40), [-0.25, 1.5, -0.25], None), "k2"),  # signed taps
    (((24, 40), [0.5, 1.0, 0.5], None), "k2"),  # not unit-sum
    (((24, 40), [1.0], GAUSS7), "k2"),  # radius-0 row axis
    (((24, 40), GAUSS7, [1.0]), "k2"),  # radius-0 col axis: K1 takes none
])
def test_blur_fused_u8_routes_int8_to_k1_or_falls_back_to_k2(spec, kernel):
    plan = _plans(spec if spec[-1] is not None else spec[:2] + (spec[1],))[0]
    x = torch.from_numpy(_input(plan.shape, "u8", seed=5))
    got = t_fused.blur_fused_u8(x, plan)
    if kernel == "k1":
        want = t_dma.blur_fused_u8_dma_ref(x, plan)
    else:
        want = t_fused.blur_fused_f32_ref(x, plan, out_u8=True)
    assert torch.equal(got, want)
    assert torch.equal(t_fused.blur_fused_u8(x, plan, "bf16x3"),
                       t_fused.blur_fused_f32_ref(x, plan, out_u8=True))
    # the hybrid rung: K1's hybrid body where it applies, else the same
    # fallback as int8; a rung name that does not exist raises
    hybrid = t_dma.blur_fused_u8_hybrid_ref(x, plan) if kernel == "k1" else want
    assert torch.equal(t_fused.blur_fused_u8(x, plan, "hybrid"), hybrid)
    with pytest.raises(ValueError):
        t_fused.blur_fused_u8(x, plan, "fp8")


# ---------------------------------------------------------------------------
# the band engine and the adjoint


@pytest.mark.parametrize("n, r", [(1, 0), (100, 3), (640, 32), (3840, 32), (2000, 598)])
def test_pick_block_equals_jax(n, r):
    assert t_band.pick_block(n, r) == j_band.pick_block(n, r)


@pytest.mark.parametrize("taps, n_out, block", [
    (ASYM_ROW, 200, None), (ASYM_COL, 77, 32), (GAUSS7, 300, 128), ([1.0], 9, None),
])
def test_band_conv_valid_equals_jax(taps, n_out, block):
    r = (len(taps) - 1) // 2
    x = np.random.default_rng(6).standard_normal((3, 5, n_out + 2 * r)).astype(np.float32)
    want = np.asarray(j_band.band_conv_valid(
        jnp.asarray(x), np.asarray(taps, np.float32), n_out, block=block))
    got = t_band.band_conv_valid(torch.from_numpy(x), np.asarray(taps, np.float32),
                                 n_out, block=block)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("spec", [((40, 200), 3.0), ((48, 300), (2.0, 50.0)),
                                  ((40, 200), ASYM_ROW, ASYM_COL)])
def test_blur_band_matmul_equals_jax_and_oracle(spec):
    plan, jplan = _plans(spec)
    x = _input(plan.shape, "f32", seed=7)
    got = t_band.blur_band_matmul(torch.from_numpy(x), plan).numpy()
    want = np.asarray(j_band.blur_band_matmul(jnp.asarray(x), jplan))
    _assert_close(got, want, False, plan)
    np.testing.assert_allclose(got, oracle.blur_direct(x, plan), rtol=0, atol=1e-3)


@pytest.mark.parametrize("spec", [((40, 200), 3.0), ((41, 199), 5.0),
                                  ((40, 200), ASYM_ROW, ASYM_COL),
                                  ((40, 136), [1.0], GAUSS7), ((12, 10), 9.0)])
def test_blur_adjoint_equals_jax(spec):
    plan, jplan = _plans(spec)
    ct = np.random.default_rng(8).standard_normal((2, *plan.shape)).astype(np.float32)
    want = np.asarray(j_adjoint.blur_adjoint(jnp.asarray(ct), jplan))
    got = t_adjoint.blur_adjoint(torch.from_numpy(ct), plan).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("spec", [((40, 200), 3.0), ((40, 200), ASYM_ROW, ASYM_COL),
                                  ((12, 10), 9.0)])
def test_adjoint_identity_in_float64(spec):
    """<A x, g> == <x, A^T g> with both operators in float64."""
    plan, _ = _plans(spec)
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((2, *plan.shape)))
    g = torch.from_numpy(rng.standard_normal((2, *plan.shape)))
    ax = t_fused.blur_fused_f32_ref(x, plan)
    atg = t_adjoint.blur_adjoint(g, plan)
    assert ax.dtype == atg.dtype == torch.float64
    lhs, rhs = float((ax * g).sum()), float((x * atg).sum())
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)


def test_adjoint_past_radius_1024_raises():
    """Past support radius 1024 a symmetric axis runs through K3; a row
    padded past 16384 takes K3's cluster form on a card, its plain version
    here (it raised before the cluster form was ported: the case keeps its
    name and holds the result). The wide branch at width 12400 (12400 + 4r
    -> 32768) against the JAX adjoint, which runs the HIGHEST einsum off a
    TPU."""
    taps = np.full(2051, 1.0 / 2051, np.float32)  # row radius 1025
    plan = t_plan.make_custom_plan((4, 12400), taps, [1.0])
    jplan = j_plan.make_custom_plan((4, 12400), taps, [1.0])
    ct = np.random.default_rng(11).standard_normal((4, 12400)).astype(np.float32)
    before = t_k3.fft_conv_rows.launches
    got = t_adjoint.blur_adjoint(torch.from_numpy(ct), plan).numpy()
    assert t_k3.fft_conv_rows.launches == before  # the plain version on the CPU
    want = np.asarray(j_adjoint.blur_adjoint(jnp.asarray(ct), jplan))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="CUDA or CPU"):  # no silent move
        t_adjoint.blur_adjoint(torch.zeros((4, 12400), device="meta"), plan)


def test_gradcheck_float64_plain_path():
    plan = t_plan.make_custom_plan((7, 9), [0.1, 0.6, 0.2, 0.3, -0.2], [0.3, 0.9, -0.2])
    x = torch.from_numpy(np.random.default_rng(10).random((2, 7, 9))).requires_grad_()
    assert torch.autograd.gradcheck(lambda t: t_fused.blur_fused(t, plan), (x,))


def test_blur_fused_grad_equals_jax_custom_vjp():
    """The autograd Function's backward against ``jax.vjp`` of the JAX
    ``blur_fused`` (whose ``custom_vjp`` backward is the JAX adjoint)."""
    plan, jplan = _plans(((40, 200), ASYM_ROW, ASYM_COL))
    rng = np.random.default_rng(11)
    x = _input(plan.shape, "f32", seed=12)
    g = rng.standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda t: j_fused.blur_fused(t, jplan, precision="bf16x3"),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(x).requires_grad_()
    (t_fused.blur_fused(t, plan) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
