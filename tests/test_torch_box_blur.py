"""K4, the box-blur prefix scan, and the box routing, against the JAX package.

The port's plain version of K4 (``box_blur_scan_axis_ref``, which the
wrapper runs on a CPU tensor) sums in float64; the JAX box scan off a TPU
runs its own plain scan (``box_blur_pallas.py:145-161``: a float32
``jnp.cumsum`` difference), which is how its ``tests/test_box_scan.py``
runs it. Limits: float32 outputs within 1e-4 * 255 (the JAX float32 prefix
sums of these short lines drift by ~1e-5 at most); uint8 outputs within 1
count, and at least 99.9% of them equal where both run the scan (the two
round the same mean, so they differ only where a float32 sum lands within
its drift of a .5), 99% through the API, where the two packages may route
a box to different engines (the fused engine's folded taps, or the scan). Gradients within rtol 1e-5 / atol 1e-4 of
``jax.vjp``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import blur_algorithms_tpu as jax_pkg  # noqa: E402
from blur_algorithms_tpu.ops import box_blur as j_box  # noqa: E402
from blur_algorithms_tpu.pallas_kernels import box_blur_pallas as j_scan  # noqa: E402
import blur_algorithms_tpu_torch as port  # noqa: E402
from blur_algorithms_tpu_torch import api  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import box_blur as t_scan  # noqa: E402
from blur_algorithms_tpu_torch.ops import box_blur as t_box  # noqa: E402
from blur_algorithms_tpu_torch.utils import hw  # noqa: E402

F32_TOL = 1e-4 * 255

# (radius, passes, shape): radii 0..40, passes 1-3, a clamped radius
# (passes * r >= n on the short axis) and a ragged frame
CASES = [
    (0, 2, (2, 24, 40)), (1, 1, (2, 24, 40)), (2, 2, (2, 31, 57)),
    (5, 3, (2, 40, 64)), (13, 2, (1, 48, 96)), (40, 1, (1, 96, 130)),
    (40, 2, (1, 57, 300)), (12, 3, (2, 30, 41)), (25, 2, (1, 37, 29)),
]
IDS = [f"r{r}-p{p}-{s[1]}x{s[2]}" for r, p, s in CASES]


def _f32(shape, seed):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.float32)


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def _close_u8(got: np.ndarray, want: np.ndarray, exact: float = 0.999):
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1
    assert (d == 0).mean() >= exact


@pytest.mark.parametrize("axis", [-1, -2])
@pytest.mark.parametrize("r, passes, shape", CASES, ids=IDS)
def test_k4_plain_axis_against_jax_scan(r, passes, shape, axis):
    x = _f32(shape, seed=1)
    got = t_scan.box_blur_scan_axis(torch.from_numpy(x), r, passes, axis)
    xj = jnp.asarray(np.swapaxes(x, -1, -2) if axis == -2 else x)
    want = np.asarray(j_scan.box_blur_pallas_axis(xj, r, passes))
    want = np.swapaxes(want, -1, -2) if axis == -2 else want
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_TOL)
    u = _u8(shape, seed=2)
    got_u8 = t_scan.box_blur_scan_axis(torch.from_numpy(u), r, passes, axis, out_u8=True)
    uj = jnp.asarray(np.swapaxes(u, -1, -2) if axis == -2 else u)
    want_u8 = np.asarray(j_scan.box_blur_pallas_axis(uj, r, passes, out_u8=True))
    want_u8 = np.swapaxes(want_u8, -1, -2) if axis == -2 else want_u8
    assert got_u8.dtype == torch.uint8
    _close_u8(got_u8.numpy(), want_u8)


@pytest.mark.parametrize("r, passes, shape", CASES, ids=IDS)
def test_k4_plain_2d_against_jax(r, passes, shape):
    x = _f32(shape, seed=3)
    got = t_scan.box_blur_scan(torch.from_numpy(x), r, passes).numpy()
    np.testing.assert_allclose(
        got, np.asarray(j_scan.box_blur_pallas(jnp.asarray(x), r, passes)),
        rtol=0, atol=F32_TOL)
    u = _u8(shape, seed=4)
    _close_u8(t_scan.box_blur_scan_u8(torch.from_numpy(u), r, passes).numpy(),
              np.asarray(j_scan.box_blur_pallas_u8(jnp.asarray(u), r, passes)))
    if passes * r <= min(shape[-2:]) - 1:  # no clamp: the same per-pass boxes
        np.testing.assert_allclose(
            got, np.asarray(j_box.box_blur_planar(jnp.asarray(x), r, passes)),
            rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("r, passes, shape", CASES, ids=IDS)
def test_ops_box_blur_against_jax(r, passes, shape):
    x = _f32(shape, seed=5)
    got = t_box.box_blur_planar(torch.from_numpy(x), r, passes)
    want = j_box.box_blur_planar(jnp.asarray(x), r, passes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=F32_TOL)


def test_k4_grad_against_jax_vjp():
    x = _f32((2, 40, 72), seed=6)
    g = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)
    for r, passes in ((3, 2), (30, 2), (9, 3)):  # (30, 2) clamps on the rows
        _, vjp = jax.vjp(lambda t: j_scan.box_blur_pallas(t, r, passes), jnp.asarray(x))
        (want,) = vjp(jnp.asarray(g))
        t = torch.from_numpy(x).requires_grad_()
        (t_scan.box_blur_scan(t, r, passes) * torch.from_numpy(g)).sum().backward()
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


def test_k4_wrapper_on_cpu_runs_plain_version_and_counts_no_launch():
    x = torch.from_numpy(_u8((3, 30, 50), seed=8))
    before = t_scan.box_blur_scan_axis.launches
    for axis in (-1, -2):
        got = t_scan.box_blur_scan_axis(x, 4, 2, axis, out_u8=True)
        assert torch.equal(got, t_scan.box_blur_scan_axis_ref(x, 4, 2, axis, out_u8=True))
    assert t_scan.box_blur_scan_axis.launches == before
    with pytest.raises(TypeError):
        t_scan.box_blur_scan_axis(x.to(torch.int16), 4)
    with pytest.raises(ValueError):
        t_scan.box_blur_scan_axis(x.float().to("meta"), 4)


def test_k4_rows_tiles():
    """The rows kernel's tiles: one tile while a line fits the preferred
    span, balanced tiles past it, the lines kernel past its longest span
    (16128 values, runs of 63 a thread)."""
    smem = 232448
    assert t_scan._rows_tile(3840, 1600, smem) == 3840
    t = t_scan._rows_tile(15360, 1662, smem)
    assert 1024 <= t and t + 2 * 1662 <= 8192 and -(-15360 // t) * t - 15360 < t
    assert t_scan._rows_tile(24000, 4000, smem) >= 1024
    assert t_scan._rows_tile(24000, 9800, smem) == 0
    assert t_scan.clamped_radius(40, 25, 2) == 19 and t_scan.clamped_radius(1, 5, 2) == 0


# ---------------------------------------------------------------------------
# routing (the JAX _compiled_box rule) and the API against the JAX package

H100 = hw.spec_for("NVIDIA H100 80GB HBM3", 132, 232448, 80 << 30)


@pytest.mark.parametrize("nsmooth, spec, want", [
    (13.0, H100, "box_scan"),  # support 338: past the box crossover (or FFT) -> scan
    (18.0, H100, "box_scan"),  # support 648: past the single kernels
    (4.0, H100, "fused"),  # support 32: K1, up to the measured box crossover
    (5.0, H100, "box_scan"),  # support 50: past it
    (13.0, hw.device_spec("cpu"), "fused"),  # unmeasured: fused to 600
    (18.0, hw.device_spec("cpu"), "box_scan"),  # unmeasured: scan past 600
])
def test_box_routing_follows_the_jax_rule(nsmooth, spec, want):
    plan = api._box_plan(2160, 3840, int(nsmooth * nsmooth), 2, "auto")
    assert api._box_engine(plan, 1, spec, 12).value == want


def test_box_scan_crossover_moves_the_route():
    plan = api._box_plan(2160, 3840, 100, 2, "auto")  # support 200
    low = hw.DeviceSpec(name="x", sm_count=1, smem_optin_bytes=1,
                        box_scan_crossover_radius=150)
    assert api._box_engine(plan, 1, low, 12) is api.Engine.BOX_SCAN
    high = hw.DeviceSpec(name="x", sm_count=1, smem_optin_bytes=1,
                         box_scan_crossover_radius=300)
    assert api._box_engine(plan, 1, high, 12) is api.Engine.FUSED


@pytest.mark.parametrize("nsmooth, passes, shape", [
    (2.0, 2, (1, 48, 80)), (5.0, 2, (1, 60, 96)), (25.0, 2, (1, 24, 1400)),
    (3.0, 3, (1, 40, 64)),
])
def test_box_blur_against_jax(nsmooth, passes, shape):
    img = _u8(shape + (3,), seed=9)
    got = port.box_blur(torch.from_numpy(img), nsmooth, passes).numpy()
    # the two packages may route a call to different engines (the fused
    # engine's folded taps against the scan), so only 99% need be equal
    _close_u8(got, np.asarray(jax_pkg.box_blur(jnp.asarray(img), nsmooth, passes)), 0.99)
    x = _f32(shape, seed=10)
    got = port.box_blur(torch.from_numpy(x), nsmooth, passes).numpy()
    want = np.asarray(jax_pkg.box_blur(jnp.asarray(x), nsmooth, passes))
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("engine", ["box", "box_scan"])
def test_box_engines_against_jax(engine):
    img = _u8((1, 40, 300, 3), seed=11)
    got = port.blur_u8(torch.from_numpy(img), 5.0, engine=engine).numpy()
    _close_u8(got, np.asarray(jax_pkg.blur_u8(jnp.asarray(img), 5.0, engine=engine)), 0.99)
    x = _f32((2, 40, 300), seed=12)
    got = port.blur(torch.from_numpy(x), 5.0, engine=engine).numpy()
    want = np.asarray(jax_pkg.blur(jnp.asarray(x), 5.0, engine=engine))
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)


def test_box_engines_refuse_wrong_uses():
    x = torch.zeros((1, 24, 40, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="single scalar"):
        port.blur_u8(x, (2.0, 3.0), engine="box")
    plan = port.make_plan((24, 40), 2.0)
    with pytest.raises(ValueError, match="box_fast plan"):
        api._blur_planar(torch.zeros((24, 40)), plan, api.Engine.BOX_SCAN)
