"""The port's ``"deriche"`` engine (``ops/deriche``) against the JAX
package's on the CPU.

The NumPy constants and band plans are copies: equal. Float results within
2e-3 x the taps' gain (0..255 scale), uint8 within 1 count of JAX and of
the pocketfft oracle, gradients against ``jax.vjp`` (rtol 1e-5, atol 1e-4).
The engine needs sigma >= 16 and a reflect pad of 4.75 sigma <= dim - 1,
so its frames are 257 pixels or more on a side (the JAX tests use 320x288).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import blur_algorithms_tpu as jax_pkg  # noqa: E402
import blur_algorithms_tpu_torch as port  # noqa: E402
from blur_algorithms_tpu import oracle  # noqa: E402
from blur_algorithms_tpu.ops import deriche as j_der  # noqa: E402
from blur_algorithms_tpu_torch import api  # noqa: E402
from blur_algorithms_tpu_torch.ops import deriche  # noqa: E402
from blur_algorithms_tpu_torch.ops.plan import make_plan  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread: beside XLA's CPU threads (and the suite's other
    workers) the plain versions' tap-by-tap ops otherwise spin against them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SHAPE = (300, 280)


@pytest.fixture(scope="module")
def frame():
    return np.random.default_rng(7).integers(0, 256, (3, *SHAPE), dtype=np.uint8)


def _gain(sigma: float) -> float:
    return float(np.abs(deriche.deriche_taps(sigma)).sum())


@pytest.mark.parametrize("sigma", [16.0, 23.5, 40.0])
def test_constants_and_band_plans_equal_jax(sigma):
    c, jc = deriche._consts(sigma), j_der._consts(sigma)
    assert c.keys() == jc.keys()
    for k in c:
        np.testing.assert_array_equal(c[k], jc[k])
    np.testing.assert_array_equal(deriche.deriche_taps(sigma), j_der.deriche_taps(sigma))
    for p, jp in zip(deriche._band_plans(SHAPE, sigma), j_der._band_plans(SHAPE, sigma)):
        np.testing.assert_array_equal(p.row.taps, jp.row.taps)
        np.testing.assert_array_equal(p.col.taps, jp.col.taps)
        assert p.shape == jp.shape
    assert (deriche._MODES, deriche._L, deriche._RB, deriche._SIGMA_MIN,
            deriche._PAD_SIGMAS) == (j_der._MODES, j_der._L, j_der._RB,
                                     j_der._SIGMA_MIN, j_der._PAD_SIGMAS)


def test_applicability_equals_jax():
    for shape in [(320, 288), (160, 128), (257, 400), (400, 400), (256, 900)]:
        for sigma in (10.0, 15.9, 16.0, 53.0, 54.0, 90.0):
            assert deriche.deriche_applicable(shape, sigma) == j_der.deriche_applicable(
                shape, sigma), (shape, sigma)


@pytest.mark.parametrize("reverse", [False, True])
def test_block_scan_is_the_recurrence(reverse):
    rng = np.random.default_rng(3)
    inj = rng.standard_normal((2, 11, 2)) + 1j * rng.standard_normal((2, 11, 2))
    decay = np.array([0.7 + 0.2j, -0.3 + 0.5j])
    got = deriche._scan_states(torch.from_numpy(inj), torch.from_numpy(decay), reverse).numpy()
    want = np.zeros_like(inj)
    order = range(10, -1, -1) if reverse else range(11)
    s = np.zeros((2, 2), complex)
    for b in order:
        s = decay * s + inj[:, b]
        want[:, b] = s
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_tails_against_jax(frame):
    x = frame[0].astype(np.float32)
    got = deriche._tails_last(torch.from_numpy(x), 20.0).numpy()
    want = np.asarray(j_der._tails_last(jnp.asarray(x), 20.0))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("sigma", [16.0, 40.0])
def test_float_against_jax(frame, sigma):
    x = frame.astype(np.float32)
    got = deriche.blur_deriche(torch.from_numpy(x), sigma)
    want = np.asarray(j_der.blur_deriche(jnp.asarray(x), sigma))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3 * _gain(sigma))


@pytest.mark.parametrize("sigma", [16.0, 40.0])
def test_u8_against_jax_and_the_oracle(frame, sigma):
    got = deriche.blur_deriche_u8(torch.from_numpy(frame), sigma).numpy().astype(int)
    want = np.asarray(j_der.blur_deriche_u8(jnp.asarray(frame), sigma)).astype(int)
    assert np.abs(got - want).max() <= 1
    plan = make_plan(SHAPE, sigma)
    ref = oracle.blur_planar_fft2(frame.astype(np.float32), plan)
    ref = np.clip(np.floor(ref + 0.5), 0, 255).astype(int)
    err = np.abs(got - ref)
    assert err.max() <= 1 and (err > 0).mean() < 0.02


def test_gradient_against_jax_vjp(frame):
    x = frame[:1].astype(np.float32)
    g = np.random.default_rng(8).standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda t: j_der.blur_deriche(t, 16.0), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(x).requires_grad_()
    (deriche.blur_deriche(t, 16.0) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


def test_api_routes_the_engine(frame):
    img = np.ascontiguousarray(np.moveaxis(frame, 0, -1))
    out = port.blur_u8(torch.from_numpy(img), 16.0, engine="deriche")
    direct = deriche.blur_deriche_u8(torch.from_numpy(frame), 16.0)
    assert torch.equal(out, direct.movedim(-3, -1))
    want = np.asarray(jax_pkg.blur_u8(jnp.asarray(img), 16.0, engine="deriche"))
    assert np.abs(out.numpy().astype(int) - want.astype(int)).max() <= 1
    x = torch.from_numpy(frame[:2].astype(np.float32))
    assert torch.equal(port.blur(x, 16.0, engine="deriche"), deriche.blur_deriche(x, 16.0))


@pytest.mark.parametrize("call, match", [
    (lambda x: port.blur_u8(x, 16.0, engine="deriche", kernel="box"), "gaussian"),
    (lambda x: port.blur_u8(x, (16.0, 20.0), engine="deriche"), "gaussian"),
    (lambda x: port.blur_u8(x[:64, :64], 16.0, engine="deriche"), "not applicable"),
    (lambda x: port.blur_u8(x, 10.0, engine="deriche"), "not applicable"),
    (lambda x: port.convolve_separable(x, [0.25, 0.5, 0.25], engine="deriche"), "gaussian"),
])
def test_refusals(call, match):
    with pytest.raises(ValueError, match=match):
        call(torch.zeros((*SHAPE, 3), dtype=torch.uint8))


def test_auto_never_routes_deriche():
    for shape, sigma in [((4000, 3000), 260.0), ((5120, 5120), 1000.0), (SHAPE, 40.0)]:
        plan = make_plan(shape, sigma)
        for in_bytes in (1, 4):
            assert api._resolve_engine(api.Engine.AUTO, plan, in_bytes) is not api.Engine.DERICHE


def test_batch_dims(frame):
    batched = torch.from_numpy(np.stack([frame, frame[::-1]], axis=0))
    out = deriche.blur_deriche_u8(batched, 16.0)
    assert out.shape == batched.shape
    assert torch.equal(out[1], deriche.blur_deriche_u8(batched[1], 16.0))
