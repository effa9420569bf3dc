"""The port's ``"conv"`` engine (``ops/direct_conv``, ``F.conv1d``) against
the JAX package's (``lax.conv_general_dilated`` at ``Precision.HIGHEST``)
on the CPU: float within 1e-4 at the 0..255 scale, uint8 within 1 count,
gradients against ``jax.vjp``; and ``FLAG_TO_ENGINE``, the reference
CLI's flag legend.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import blur_algorithms_tpu as jax_pkg  # noqa: E402
import blur_algorithms_tpu_torch as port  # noqa: E402
from blur_algorithms_tpu import api as j_api  # noqa: E402
from blur_algorithms_tpu import oracle  # noqa: E402
from blur_algorithms_tpu.ops import direct_conv as j_conv  # noqa: E402
from blur_algorithms_tpu.ops import plan as j_plan  # noqa: E402
from blur_algorithms_tpu_torch import api  # noqa: E402
from blur_algorithms_tpu_torch.ops import direct_conv  # noqa: E402
from blur_algorithms_tpu_torch.ops import plan as t_plan  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread: beside XLA's CPU threads (and the suite's other
    workers) the plain versions' tap-by-tap ops otherwise spin against them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ASYM = [0.1, 0.6, 0.2, 0.3, -0.2]
SPECS = [
    ((60, 80), 1.0),
    ((60, 80), 3.0),
    ((37, 90), (2.0, 5.0)),
    ((45, 50), 40.0),  # dim-clamped
    ((40, 56), ASYM, [0.25, 0.5, 0.25]),  # asymmetric custom taps
    ((40, 56), [1.0], [0.2, 0.6, 0.2]),  # radius-0 row axis
]


def _plans(spec):
    if len(spec) == 2:
        shape, sigma = spec
        return t_plan.make_plan(shape, sigma), j_plan.make_plan(shape, sigma)
    shape, tr, tc = spec
    return t_plan.make_custom_plan(shape, tr, tc), j_plan.make_custom_plan(shape, tr, tc)


def _planes(shape, seed):
    return (np.random.default_rng(seed).random((2, 3, *shape)) * 255).astype(np.float32)


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_blur_conv_against_jax(spec):
    plan, jplan = _plans(spec)
    x = _planes(plan.shape, seed=1)
    got = direct_conv.blur_conv(torch.from_numpy(x), plan)
    want = np.asarray(j_conv.blur_conv(jnp.asarray(x), jplan))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_blur_conv_against_the_direct_oracle():
    plan, _ = _plans(((50, 64), 4.0))
    x = _planes(plan.shape, seed=2)[0]
    got = direct_conv.blur_conv(torch.from_numpy(x), plan).numpy()
    np.testing.assert_allclose(got, oracle.blur_direct(x, plan), rtol=0, atol=1e-4)


def test_blur_conv_grad_against_jax_vjp():
    plan, jplan = _plans(SPECS[4])
    x = _planes(plan.shape, seed=3)[0]
    g = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda t: j_conv.blur_conv(t, jplan), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(x).requires_grad_()
    (direct_conv.blur_conv(t, plan) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


def test_conv_engine_through_the_api_against_jax():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (2, 48, 70, 3), dtype=np.uint8)
    got = port.blur_u8(torch.from_numpy(img), 3.0, engine="conv").numpy()
    want = np.asarray(jax_pkg.blur_u8(jnp.asarray(img), 3.0, engine="conv"))
    assert got.dtype == np.uint8 and np.abs(got.astype(int) - want.astype(int)).max() <= 1
    x = img[..., 0].astype(np.float32)
    got = port.blur(torch.from_numpy(x), (2.0, 4.0), engine="conv").numpy()
    want = np.asarray(jax_pkg.blur(jnp.asarray(x), (2.0, 4.0), engine="conv"))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    got = port.convolve_separable(torch.from_numpy(img), ASYM, engine="conv").numpy()
    want = np.asarray(jax_pkg.convolve_separable(jnp.asarray(img), ASYM, engine="conv"))
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_flag_legend_is_the_jax_packages():
    assert {k: v.value for k, v in api.FLAG_TO_ENGINE.items()} == {
        k: v.value for k, v in j_api.FLAG_TO_ENGINE.items()}
    assert "FLAG_TO_ENGINE" in api.__all__
    assert [e.value for e in api.Engine] == [e.value for e in j_api.Engine]


def test_full_f32_scope_restores_the_process_flags():
    cudnn = torch.backends.cudnn
    before = (cudnn.enabled, cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32)
    with direct_conv._full_f32():
        assert cudnn.allow_tf32 is False
        assert (cudnn.enabled, cudnn.benchmark, cudnn.deterministic) == before[:3]
    assert (cudnn.enabled, cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32) == before
