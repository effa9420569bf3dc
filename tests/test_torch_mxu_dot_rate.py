"""B1, the dot-rate probe: the port's plain chain against the JAX probe's kernel.

``benchmarks/mxu_dot_rate.py:make_fn`` runs here through the Pallas
interpreter: the module's ``pl`` is replaced (monkeypatch, the module is not
edited) by a shim whose ``pallas_call`` is ``pl.pallas_call`` with
``interpret=True`` and whose ``BlockSpec`` is the real one. The int8 chain
must be equal, on both branches of the next lhs (``acc[:, :k]`` where n >= k,
the concatenation where n < k); the bf16 chain is held within
``mxu_dot_rate.bf16_bound`` (derived there), the bound the card's check uses. The kernel itself runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 17).
"""

import ast
import functools
import importlib.util
import pathlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from blur_algorithms_tpu_torch.benchmarks import mxu_dot_rate as b1  # noqa: E402

_JAX_PROBE = pathlib.Path(__file__).resolve().parent.parent / "benchmarks" / "mxu_dot_rate.py"


@pytest.fixture
def j_make_fn(monkeypatch):
    """The JAX probe's ``make_fn`` with its pallas_call interpreted."""
    spec = importlib.util.spec_from_file_location("_j_mxu_dot_rate", _JAX_PROBE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    shim = types.SimpleNamespace(BlockSpec=pl.BlockSpec,
                                 pallas_call=functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(mod, "pl", shim)
    return mod.make_fn


def _numpy_chain(a, b, inner):
    k, n = a.shape[1], b.shape[1]
    x = a.astype(np.int64)
    for _ in range(inner):
        acc = x @ b.astype(np.int64)
        nxt = acc[:, :k] if n >= k else np.concatenate([acc, x[:, n:]], axis=1)
        x = nxt.astype(np.int8).astype(np.int64)  # wraps, as XLA's int32 -> int8
    return x


def _int8(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-4, 4, (m, k), dtype=np.int8),
            rng.integers(-4, 4, (k, n), dtype=np.int8))


def test_jax_kernel_in_interpret_mode_is_a_numpy_chain(j_make_fn):
    a, b = _int8(32, 64, 64, seed=0)
    out = np.asarray(j_make_fn(32, 64, 64, 3, jnp.int8, 2)(jnp.asarray(a), jnp.asarray(b)))
    assert out.dtype == np.int32
    assert np.array_equal(out, _numpy_chain(a, b, 3))


# (m, k, n): n == k, n > k (acc[:, :k]), n < k (the concatenation)
SHAPES = [(32, 64, 64), (16, 32, 96), (32, 64, 32), (24, 96, 40), (40, 48, 8)]


@pytest.mark.parametrize("m, k, n", SHAPES)
def test_int8_plain_chain_equals_the_jax_kernel(j_make_fn, m, k, n):
    a, b = _int8(m, k, n, seed=m + k + n)
    want = np.array(j_make_fn(m, k, n, 3, jnp.int8, 2)(jnp.asarray(a), jnp.asarray(b)))
    got = b1.chain_ref(torch.from_numpy(a), torch.from_numpy(b), 3)
    assert got.dtype == torch.int32
    assert torch.equal(got, torch.from_numpy(want))


@pytest.mark.parametrize("m, k, n", SHAPES)
def test_bf16_plain_chain_within_the_bound_of_the_jax_kernel(j_make_fn, m, k, n):
    a, b = b1.operands(m, k, n, "bf16", seed=m + k)
    want = j_make_fn(m, k, n, 1, jnp.bfloat16, 1)(
        jnp.asarray(a.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(b.float().numpy()).astype(jnp.bfloat16))
    want = torch.from_numpy(np.array(want, dtype=np.float32))
    got = b1.chain_ref(a, b, 1)
    assert got.dtype == torch.float32
    diff = (got.double() - want.double()).abs()
    assert (diff <= b1.bf16_bound(a, b, want)).all()


def test_chain_on_the_cpu_runs_the_plain_version_and_counts_no_launch():
    a, b = (torch.from_numpy(t) for t in _int8(32, 64, 32, seed=3))
    before = dict(b1.chain.launches)
    assert torch.equal(b1.chain(a, b, 3, 2, path="mma_sync"), b1.chain_ref(a, b, 3))
    assert b1.chain.launches == before
    with pytest.raises(ValueError, match="one CUDA device"):
        b1.prepare(a, b, 3)
    with pytest.raises(TypeError, match="int8 or bf16"):
        b1.chain(a.int(), b.int(), 1)
    with pytest.raises(ValueError, match=r"\(m, k\) @ \(k, n\)"):
        b1.chain(a, b.t(), 1)


def _jax_main_shapes():
    """The (m, k, n, label) list of the JAX probe's main, read from its
    source."""
    tree = ast.parse(_JAX_PROBE.read_text())
    main = next(f for f in tree.body if isinstance(f, ast.FunctionDef) and f.name == "main")
    node = next(s for s in ast.walk(main) if isinstance(s, ast.Assign)
                and getattr(s.targets[0], "id", None) == "shapes")
    return [tuple(t) for t in ast.literal_eval(node.value)]


def test_shapes_operands_and_sizing_are_the_jax_probes():
    assert list(b1.SHAPES) == _jax_main_shapes()
    rng = np.random.default_rng(0)
    a, b = b1.operands(120, 1144, 384, "int8")
    assert np.array_equal(a.numpy(), rng.integers(-4, 4, (120, 1144), dtype=np.int8))
    assert np.array_equal(b.numpy(), rng.integers(-4, 4, (1144, 384), dtype=np.int8))
    rng = np.random.default_rng(0)
    a, _ = b1.operands(8, 16, 8, "bf16")
    want = jnp.asarray(rng.normal(0, 1, (8, 16)).astype(np.float32)).astype(jnp.bfloat16)
    assert torch.equal(a.float(), torch.from_numpy(np.array(want, dtype=np.float32)))
    # mxu_dot_rate.py run: inner = max(16, int(5e11 / (m k n steps)))
    for m, k, n, _ in b1.SHAPES:
        assert b1.inner_for(m, k, n, 16) == max(16, int(5e11 / (m * k * n * 16)))


@pytest.mark.parametrize("dtype, k, n", [
    ("int8", 1144, 384),   # nine stages of K, three tiles, K padded
    ("int8", 200, 100),    # two stages, one tile narrower than 128
    ("bf16", 1264, 384),   # 64 elements of K a stage
    ("bf16", 60, 130),     # one stage, two tiles
])
def test_resident_rhs_is_the_first_two_stages_of_the_first_tile(dtype, k, n):
    """A resident launch loads stages 0 and 1 of tile 0 (128 columns, 128
    bytes of K each) once and reads stage kc & 1 for K stage kc of every
    tile: the rhs it multiplies by, restated from those stages."""
    _, b = b1.operands(8, k, n, dtype, seed=4)
    per = 128 // b.element_size()
    got = b1.resident_rhs(b)
    assert got.shape == b.shape and got.dtype == b.dtype
    stages = torch.zeros((2 * per, 128), dtype=b.dtype)
    stages[:min(k, 2 * per), :min(n, 128)] = b[:2 * per, :128]
    for kc in range(-(-k // per)):
        for t in range(-(-n // 128)):
            rows, cols = slice(kc * per, (kc + 1) * per), slice(t * 128, (t + 1) * 128)
            block = got[rows, cols]
            want = stages[(kc & 1) * per:(kc & 1) * per + block.shape[0], :block.shape[1]]
            assert torch.equal(block, want), (kc, t)


def test_resident_chain_on_the_cpu_is_the_plain_chain_on_resident_rhs():
    a, b = (torch.from_numpy(t) for t in _int8(70, 300, 200, seed=6))
    before = dict(b1.chain.launches)
    got = b1.chain(a, b, 3, path="wgmma", resident=True)
    assert torch.equal(got, b1.chain_ref(a, b1.resident_rhs(b), 3))
    assert not torch.equal(got, b1.chain_ref(a, b, 3))
    assert b1.chain.launches == before and set(before) == set(b1.PATHS)
