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
    ("int8", 1144, 384),   # eighteen stages of K, three tiles, K padded
    ("int8", 200, 100),    # four stages, one tile narrower than 128
    ("bf16", 1264, 384),   # 32 elements of K a stage
    ("bf16", 60, 130),     # two stages, two tiles
])
def test_resident_rhs_is_the_first_two_stages_of_the_first_tile(dtype, k, n):
    """A resident launch loads stages 0 .. STAGES - 1 of tile 0 (128
    columns, 64 bytes of K each) once and reads stage kc mod STAGES for K
    stage kc of every tile: the rhs it multiplies by, restated from those
    stages."""
    _, b = b1.operands(8, k, n, dtype, seed=4)
    per = 64 // b.element_size()
    assert b1.STAGES == 4
    got = b1.resident_rhs(b)
    assert got.shape == b.shape and got.dtype == b.dtype
    stages = torch.zeros((b1.STAGES * per, 128), dtype=b.dtype)
    stages[:min(k, b1.STAGES * per), :min(n, 128)] = b[:b1.STAGES * per, :128]
    for kc in range(-(-k // per)):
        for t in range(-(-n // 128)):
            rows, cols = slice(kc * per, (kc + 1) * per), slice(t * 128, (t + 1) * 128)
            block = got[rows, cols]
            s0 = (kc % b1.STAGES) * per
            want = stages[s0:s0 + block.shape[0], :block.shape[1]]
            assert torch.equal(block, want), (kc, t)


# (panels, cluster) of each of the nine shapes, int8 and bf16 alike
GEOMETRY = [(16, 8), (32, 1), (32, 2), (32, 4), (32, 4), (2, 4), (4, 4), (6, 4), (8, 4)]
H100_SMS = 132


@pytest.mark.parametrize("shape, want", zip(b1.SHAPES, GEOMETRY), ids=[s[3] for s in b1.SHAPES])
@pytest.mark.parametrize("es", [1, 2], ids=["int8", "bf16"])
def test_launch_geometry_of_the_nine_shapes(shape, want, es):
    """The clusters ``prepare`` launches for one chain: 64-row panels, one
    CTA a 128-column tile (the cluster the least power of two that holds
    them, at most the portable 8), K padded to 64 bytes; one chain's grid
    fits the H100's 132 SMs, and at the cube it is 16 panels x 8 CTAs = 128,
    where one block a panel gave 16."""
    m, k, n, _ = shape
    geo = b1.launch_geometry(m, k, n, es)
    assert (geo.panels, geo.cluster) == want
    assert geo.panels == -(-m // 64) and geo.ntile == -(-n // 128) <= geo.cluster
    assert geo.cluster in (1, 2, 4, 8) and geo.cluster < 2 * geo.ntile and geo.tiles == 1
    assert geo.kb % 64 == 0 and 0 <= geo.kb - k * es < 64 and geo.np == 128 * geo.ntile
    assert geo.grid(geo.panels) == geo.panels * geo.cluster <= H100_SMS
    assert geo.grid(3 * geo.panels) == 3 * geo.panels * geo.cluster  # copies
    assert geo.grid(1) == geo.grid(geo.panels)  # never fewer than a cluster a panel
    if (m, k, n) == (1024, 1024, 1024):
        assert geo.grid(geo.panels) == 128


@pytest.mark.parametrize("shape", b1.SHAPES, ids=[s[3] for s in b1.SHAPES])
@pytest.mark.parametrize("es", [1, 2], ids=["int8", "bf16"])
def test_card_filling_launch_is_clusters_of_one_cta_on_every_tile(shape, es):
    """The launch the rates time: clusters of one CTA, which computes every
    tile of its panel one after another and exchanges nothing, as many as
    the card holds (132 on the H100: one CTA an SM), at least one a panel;
    the same panels, padding and tiles as one chain."""
    m, k, n, _ = shape
    geo, one = b1.launch_geometry(m, k, n, es, copies=True), b1.launch_geometry(m, k, n, es)
    assert geo.cluster == 1 and geo.tiles == geo.ntile == one.ntile <= b1.MAX_TILES
    assert geo.owned(0) == list(range(geo.ntile))
    assert (geo.panels, geo.kb, geo.np, geo.exchanged) == (one.panels, one.kb, one.np,
                                                           one.exchanged)
    assert geo.grid(H100_SMS) == max(H100_SMS, geo.panels)


@pytest.mark.parametrize("copies", [False, True], ids=["one-chain", "filling"])
@pytest.mark.parametrize("m, k, n", [*((m, k, n) for m, k, n, _ in b1.SHAPES), *SHAPES,
                                     (64, 256, 1024), (64, 2048, 1000)])
def test_every_tile_has_one_owner_and_the_exchange_is_the_next_lhs(m, k, n, copies):
    """Each 128-column tile of the padded rhs is owned by exactly one CTA
    of its cluster (CTA r, tiles r, r + C, ...; CTAs past the tiles own
    none), the exchanged columns are [0, min(n, k)), and the CTAs' runs of
    exchanged columns tile them without overlap (what each sends its
    peers, or writes into its own panel where the cluster is one CTA)."""
    geo = b1.launch_geometry(m, k, n, 1, copies)

    def owned(rank):  # csrc/probes/mma_rate.cu: own, and tile rank + C j
        own = (geo.ntile - rank + geo.cluster - 1) // geo.cluster if rank < geo.ntile else 0
        return [rank + geo.cluster * j for j in range(own)]

    owners = {}
    for r in range(geo.cluster):
        assert owned(r) == geo.owned(r) and len(owned(r)) <= geo.tiles
        for t in owned(r):
            assert t not in owners
            owners[t] = r
    assert sorted(owners) == list(range(geo.np // 128))
    assert geo.exchanged == (0, min(n, k))
    covered = []
    for t in sorted(owners):
        # xbytes: the tile's columns below kk, 64 rows
        sent = max(0, min(128, geo.exchanged[1] - 128 * t))
        covered.extend(range(128 * t, 128 * t + sent))
    assert covered == list(range(min(n, k)))


def test_a_rhs_past_eight_tiles_is_refused():
    assert b1.launch_geometry(64, 64, 1024, 1).cluster == b1.MAX_CLUSTER == 8
    assert b1.launch_geometry(64, 64, 1024, 1, copies=True).tiles == b1.MAX_TILES == 8
    for copies in (False, True):
        with pytest.raises(ValueError, match="at most 8 tiles"):
            b1.launch_geometry(64, 64, 1025, 1, copies)


def test_resident_chain_on_the_cpu_is_the_plain_chain_on_resident_rhs():
    a, b = (torch.from_numpy(t) for t in _int8(70, 300, 200, seed=6))
    before = dict(b1.chain.launches)
    got = b1.chain(a, b, 3, path="wgmma", resident=True)
    assert torch.equal(got, b1.chain_ref(a, b1.resident_rhs(b), 3))
    assert not torch.equal(got, b1.chain_ref(a, b, 3))
    assert b1.chain.launches == before and set(before) == set(b1.PATHS)
