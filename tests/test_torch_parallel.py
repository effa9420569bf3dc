"""The sharded path (``blur_algorithms_tpu_torch.parallel``) against the JAX
package, on the CPU.

The JAX functions run on the 8 virtual host devices of ``tests/conftest.py``
with ``fused_dma.dma_form_applicable`` patched True (as
``tests/test_band_fused.py``'s ``test_sharded_dma_route_interpret``), so
their per-shard step is the DMA form in interpret mode, as the port's is K1a
on A4's frame (its plain version here). The port runs on a mesh of 8
``cpu`` entries: every shard's step, ``ppermute`` and ``all_to_all`` in one
process, as on a mesh of repeated cards.

- uint8: equal to JAX wherever both route the same rung (asserted: int8 on
  the CPU specs of both); float32 within 1e-5 * max|x| (JAX's float DMA
  form is bf16x3, the port's K2 f32);
- the distributed FFT within 2e-3 at 0..255 scale, uint8 within 1 count;
- port against port: the sharded result equals the single-device one;
- ``make_mesh``'s errors, AUTO's sharding rule under a patched device list,
  and the import guard (the port's ``parallel`` imports no JAX).
"""

import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from blur_algorithms_tpu import parallel as j_par  # noqa: E402
from blur_algorithms_tpu.ops.plan import make_plan as j_make_plan  # noqa: E402
from blur_algorithms_tpu.parallel import sharded as j_sharded  # noqa: E402
from blur_algorithms_tpu.utils import hw as j_hw  # noqa: E402
from blur_algorithms_tpu_torch import api, blur, blur_u8, make_plan, parallel  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fused_blur as t_fused  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fused_dma as t_dma  # noqa: E402
from blur_algorithms_tpu_torch.parallel import mesh as t_mesh  # noqa: E402
from blur_algorithms_tpu_torch.parallel import sharded as t_sharded  # noqa: E402
from blur_algorithms_tpu_torch.utils import hw  # noqa: E402

CPU8 = [torch.device("cpu")] * 8
MESHES = [(8, 1), (4, 2), (2, 4), (1, 8)]
REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def jax_dma(monkeypatch):
    monkeypatch.setattr("blur_algorithms_tpu.pallas_kernels.fused_dma.dma_form_applicable",
                        lambda *a, **k: True)


def _u8(shape, seed):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.uint8)


def _f32(shape, seed):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.float32)


def _j_mesh(dp, sp):
    return j_par.make_mesh(dp=dp, sp=sp, devices=jax.devices()[: dp * sp])


def _t_mesh(dp, sp):
    return parallel.make_mesh(dp=dp, sp=sp, devices=CPU8[: dp * sp])


def _rung(plan, h_loc):
    local = t_sharded._local_plan(plan, h_loc, plan.shape[1])
    return api._u8_dma_precision(local, hw.device_spec("cpu"))


def _sharded_u8_both(img, sigma, dp, sp):
    shape = img.shape[1:3]
    want = np.asarray(j_par.blur_sharded_u8(jnp.asarray(img), j_make_plan(shape, sigma),
                                            _j_mesh(dp, sp)))
    got = parallel.blur_sharded_u8(torch.from_numpy(img), make_plan(shape, sigma),
                                   _t_mesh(dp, sp))
    return got, want


# ---------------------------------------------------------------------------
# blur_sharded_u8 / blur_sharded against JAX


@pytest.mark.parametrize("dp, sp", MESHES)
def test_sharded_u8_equals_jax(jax_dma, dp, sp):
    img = _u8((8, 96, 80, 3), seed=1)
    plan = make_plan((96, 80), 2.0)
    assert _rung(plan, 96 // sp) == "int8"  # JAX's CPU spec certifies no rung either
    got, want = _sharded_u8_both(img, 2.0, dp, sp)
    assert got.shape == img.shape and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, blur_u8(torch.from_numpy(img), 2.0))  # port vs port


@pytest.mark.parametrize("dp, sp", MESHES)
def test_sharded_f32_against_jax(jax_dma, dp, sp):
    x = _f32((8, 3, 64, 48), seed=2)
    sigma = {1: 4.0, 2: 4.0, 4: 2.0, 8: 1.0}[sp]
    want = np.asarray(j_par.blur_sharded(jnp.asarray(x), j_make_plan((64, 48), sigma),
                                         _j_mesh(dp, sp)))
    got = parallel.blur_sharded(torch.from_numpy(x), make_plan((64, 48), sigma),
                                _t_mesh(dp, sp))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(x).max())
    assert torch.equal(got, blur(torch.from_numpy(x), sigma))


@pytest.mark.parametrize("sigma, sp", [(8.0, 4), (30.0, 8)])
def test_multi_hop_gather_against_jax(jax_dma, sigma, sp):
    """A support radius past the shard height: whole blocks from
    ceil(r / h_loc) neighbours, reflect-101 into the neighbours' data."""
    x = _f32((2, 3, 64, 48), seed=3)
    plan = make_plan((64, 48), sigma)
    assert plan.col.support_radius > 64 // sp
    want = np.asarray(j_par.blur_sharded(jnp.asarray(x), j_make_plan((64, 48), sigma),
                                         _j_mesh(8 // sp, sp)))
    got = parallel.blur_sharded(torch.from_numpy(x), plan, _t_mesh(8 // sp, sp))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(x).max())
    assert torch.equal(got, blur(torch.from_numpy(x), sigma))


@pytest.mark.parametrize("dp, sp", [(2, 2), (1, 4), (2, 1)])
def test_k1a_route_takes_haloed_rows_and_equals_jax(jax_dma, monkeypatch, dp, sp):
    """On the single-hop path each shard's K1a step gets its rows as views
    (``assemble.HaloedRows``: no cut, no concatenation) and A4's plain
    version runs on them; the result still equals the JAX package."""
    from blur_algorithms_tpu_torch.cuda_kernels.assemble import HaloedRows

    seen = []
    real = t_dma.blur_fused_haloed_dma
    monkeypatch.setattr(t_dma, "blur_fused_haloed_dma",
                        lambda rows, *a, **k: (seen.append(rows), real(rows, *a, **k))[1])
    img = _u8((4, 96, 80, 3), seed=8)
    plan = make_plan((96, 80), 2.0)
    got, want = _sharded_u8_both(img, 2.0, dp, sp)
    np.testing.assert_array_equal(got.numpy(), want)
    assert _rung(plan, 96 // sp) == "int8"
    assert len(seen) == dp * sp and all(isinstance(s, HaloedRows) for s in seen)
    # every shard's parts are views of one planar frame
    assert len({t.untyped_storage().data_ptr() for s in seen for t, _ in s.parts()}) == 1
    assert torch.equal(got, blur_u8(torch.from_numpy(img), 2.0))


def test_multi_hop_u8_equals_jax(jax_dma):
    img = _u8((2, 45, 64, 3), seed=4)  # indivisible height and a radius past it
    plan = make_plan((45, 64), 12.0)
    assert plan.col.support_radius > 12 and _rung(plan, 12) == "int8"
    got, want = _sharded_u8_both(img, 12.0, 2, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, blur_u8(torch.from_numpy(img), 12.0))


@pytest.mark.parametrize("shape, sigma, dp, sp", [
    ((5, 3, 64, 48), 4.0, 4, 2),  # indivisible batch
    ((4, 3, 61, 48), 3.0, 4, 2),  # indivisible height: the pad-row fill path
    ((2, 3, 61, 48), 4.0, 2, 4),  # r + 2 pad + 1 > h_loc: the gather
])
def test_indivisible_shapes_against_jax(jax_dma, shape, sigma, dp, sp):
    x = _f32(shape, seed=5)
    img = np.ascontiguousarray(np.moveaxis(x.astype(np.uint8), 1, -1))
    got = parallel.blur_sharded(torch.from_numpy(x), make_plan(shape[-2:], sigma),
                                _t_mesh(dp, sp))
    want = np.asarray(j_par.blur_sharded(jnp.asarray(x), j_make_plan(shape[-2:], sigma),
                                         _j_mesh(dp, sp)))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(x).max())
    got8, want8 = _sharded_u8_both(img, sigma, dp, sp)
    np.testing.assert_array_equal(got8.numpy(), want8)
    assert torch.equal(got8, blur_u8(torch.from_numpy(img), sigma))


# ---------------------------------------------------------------------------
# the reroutes to the distributed FFT


def _spy_fft(monkeypatch):
    calls = []
    real = t_sharded.blur_fft_sharded
    monkeypatch.setattr(t_sharded, "blur_fft_sharded",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    return calls


def test_wide_radius_reroutes_to_the_fft(jax_dma, monkeypatch):
    tiny = dataclasses.replace(j_hw.spec_for_kind("TPU v5 lite"), peak_bf16_tflops=1.0)
    monkeypatch.setattr(j_hw, "budgets", lambda: tiny)
    spec = dataclasses.replace(hw.device_spec("cpu"), auto_fused_max_radius_u8=128)
    monkeypatch.setattr(t_sharded, "device_spec", lambda device: spec)
    j_calls = []
    real = j_sharded.blur_fft_sharded
    monkeypatch.setattr(j_sharded, "blur_fft_sharded",
                        lambda *a, **k: (j_calls.append(1), real(*a, **k))[1])
    calls = _spy_fft(monkeypatch)
    h, w, sigma = 384, 192, 80.0  # r 186 > the 128 crossover
    img = _u8((2, h, w, 3), seed=6)
    got, want = _sharded_u8_both(img, sigma, 2, 2)
    assert calls and j_calls
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("sigma, route", [(3.0, "k1a hybrid"), (26.0, "split")])
def test_shards_route_as_one_device_does(monkeypatch, sigma, route):
    """Under the H100 spec a uint8 shard takes the kernel ``blur_fused_u8``
    takes on one device: the haloed split from the card's uint8 split
    radius (r 85 >= 82; the JAX path would take its DMA form there), K1a
    with the certified hybrid rung below it (r 9). The result equals the
    single-device fused engine's under the same spec."""
    h100 = hw.spec_for("NVIDIA H100 80GB HBM3", 132, 232448, 80 << 30)
    for mod in (t_sharded, t_fused):
        monkeypatch.setattr(mod, "device_spec", lambda device: h100)
    ran = []
    for mod, name in ((t_dma, "blur_fused_haloed_dma"), (t_fused, "_blur_fused_haloed_split")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _r=real, **k: (
            ran.append((_n, k.get("precision", a[2] if len(a) > 2 else None))), _r(*a, **k))[1])
    img = _u8((2, 96, 192, 3), seed=21)
    plan = make_plan((96, 192), sigma)
    got = t_sharded.blur_sharded_u8(torch.from_numpy(img), plan, _t_mesh(1, 2))
    want = t_fused.blur_fused_u8(torch.from_numpy(img).movedim(-1, -3).contiguous(), plan,
                                 api._u8_dma_precision(plan, h100))
    assert torch.equal(got, want.movedim(-3, -1))
    expect = {"k1a hybrid": ("blur_fused_haloed_dma", "hybrid"),
              "split": ("_blur_fused_haloed_split", "int8")}[route]
    assert ran == [expect] * 2


def test_gather_memory_guard_reroutes_to_the_fft(jax_dma, monkeypatch):
    small = dataclasses.replace(j_hw.spec_for_kind("TPU v5 lite"), hbm_bytes=1 << 16)
    monkeypatch.setattr(j_hw, "budgets", lambda: small)
    spec = dataclasses.replace(hw.device_spec("cpu"), split_hbm_budget=small.split_hbm_budget)
    monkeypatch.setattr(t_sharded, "device_spec", lambda device: spec)
    calls = _spy_fft(monkeypatch)
    h, w, sigma = 128, 96, 20.0  # r 46 > h_loc 32: the gather regime
    img = _u8((2, h, w, 3), seed=7)
    got, want = _sharded_u8_both(img, sigma, 2, 4)
    assert calls
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("shape, dp, sp", [((4, 3, 64, 48), 4, 2), ((3, 3, 61, 47), 2, 4)])
def test_fft_sharded_against_jax(shape, dp, sp):
    x = _f32(shape, seed=8)
    plan_t, plan_j = make_plan(shape[-2:], 4.0), j_make_plan(shape[-2:], 4.0)
    got = parallel.blur_fft_sharded(torch.from_numpy(x), plan_t, _t_mesh(dp, sp))
    want = np.asarray(j_par.blur_fft_sharded(jnp.asarray(x), plan_j, _j_mesh(dp, sp)))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)
    from blur_algorithms_tpu_torch.ops.fft_conv import blur_fft_tiles

    np.testing.assert_allclose(got.numpy(), blur_fft_tiles(torch.from_numpy(x), plan_t).numpy(),
                               rtol=0, atol=2e-3)
    img = np.ascontiguousarray(np.moveaxis(x.astype(np.uint8), 1, -1))
    got8 = parallel.blur_fft_sharded_u8(torch.from_numpy(img), plan_t, _t_mesh(dp, sp))
    want8 = np.asarray(j_par.blur_fft_sharded_u8(jnp.asarray(img), plan_j, _j_mesh(dp, sp)))
    assert np.abs(got8.numpy().astype(int) - want8.astype(int)).max() <= 1


def test_collectives():
    blocks = [torch.full((2, 3), float(i)) for i in range(4)]
    got = t_sharded.ppermute(blocks, [(0, 1), (1, 2), (2, 3)], CPU8[:4])
    assert [float(g[0, 0]) for g in got] == [0.0, 0.0, 1.0, 2.0]
    assert torch.equal(got[0], torch.zeros((2, 3)))  # no source: zeros
    x = [torch.arange(8.0).reshape(1, 8) + 10 * i for i in range(2)]
    y = t_sharded.all_to_all(x, 1, 0, CPU8[:2])
    assert torch.equal(y[0], torch.tensor([[0.0, 1, 2, 3], [10, 11, 12, 13]]))
    assert torch.equal(t_sharded.all_to_all(y, 0, 1, CPU8[:2])[1], x[1])


# ---------------------------------------------------------------------------
# meshes and devices


@pytest.mark.parametrize("dp, sp", [(3, 2), (None, 3), (2, 2)])
def test_make_mesh_errors_as_jax(dp, sp):
    with pytest.raises(ValueError) as want:
        j_par.make_mesh(dp=dp, sp=sp, devices=jax.devices()[:8])
    with pytest.raises(ValueError) as got:
        parallel.make_mesh(dp=dp, sp=sp, devices=CPU8)
    assert str(got.value) == str(want.value)


def test_make_mesh():
    mesh = parallel.make_mesh(sp=2, devices=CPU8)
    assert mesh.shape == {"dp": 4, "sp": 2}
    assert mesh.devices == ((torch.device("cpu"),) * 2,) * 4
    with pytest.raises(ValueError, match="one type"):
        parallel.make_mesh(dp=2, devices=["cpu", "meta"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            parallel.make_mesh()


def test_sharded_input_and_mesh_device_types_must_agree():
    plan = make_plan((32, 40), 2.0)
    x = torch.zeros((2, 3, 32, 40), dtype=torch.uint8)
    cuda_mesh = parallel.make_mesh(dp=2, devices=[torch.device("cuda", 0)] * 2)
    with pytest.raises(ValueError, match="mesh"):
        parallel.blur_sharded(x, plan, cuda_mesh)
    with pytest.raises(ValueError, match="mesh"):
        parallel.blur_fft_sharded(x.float(), plan, cuda_mesh)
    with pytest.raises(ValueError, match="plan shape"):
        parallel.blur_sharded(x, make_plan((32, 41), 2.0), _t_mesh(2, 1))


# ---------------------------------------------------------------------------
# AUTO's sharding rule


@pytest.fixture
def eight_cpus(monkeypatch):
    monkeypatch.setattr(t_mesh, "visible_devices", lambda device: list(CPU8))


def _mesh_of(fn):
    meshes = [c.cell_contents for c in fn.__closure__
              if isinstance(c.cell_contents, t_mesh.Mesh)]
    assert len(meshes) == 1
    return meshes[0].shape["dp"], meshes[0].shape["sp"]


def test_auto_stays_on_one_device():
    plan = make_plan((64, 48), 3.0)
    assert t_mesh.visible_devices("cpu") == [torch.device("cpu")]
    assert api._auto_sharded_fn((8, 64, 48, 3), plan, True, "cpu") is None


def test_auto_shards_under_eight_devices(eight_cpus):
    img = torch.from_numpy(_u8((8, 64, 48, 3), seed=9))
    plan = make_plan((64, 48), 3.0)
    fn = api._auto_sharded_fn(tuple(img.shape), plan, True, "cpu")
    assert fn is not None and fn._sharded and _mesh_of(fn) == (8, 1)
    got = blur_u8(img, 3.0)  # AUTO takes the sharded callable
    assert torch.equal(got, fn(img))
    assert torch.equal(got, blur_u8(img, 3.0, engine="fused"))  # not sharded: same bits
    x = torch.from_numpy(_f32((4, 3, 64, 48), seed=10))
    fn = api._auto_sharded_fn(tuple(x.shape), plan, False, "cpu")
    assert _mesh_of(fn) == (4, 1)  # sub-floor frames: dp only, on 4 devices
    assert torch.equal(blur(x, 3.0), blur(x, 3.0, engine="fused"))


def test_auto_mesh_factorisation(eight_cpus, monkeypatch):
    plan = make_plan((64, 48), 3.0)
    assert _mesh_of(api._auto_sharded_fn((2, 64, 48, 3), plan, True, "cpu")) == (2, 1)
    assert _mesh_of(api._auto_sharded_fn((5, 64, 48, 3), plan, True, "cpu")) == (4, 1)
    big = make_plan((5000, 4000), 3.0)  # 20 MP, past the 16.8 MP floor
    assert _mesh_of(api._auto_sharded_fn((2, 5000, 4000, 3), big, True, "cpu")) == (2, 4)
    assert api._auto_sharded_fn((64, 48, 3), plan, True, "cpu") is None
    monkeypatch.setattr(api, "_auto_sp_min_px", lambda device: 1 << 10)
    img = torch.from_numpy(_u8((64, 64, 3), seed=11))
    fn = api._auto_sharded_fn(tuple(img.shape), make_plan((64, 64), 2.0), True, "cpu")
    assert _mesh_of(fn) == (1, 8)
    assert torch.equal(blur_u8(img, 2.0), blur_u8(img, 2.0, engine="fused"))


def test_auto_keeps_gradients_on_one_device(eight_cpus):
    x = torch.from_numpy(_f32((4, 3, 32, 40), seed=12)).requires_grad_()
    y = blur(x, 2.0)
    y.sum().backward()
    assert x.grad is not None and y.grad_fn is not None


def test_device_spec_carries_the_sp_floor():
    h100 = hw.spec_for("NVIDIA H100 80GB HBM3", 132, 232448, 80 << 30)
    assert h100.auto_sp_min_px == max(1 << 22, round((1 << 24) * 3350 / 819.0))
    assert hw.device_spec("cpu").auto_sp_min_px == j_hw.budgets().auto_sp_min_px


# ---------------------------------------------------------------------------
# the port imports no JAX


def test_parallel_imports_no_jax():
    code = (
        "import sys\n"
        "import blur_algorithms_tpu_torch.parallel, blur_algorithms_tpu_torch.api\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'blur_algorithms_tpu' or m.startswith('blur_algorithms_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
    for path in (REPO / "blur_algorithms_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0]
                assert top not in ("jax", "blur_algorithms_tpu"), (path, line)
