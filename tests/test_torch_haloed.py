"""The sharded path's per-shard kernels against the JAX package, on the CPU.

A shard's step blurs rows that carry the caller's halo rows (another
shard's): ``(..., H + 2 rh, W)`` in, ``(..., H, W)`` out, the columns still
reflected. The port's kernels for it (A4, K1a on A4's frame, K2 and its
single-axis form with ``pre_padded_col``, and the split's cols passes on
pre-padded ``E``) run CUDA on a card and their plain versions here:

- A4's plain version equals the JAX ``_assemble_padded_prepad`` in
  interpret mode, its ``hp + 8`` growth included;
- ``blur_fused_haloed_dma`` equals the JAX function of that name in
  interpret mode, int8 and hybrid, uint8 and the float32 store (the int8
  f32 store rounds its epilogue as XLA compiles the JAX expression on an
  FMA host, so bit for bit);
- ``blur_fused_haloed`` and ``_blur_fused_haloed_split`` against the JAX
  functions with ``fused_blur._FORCE_INTERPRET`` set, as the port's K2 and
  split tests run them: uint8 within 1 count (bit-equal on the int8-e32
  split), float32 within K2's 2e-3 at 0..255 scale;
- port against port: each ``pre_padded_col`` form on rows the caller
  reflected equals the same form reflecting them itself, and the haloed
  step on a shard cut from a taller frame equals the single-device blur of
  that frame on the shard's rows.

The kernels themselves run on the card in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from blur_algorithms_tpu.ops.plan import make_plan as j_make_plan  # noqa: E402
from blur_algorithms_tpu.pallas_kernels import fused_blur as j_fused  # noqa: E402
from blur_algorithms_tpu.pallas_kernels import fused_dma as j_dma  # noqa: E402
from blur_algorithms_tpu_torch import make_plan  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import assemble  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fused_blur as t_fused  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fused_dma as t_dma  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fused_split as t_split  # noqa: E402
from blur_algorithms_tpu_torch.ops.pad import reflect_101  # noqa: E402
from blur_algorithms_tpu_torch.utils import hw  # noqa: E402

F32_TOL = 2e-3  # K2 against the JAX bf16x3 kernels, 0..255 scale


def _shard(h, w, rh, seed, planes=2, dtype=np.uint8):
    """A shard of ``h`` rows with ``rh`` halo rows each side: rows of a
    taller random frame, so the halo rows are real data."""
    rng = np.random.default_rng(seed)
    x = rng.random((planes, h + 2 * rh, w)) * 255
    return x.astype(dtype)


# ---------------------------------------------------------------------------
# A4


@pytest.mark.parametrize("hs, w, rw, orw, hp, wp", [
    (74, 320, 5, 128, 96, 640),
    (70, 250, 1, 128, 88, 512),
    (9, 129, 8, 128, 16, 384),
    (80, 256, 3, 128, 80, 512),  # hp <= 8 * (hs // 8): the frame grows by 8 rows
    (40, 200, 140, 256, 48, 768),  # a column radius past w - 1: clamped, zeros past it
])
def test_a4_plain_equals_jax(hs, w, rw, orw, hp, wp):
    x = (np.random.default_rng(hs + w).random((2, hs, w)) * 255).astype(np.uint8)
    want = np.asarray(j_dma._assemble_padded_prepad(jnp.asarray(x), rw, orw, hp, wp))
    got = assemble.assemble_padded_prepad_ref(torch.from_numpy(x), rw, orw, hp, wp)
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper on a CPU tensor runs the plain version, counting nothing
    before = assemble.assemble_padded_prepad.launches
    again = assemble.assemble_padded_prepad(torch.from_numpy(x), rw, orw, hp, wp)
    assert assemble.assemble_padded_prepad.launches == before
    assert torch.equal(again, got)


def test_a4_is_a5_with_no_row_border():
    x = torch.from_numpy(_shard(40, 200, 0, seed=1))
    a4 = assemble.assemble_padded_prepad_ref(x, 7, 16, 64, 240)
    assert torch.equal(a4, assemble.assemble_padded_ref(x, 0, 7, 0, 16, 64, 240))
    assert torch.equal(a4[..., :40, 16:216], x)


def test_a4_rejects_a_frame_that_cannot_hold_the_borders():
    x = torch.zeros((2, 40, 200), dtype=torch.uint8)
    with pytest.raises(ValueError):
        assemble.assemble_padded_prepad(x, 8, 4, 64, 240)  # orw < rw
    with pytest.raises(ValueError):
        assemble.assemble_padded_prepad(x.to("meta"), 8, 16, 64, 240)


# ---------------------------------------------------------------------------
# K1a on caller-supplied rows


@pytest.mark.parametrize("shape, sigma", [((64, 320), 3.0), ((40, 200), (2.0, 5.0))])
@pytest.mark.parametrize("rung", ["int8", "hybrid"])
@pytest.mark.parametrize("out_u8", [True, False])
def test_haloed_dma_equals_jax(shape, sigma, rung, out_u8):
    tp, jp = make_plan(shape, sigma), j_make_plan(shape, sigma)
    x = _shard(*shape, tp.col.support_radius, seed=2)
    want = np.asarray(j_dma.blur_fused_haloed_dma(jnp.asarray(x), jp, precision=rung,
                                                  out_u8=out_u8))
    got = t_dma.blur_fused_haloed_dma(torch.from_numpy(x), tp, rung, out_u8=out_u8)
    assert got.dtype == (torch.uint8 if out_u8 else torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rung", ["int8", "hybrid", "bf16"])
def test_haloed_dma_is_the_blur_of_the_taller_frame(rung):
    """Output row o reads rows o .. o + 2rh of the input, all real: the
    shard's result is the single-device blur of the taller frame on its
    rows (no border reaches them)."""
    h, w, sigma = 48, 200, 4.0
    plan = make_plan((h, w), sigma)
    rh = plan.col.support_radius
    tall = torch.from_numpy(_shard(h, w, rh, seed=3, planes=3))
    tall_plan = make_plan((h + 2 * rh, w), sigma)
    assert (tall_plan.col.support_radius, tall_plan.row.support_radius) == (rh, rh)
    for out_u8 in (True, False):
        want = t_dma._plain(tall, tall_plan, rung, out_u8)[:, rh : rh + h]
        got = t_dma.blur_fused_haloed_dma(tall, plan, rung, out_u8=out_u8)
        assert torch.equal(got, want), (rung, out_u8)


def test_int8_f32_store_is_the_epilogue_before_rounding():
    plan = make_plan((40, 200), 3.0)
    x = torch.from_numpy(_shard(40, 200, 0, seed=4))
    y = t_dma.blur_fused_u8_dma_ref(x, plan, out_u8=False)
    assert y.dtype == torch.float32
    # the uint8 store rounds each step of the epilogue, the f32 store
    # contracts two multiply-adds: the values differ by an ulp at most
    u8 = t_dma.blur_fused_u8_dma_ref(x, plan)
    assert int((t_dma.store_u8_ref(y).int() - u8.int()).abs().max()) <= 1
    # every form takes the f32 store: the plain path of the pinned forms
    got = t_dma.blur_fused_u8_dma(x, plan, out_u8=False, direct=False)
    assert torch.equal(got, y)


def test_haloed_dma_rejects_rows_without_halos():
    plan = make_plan((40, 200), 3.0)
    with pytest.raises(ValueError, match="halo"):
        t_dma.blur_fused_haloed_dma(torch.zeros((2, 40, 200), dtype=torch.uint8), plan)
    with pytest.raises(TypeError):
        t_dma.blur_fused_haloed_dma(torch.zeros((2, 58, 200)), plan)


# ---------------------------------------------------------------------------
# the blocked haloed kernels: K2 and the haloed split


def _j_haloed(x, jp, precision, out_u8):
    return np.asarray(j_fused.blur_fused_haloed(jnp.asarray(x), jp, precision=precision,
                                                out_u8=out_u8))


@pytest.mark.parametrize("shape, sigma", [((40, 200), 3.0), ((48, 136), (5.0, 2.0))])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_haloed_bf16x3_single_kernel_against_jax(monkeypatch, shape, sigma, dtype):
    monkeypatch.setattr(j_fused, "_FORCE_INTERPRET", True)
    tp, jp = make_plan(shape, sigma), j_make_plan(shape, sigma)
    x = _shard(*shape, tp.col.support_radius, seed=5, dtype=dtype)
    before = t_fused.blur_fused_f32.launches
    for out_u8 in (False, True):
        got = t_fused.blur_fused_haloed(torch.from_numpy(x), tp, "bf16x3", out_u8=out_u8)
        want = _j_haloed(x, jp, "bf16x3", out_u8)
        if out_u8:
            assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_TOL)
    assert t_fused.blur_fused_f32.launches == before  # CPU: the plain version


def test_haloed_int8_single_kernel_runs_k1a(monkeypatch):
    """``"int8"`` without the split: the port's single int8 kernel is K1a on
    A4's frame (JAX: the blocked int8 kernel), within 1 count."""
    monkeypatch.setattr(j_fused, "_FORCE_INTERPRET", True)
    shape, sigma = (40, 200), 3.0
    tp, jp = make_plan(shape, sigma), j_make_plan(shape, sigma)
    x = _shard(*shape, tp.col.support_radius, seed=6)
    calls = []
    real = t_dma.blur_fused_haloed_dma
    monkeypatch.setattr(t_dma, "blur_fused_haloed_dma",
                        lambda *a, **k: (calls.append(a[2]), real(*a, **k))[1])
    got = t_fused.blur_fused_haloed(torch.from_numpy(x), tp, "int8", out_u8=True)
    assert calls == ["int8"]
    want = _j_haloed(x, jp, "int8", True)
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("shape, sigma", [((40, 200), 3.0), ((24, 300), 40.0)])
def test_haloed_int8_split_bit_equal_to_jax(monkeypatch, shape, sigma):
    """The int8-e32 haloed split: pass 1 over all H + 2rh rows, the int8
    pass 2 on pre-padded ``E``; uint8 and the float32 store bit-equal."""
    monkeypatch.setattr(j_fused, "_FORCE_INTERPRET", True)
    tp, jp = make_plan(shape, sigma), j_make_plan(shape, sigma)
    assert t_fused.e32_split_applicable(tp, "int8", 1)
    assert not t_fused._hybrid_cols_ok(tp, "cpu") and not j_fused._hybrid_cols_ok(jp)
    x = _shard(*shape, tp.col.support_radius, seed=7)
    for out_u8 in (True, False):
        got = t_fused._blur_fused_haloed_split(torch.from_numpy(x), tp, "int8", out_u8)
        want = np.asarray(j_fused._blur_fused_haloed_split(jnp.asarray(x), jp, "int8",
                                                           out_u8))
        np.testing.assert_array_equal(got.numpy(), want)


def test_haloed_hybrid_pass2_against_jax(monkeypatch):
    """The hybrid pass 2 on pre-padded ``E`` against the JAX ``hybrid_cols``
    kernel with ``pre_padded_col``: within two f32 ulps (the JAX kernel adds
    one partial sum per neighbour block), uint8 within 1 count."""
    monkeypatch.setattr(j_fused, "_FORCE_INTERPRET", True)
    shape, sigma = (24, 300), 40.0
    tp, jp = make_plan(shape, sigma), j_make_plan(shape, sigma)
    _, t_cols = t_fused._split_plans(tp)
    _, j_cols = j_fused._split_plans(jp)
    x = _shard(*shape, tp.col.support_radius, seed=8)
    e = t_split.fused_split_rows_int8(torch.from_numpy(x), t_fused._haloed_rows_plan(tp))
    for out_u8 in (True, False):
        got = t_split.fused_split_cols_hybrid(e, t_cols, out_u8=out_u8, pre_padded_col=True)
        want = np.asarray(j_fused._blur_fused_planar(
            jnp.asarray(e.numpy()), j_cols, j_fused._pick_tile(j_cols, 2, "int8"), "hybrid",
            out_u8=out_u8, e32="in", pre_padded_col=True))
        if out_u8:
            assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2 * 2.0 ** -16)


def test_haloed_f32_split_against_jax(monkeypatch):
    monkeypatch.setattr(j_fused, "_FORCE_INTERPRET", True)
    shape, sigma = (24, 300), 40.0
    tp, jp = make_plan(shape, sigma), j_make_plan(shape, sigma)
    x = _shard(*shape, tp.col.support_radius, seed=9, dtype=np.float32)
    got = t_fused._blur_fused_haloed_split(torch.from_numpy(x), tp, "bf16x3", False)
    want = np.asarray(j_fused._blur_fused_haloed_split(jnp.asarray(x), jp, "bf16x3", False))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_TOL)


# ---------------------------------------------------------------------------
# port against port: pre_padded_col on rows the caller reflected


def _reflected(x, r):
    return reflect_101(x, [(r, r)], axes=[-2]).contiguous()


@pytest.mark.parametrize("sigma", [3.0, (6.0, 1.0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
def test_pre_padded_k2_equals_k2_on_reflected_rows(sigma, dtype):
    plan = make_plan((40, 136), sigma)
    x = torch.from_numpy(_shard(40, 136, 0, seed=10, planes=3, dtype=np.float32)).to(dtype)
    xr = _reflected(x, plan.col.support_radius)
    for out_u8 in (False, True):
        got = t_fused.blur_fused_f32(xr, plan, out_u8=out_u8, pre_padded_col=True)
        assert got.shape == x.shape
        assert torch.equal(got, t_fused.blur_fused_f32(x, plan, out_u8=out_u8))


def test_pre_padded_single_axis_and_split_cols_equal_their_reflecting_forms():
    plan = make_plan((40, 136), 12.0)
    _, cols_plan = t_fused._split_plans(plan)
    rh = plan.col.support_radius
    x = torch.from_numpy(_shard(40, 136, 0, seed=11, planes=3, dtype=np.float32))
    got = t_fused.blur_fused_axis_f32(_reflected(x, rh), cols_plan, pre_padded_col=True)
    assert torch.equal(got, t_fused.blur_fused_axis_f32(x, cols_plan))
    e = torch.from_numpy(np.random.default_rng(12).integers(
        -16000, 16000, (3, 40, 136), dtype=np.int16))
    for pass2 in (t_split.fused_split_cols_int8, t_split.fused_split_cols_hybrid):
        for out_u8 in (True, False):
            got = pass2(_reflected(e, rh), cols_plan, out_u8=out_u8, pre_padded_col=True)
            assert torch.equal(got, pass2(e, cols_plan, out_u8=out_u8)), pass2.__name__


def test_pre_padded_forms_check_the_halo_rows():
    plan = make_plan((40, 136), 3.0)
    _, cols_plan = t_fused._split_plans(plan)
    with pytest.raises(ValueError, match="halo"):
        t_fused.blur_fused_f32(torch.zeros((2, 40, 136)), plan, pre_padded_col=True)
    with pytest.raises(ValueError, match="halo"):
        t_split.fused_split_cols_int8(torch.zeros((2, 40, 136), dtype=torch.int16),
                                      cols_plan, pre_padded_col=True)


# ---------------------------------------------------------------------------
# the haloed router


def test_haloed_fused_feasible():
    assert t_fused.haloed_fused_feasible(make_plan((64, 1400), 180.0), 1, "int8")
    wide = make_plan((1300, 1400), 300.0)  # r 998: the split only
    assert t_fused.haloed_fused_feasible(wide, 4, "bf16x3")
    assert not t_fused.haloed_fused_feasible(make_plan((8400, 96), 1500.0), 4, "bf16x3")


def test_haloed_router_takes_the_split_from_the_device_split_radius(monkeypatch):
    """Under a spec with a split radius (the H100's uint8 82) the haloed
    step runs the haloed split, int8-e32 for uint8 with the device's pass
    2; below it one kernel. The router reads ``fused_blur.device_spec``."""
    h100 = hw.spec_for("NVIDIA H100 80GB HBM3", 132, 232448, 80 << 30)
    monkeypatch.setattr(t_fused, "device_spec", lambda device: h100)
    ran = []
    for name in ("fused_split_rows_int8", "fused_split_cols_hybrid",
                 "fused_split_cols_int8"):
        real = getattr(t_split, name)
        monkeypatch.setattr(t_split, name, lambda *a, _n=name, _r=real, **k: (
            ran.append((_n, k.get("pre_padded_col", False))), _r(*a, **k))[1])
    wide = make_plan((24, 300), 26.0)  # r 85 >= 82
    x = torch.from_numpy(_shard(24, 300, wide.col.support_radius, seed=13))
    t_fused.blur_fused_haloed(x, wide, "int8", out_u8=True)
    assert ran == [("fused_split_rows_int8", False), ("fused_split_cols_hybrid", True)]
    ran.clear()
    small = make_plan((24, 300), 3.0)
    x = torch.from_numpy(_shard(24, 300, small.col.support_radius, seed=14))
    t_fused.blur_fused_haloed(x, small, "int8", out_u8=True)
    assert ran == []
