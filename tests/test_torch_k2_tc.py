"""K2 and its single-axis form as 3xTF32 band products (``csrc/fused_blur.cu``).

The kernels run only on a card. Here, on the CPU:

- the band tables ``tc_table`` (``Thi`` then ``Tlo``) against the taps, laid
  out as the kernels' lanes read them;
- ``blur_fused_f32_tc_model``, the plain model of the kernels' arithmetic
  (tf32 halves by bit arithmetic, the same tables, each output's products
  summed exactly and rounded once), against the plain version
  ``blur_fused_f32_ref`` within the card's tolerances (``1e-3 * max|x| /
  255`` for f32, 1 count for uint8) and against the JAX ``_kernel`` in
  interpret mode within the limits of
  ``test_torch_fused_blur.test_plain_k2_against_jax_blocked_kernel``;
- a NumPy emulation of the kernels' tiling (each warp's lanes, A and B
  fragments, the ring of A fragments, the chunks of the window, the
  aligned staging, the fragment stores), with each ``mma`` an exact
  product rounded to f32, against the model within the same tolerances:
  what a wrong index in the tiling would break.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from blur_algorithms_tpu.ops import plan as j_plan  # noqa: E402
from blur_algorithms_tpu.pallas_kernels import fused_blur as j_fused  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fused_blur as t_fused  # noqa: E402
from blur_algorithms_tpu_torch.ops import plan as t_plan  # noqa: E402
from blur_algorithms_tpu_torch.ops.kernels import gaussian_kernel  # noqa: E402

ASYM_ROW = [0.05, 0.1, 0.5, 0.2, 0.3, -0.1, 0.02]
ASYM_COL = [-0.2, 0.4, 0.9, 0.1, -0.05]
SHARPEN = [-0.25, 1.5, -0.25]


@pytest.fixture(autouse=True)
def _one_thread():
    """Tap-by-tap torch ops spin against the suite's other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tf32(a: np.ndarray) -> np.ndarray:
    return t_fused._tf32_bits(np.asarray(a, np.float32).view(np.int32)).view(np.float32)


def _f32(shape, scale, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.random(shape) * scale).astype(np.float32))


def _u8(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, size=shape, dtype=np.uint8))


def _limit(x: torch.Tensor) -> float:
    return 1e-3 * float(x.float().abs().max()) / 255


# ---------------------------------------------------------------------------
# the band tables


@pytest.mark.parametrize("r", [0, 1, 32, 165, 598, 1330, 3994])
def test_tc_table_holds_the_taps_where_the_lanes_read_them(r):
    taps = gaussian_kernel(max(r, 1) / 3.3, 2 * r + 1).astype(np.float32)
    if r:
        taps[::3] *= -1.0  # signed taps: the halves keep each sign
    table = t_fused.tc_table(taps)
    steps = t_fused.band_steps(r)
    n = 8 * steps + 8
    assert table.dtype == np.float32 and table.shape == (2 * n,)
    hi, lo = table[:n], table[n:]
    # tf32 values: the 13 low mantissa bits clear
    assert not (table.view(np.int32) & 0x1FFF).any()
    # Thi the tf32 rounding of each tap, Tlo that of the remainder, zeros
    # around them; Thi + Tlo is the tap to 2^-23 of it (exactly where the
    # tap has 22 significant bits or fewer)
    np.testing.assert_array_equal(hi[7 : 8 + 2 * r], _tf32(taps))
    np.testing.assert_array_equal(lo[7 : 8 + 2 * r], _tf32(taps - _tf32(taps)))
    for half in (hi, lo):
        assert not half[:7].any() and not half[8 + 2 * r :].any()
    rec = hi[7 : 8 + 2 * r].astype(np.float64) + lo[7 : 8 + 2 * r]
    assert np.all(np.abs(rec - taps) <= 2.0**-23 * np.abs(taps))
    # the band as the lanes read it: lane (g, tig) of step s reads B[tig][g]
    # and B[tig + 4][g] at 7 + 8 s + tig - g and 4 past it, B[k][n] = taps[8 s
    # + k - n]; the steps cover every tap of the 8 outputs
    s = np.arange(steps)[:, None, None, None]
    g = np.arange(8)[None, :, None, None]
    tig = np.arange(4)[None, None, :, None]
    k = tig + 4 * np.arange(2)[None, None, None, :]
    idx = 8 * s + k - g
    want = np.where((idx >= 0) & (idx <= 2 * r), taps[np.clip(idx, 0, 2 * r)], 0.0)
    got = hi[7 + idx].astype(np.float64) + lo[7 + idx]
    np.testing.assert_allclose(got, want, rtol=2.0**-23, atol=0)
    covered = np.zeros(2 * r + 1, int)
    np.add.at(covered, idx[(idx >= 0) & (idx <= 2 * r)], 1)
    assert (covered == 8).all()  # each tap once for each of the 8 outputs


def test_tc_table_reconstructs_short_taps_exactly():
    taps = np.array([0.25, 0.5, 0.25, -0.125, 1.0], np.float32)
    table = t_fused.tc_table(taps)
    n = table.shape[0] // 2
    np.testing.assert_array_equal(table[7:12], taps)
    assert not table[n:].any()


# ---------------------------------------------------------------------------
# the 3xTF32 model against the plain version and the JAX kernel

MODEL_CASES = [
    ("sigma3-f32", (40, 150), 3.0, "f32"),
    ("sigma10-1e4", (72, 160), 10.0, "1e4"),
    ("sigma25-f32", (64, 200), 25.0, "f32"),
    ("asymmetric-signed", (40, 200), (ASYM_ROW, ASYM_COL), "f32"),
    ("sharpen-u8", (48, 96), (SHARPEN, SHARPEN), "u8"),
    ("row-radius-0", (40, 136), ([1.0], [0.03, 0.1, 0.22, 0.3, 0.22, 0.1, 0.03]), "f32"),
]


def _plan(shape, spec):
    if isinstance(spec, tuple) and isinstance(spec[0], list):
        return t_plan.make_custom_plan(shape, *spec)
    return t_plan.make_plan(shape, spec)


def _case_input(shape, kind, seed, planes=2):
    if kind == "u8":
        return _u8((planes, *shape), seed)
    return _f32((planes, *shape), 1e4 if kind == "1e4" else 255.0, seed)


@pytest.mark.parametrize("pre", [False, True], ids=["reflect", "pre-padded"])
@pytest.mark.parametrize("name, shape, spec, kind", MODEL_CASES, ids=[c[0] for c in MODEL_CASES])
def test_tc_model_within_the_card_tolerance_of_the_plain_version(name, shape, spec, kind, pre):
    plan = _plan(shape, spec)
    rh = plan.col.support_radius
    x = _case_input((shape[0] + 2 * rh if pre else shape[0], shape[1]), kind, seed=len(name))
    for out_u8 in (False, True):
        got = t_fused.blur_fused_f32_tc_model(x, plan, out_u8=out_u8, pre_padded_col=pre)
        want = t_fused.blur_fused_f32_ref(x, plan, out_u8=out_u8, pre_padded_col=pre)
        assert got.shape == want.shape == (2, *shape) and got.dtype == want.dtype
        d = float((got.double() - want.double()).abs().max())
        assert d <= (1 if out_u8 else _limit(x)), (name, out_u8, d)


@pytest.mark.parametrize("axis", ["rows", "cols"])
@pytest.mark.parametrize("shape, sigma, kind", [
    ((24, 900), 120.0, "f32"), ((900, 24), 120.0, "u8"), ((20, 1300), 200.0, "1e4"),
], ids=["r398-f32", "r398-u8", "r665-1e4"])
def test_tc_model_single_axis_within_the_card_tolerance(axis, shape, sigma, kind):
    """The single-axis form's plans (one radius-0 axis) at wide radii; the
    pre-padded cols pass too."""
    plan = t_plan.make_plan(shape, sigma)
    rows, cols = t_fused._split_plans(plan)
    p = rows if axis == "rows" else cols
    x = _case_input(shape, kind, seed=7)
    for out_u8 in (False, True):
        got = t_fused.blur_fused_f32_tc_model(x, p, out_u8=out_u8)
        want = t_fused.blur_fused_f32_ref(x, p, out_u8=out_u8)
        d = float((got.double() - want.double()).abs().max())
        assert d <= (1 if out_u8 else _limit(x))
    if axis == "cols":
        r = cols.col.support_radius
        xp = _case_input((shape[0] + 2 * r, shape[1]), kind, seed=8)
        got = t_fused.blur_fused_f32_tc_model(xp, cols, pre_padded_col=True)
        want = t_fused.blur_fused_f32_ref(xp, cols, pre_padded_col=True)
        assert float((got - want).abs().max()) <= _limit(xp)


JAX_CASES = [
    ("sigma3", ((40, 200), 3.0), (16, 128)),
    ("sigma2x50", ((48, 300), (2.0, 50.0)), (48, 128)),
    ("asymmetric-signed", ((40, 200), ASYM_ROW, ASYM_COL), (40, 128)),
    ("ragged", ((41, 199), 5.0), (24, 128)),
]


@pytest.mark.parametrize("dtype", ["f32", "u8"])
@pytest.mark.parametrize("name, spec, tile", JAX_CASES, ids=[c[0] for c in JAX_CASES])
def test_tc_model_against_jax_blocked_kernel(monkeypatch, name, spec, tile, dtype):
    """JAX K2 ``_kernel`` (bf16x3 branch) in interpret mode, as
    ``test_plain_k2_against_jax_blocked_kernel`` runs it, at its limits: 2e-3
    at 0..255 scale times the taps' gain (f32), 1 count (uint8)."""
    monkeypatch.setattr(j_fused, "_FORCE_INTERPRET", True)
    if len(spec) == 2:
        shape, sigma = spec
        plan, jplan = t_plan.make_plan(shape, sigma), j_plan.make_plan(shape, sigma)
    else:
        shape, tr, tc = spec
        plan = t_plan.make_custom_plan(shape, tr, tc)
        jplan = j_plan.make_custom_plan(shape, tr, tc)
    rng = np.random.default_rng(len(name))
    x = rng.random((2, *shape)) * 255
    x = x.astype(np.float32) if dtype == "f32" else x.astype(np.uint8)
    out_u8 = dtype == "u8"
    want = np.asarray(j_fused._blur_fused_planar(
        jnp.asarray(x), jplan, tile, "bf16x3", out_u8=out_u8))
    got = t_fused.blur_fused_f32_tc_model(torch.from_numpy(x), plan, out_u8=out_u8).numpy()
    if out_u8:
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    else:
        gain = max(1.0, float(np.abs(plan.row.taps).sum() * np.abs(plan.col.taps).sum()))
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-3 * gain)


# ---------------------------------------------------------------------------
# a NumPy emulation of the kernels' tiling (csrc/fused_blur.cu)

NB, ITEM_N, THREADS, WARPS = 4, 32, 256, 8
FOLD = 4  # groups of NB steps a fold of mid into tot
ROWS_LINES, ROWS_OUT = 16, 256
COLS_LINES, COLS_OUT = 32, 128
COLS_PITCH = COLS_LINES + 8
DEPTH = 2  # window buffers of the single-axis form
LANE = np.arange(32)
GL, TIG = LANE >> 2, LANE & 3


def _line_pitch(n):
    p = (n + 3) & ~3
    return p if p & 7 else p + 4


def _chunk_steps(steps, cap):
    return min((steps + NB - 1) // NB * NB, cap)


def _reflect101(i, n):
    i = np.abs(i)
    i = np.where(i > n - 1, 2 * (n - 1) - i, i)
    return np.clip(i, 0, n - 1)


def _src_row(i, h, r, xh, pre):
    return np.minimum(i + r, xh - 1) if pre else _reflect101(i, h)


def _mma(d, a, b0, b1):
    """d (32 x 4) += A B, fragments per lane; the product exact, the sum
    rounded to f32 (the tensor core's own rounding is not modelled)."""
    A = np.zeros((16, 8))
    A[GL, TIG], A[GL + 8, TIG], A[GL, TIG + 4], A[GL + 8, TIG + 4] = a[:, 0], a[:, 1], a[:, 2], a[:, 3]
    B = np.zeros((8, 8))
    B[TIG, GL], B[TIG + 4, GL] = b0, b1
    D = np.zeros((16, 8))
    D[GL, 2 * TIG], D[GL, 2 * TIG + 1] = d[:, 0], d[:, 1]
    D[GL + 8, 2 * TIG], D[GL + 8, 2 * TIG + 1] = d[:, 2], d[:, 3]
    D = (D + A @ B).astype(np.float32).astype(np.float64)
    return np.stack([D[GL, 2 * TIG], D[GL, 2 * TIG + 1], D[GL + 8, 2 * TIG],
                     D[GL + 8, 2 * TIG + 1]], axis=1)


class _Band:
    def __init__(self):
        self.tot = np.zeros((NB, 32, 4))
        self.mid = np.zeros((NB, 32, 4))
        self.low = np.zeros((NB, 32, 4))
        self.hi = [None] * NB
        self.lo = [None] * NB

    def out(self, b, q):
        f32 = np.float32
        return ((f32(self.tot[b][:, q]) + f32(self.mid[b][:, q])).astype(f32)
                + f32(self.low[b][:, q])).astype(f32)


def _load_a(smem, p, sm8, sk4, kLo):
    v = np.stack([smem[p], smem[p + sm8], smem[p + sk4], smem[p + sm8 + sk4]], axis=1)
    v = v.astype(np.float32)
    hi = _tf32(v)
    lo = _tf32(v - hi) if kLo else np.zeros_like(hi)
    return hi.astype(np.float64), lo.astype(np.float64)


def _band_chunk(st, smem, a, sm, sk, tb, tlen, s0, s1, kLo):
    """band_chunk: a and tb are per-lane indices into smem."""
    sm8, sk4, sk8 = 8 * sm, 4 * sk, 8 * sk
    f32 = np.float32
    if s0 == 0:
        st.tot[:] = 0.0
        st.mid[:] = 0.0
        st.low[:] = 0.0
        for b in range(NB - 1):
            st.hi[b], st.lo[b] = _load_a(smem, a + b * sk8, sm8, sk4, kLo)
    for sg in range(s0, s1, NB):
        for j in range(NB):
            s = sg + j
            if s >= s1:
                continue
            slot_in = (j + NB - 1) % NB
            st.hi[slot_in], st.lo[slot_in] = _load_a(smem, a + (s - s0 + NB - 1) * sk8, sm8,
                                                     sk4, kLo)
            th0, th1 = smem[tb + 8 * s], smem[tb + 8 * s + 4]
            tl0, tl1 = smem[tb + tlen + 8 * s], smem[tb + tlen + 8 * s + 4]
            for b in range(NB):
                slot = (j + b) % NB
                step = _mma(np.zeros((32, 4)), st.hi[slot], th0, th1)
                st.low[b] = _mma(st.low[b], st.hi[slot], tl0, tl1)
                if kLo:
                    st.low[b] = _mma(st.low[b], st.lo[slot], th0, th1)
                st.mid[b] = (st.mid[b].astype(f32) + step.astype(f32)).astype(np.float64)
        if (sg // NB) % FOLD == FOLD - 1:
            st.tot = (st.tot.astype(f32) + st.mid.astype(f32)).astype(np.float64)
            st.mid[:] = 0.0


def _stage4(smem, dst, row, c, w, vec, reflect):
    if vec and c >= 0 and c + 4 <= w:
        smem[dst : dst + 4] = row[c : c + 4]
    else:
        cc = _reflect101(np.arange(c, c + 4), w) if reflect else np.minimum(np.arange(c, c + 4), w - 1)
        smem[dst : dst + 4] = row[cc]


def _stage_lines(smem, dst, pitch, nl, nslots, xp, w, c0, row0, h, r, xh, pre, vec):
    for k in range(nl * nslots):
        l, q = divmod(k, nslots)
        row = xp[int(_src_row(row0 + l, h, r, xh, pre))]
        _stage4(smem, dst + l * pitch + 4 * q, row, c0 + 4 * q, w, vec, True)


def _stage_rows(smem, dst, np_, xp, w, j0, row0, h, r, xh, pre, vec):
    for k in range(np_ * (COLS_LINES // 4)):
        p, q = divmod(k, COLS_LINES // 4)
        row = xp[int(_src_row(row0 + p, h, r, xh, pre))]
        _stage4(smem, dst + p * COLS_PITCH + 4 * q, row, j0 + 4 * q, w, vec, False)


def _axis_smem(rows, r, cs):
    n_pos = 8 * min(cs, t_fused.band_steps(r)) + (ROWS_OUT if rows else COLS_OUT) - 8
    buf = ROWS_LINES * _line_pitch(n_pos + 3) if rows else n_pos * COLS_PITCH
    return 4 * (2 * (8 * t_fused.band_steps(r) + 8) + DEPTH * buf), buf


def _emulate_axis(x, table, r, axis, pre, cap=32, grid=3):
    """launch_axis and fused_axis_kernel: ``grid`` persistent blocks, each
    over its tiles and their chunks, staging DEPTH - 1 chunks ahead into
    DEPTH window buffers."""
    planes, xh, w = x.shape
    h = xh - 2 * r if pre else xh
    rows = axis == 1
    kLo = x.dtype == np.float32
    vec = w % 4 == 0
    steps, tlen = t_fused.band_steps(r), table.shape[0] // 2
    cs = _chunk_steps(steps, cap)
    _, buf = _axis_smem(rows, r, cs)
    nchunks = -(-steps // cs)
    lines, n_out = (ROWS_LINES, ROWS_OUT) if rows else (COLS_LINES, COLS_OUT)
    pitch = buf // lines if rows else COLS_PITCH
    tiles_w = -(-w // (n_out if rows else lines))
    tiles = tiles_w * -(-h // (lines if rows else n_out))
    work = planes * tiles
    out = np.full((planes, h, w), np.nan, np.float32)
    cg, lgroups = n_out // ITEM_N, lines // 16

    def origin(t):
        i0 = (t // tiles_w) * (lines if rows else n_out)
        j0 = (t % tiles_w) * (n_out if rows else lines)
        return i0, j0

    def stage(smem, tile, c, dst):
        if tile >= work:
            return
        plane = tile // tiles
        i0, j0 = origin(tile - plane * tiles)
        c0 = c * cs
        n_pos = 8 * (min(c0 + cs, steps) - c0) + n_out - 8
        xp = x[plane].astype(np.float32)
        if rows:
            jb = j0 - r + 8 * c0
            delta = jb & 3
            _stage_lines(smem, dst, pitch, lines, (n_pos + delta + 3) // 4, xp, w,
                         jb - delta, i0, h, 0, h, 0, vec)
        else:
            _stage_rows(smem, dst, n_pos, xp, w, j0, i0 - r + 8 * c0, h, r, xh, pre, vec)

    def advance(t, c):
        return (t, c + 1) if c + 1 < nchunks else (t + grid, 0)

    for blk in range(min(work, grid)):
        smem = np.full(2 * tlen + DEPTH * buf, np.nan, np.float32)
        smem[: 2 * tlen] = table
        s_w = 2 * tlen
        bands = [_Band() for _ in range(WARPS)]
        stile, sc = blk, 0
        for d in range(DEPTH - 1):
            stage(smem, stile, sc, s_w + d * buf)
            stile, sc = advance(stile, sc)
        tile, c, k = blk, 0, 0
        while tile < work:
            stage(smem, stile, sc, s_w + ((k + DEPTH - 1) % DEPTH) * buf)
            stile, sc = advance(stile, sc)
            cur = s_w + (k % DEPTH) * buf
            plane = tile // tiles
            i0, j0 = origin(tile - plane * tiles)
            c0, c1 = c * cs, min(c * cs + cs, steps)
            for warp in range(WARPS):
                lg, og = (warp // cg, warp % cg) if rows else (warp % lgroups, warp // lgroups)
                if rows:
                    delta = (j0 - r + 8 * c0) & 3
                    a = cur + (16 * lg + GL) * pitch + delta + og * ITEM_N + TIG
                    _band_chunk(bands[warp], smem, a, pitch, 1, 7 + TIG - GL, tlen, c0, c1, kLo)
                else:
                    a = cur + (og * ITEM_N + TIG) * COLS_PITCH + 16 * lg + GL
                    _band_chunk(bands[warp], smem, a, 1, COLS_PITCH, 7 + TIG - GL, tlen, c0, c1,
                                kLo)
            if c1 == steps:
                for warp in range(WARPS):
                    lg, og = (warp // cg, warp % cg) if rows else (warp % lgroups, warp // lgroups)
                    for hv in range(2):
                        line = 16 * lg + GL + 8 * hv
                        for b in range(NB):
                            o = og * ITEM_N + 8 * b + 2 * TIG
                            for e in range(2):
                                gi, gj = (i0 + line, j0 + o + e) if rows else (i0 + o + e, j0 + line)
                                ok = (gi < h) & (gj < w)
                                out[plane, gi[ok], gj[ok]] = bands[warp].out(b, 2 * hv + e)[ok]
            (tile, c), k = advance(tile, c), k + 1
    return out


def _geometry(th, tw, g, cap, rh, rw):
    cs = _chunk_steps(t_fused.band_steps(rw), cap)
    px = _line_pitch(8 * min(cs, t_fused.band_steps(rw)) + tw - 8 + 3) if rw else 0
    hp = th + 8 * t_fused.band_steps(rh) - 8
    smem = 4 * (2 * (8 * t_fused.band_steps(rw) + 8) + 2 * (8 * t_fused.band_steps(rh) + 8)
                + hp * (tw + 8) + (g * px if rw else 0))
    return dict(th=th, tw=tw, g=g, cs=cs, px=px, hp=hp, smem=smem)


def _pick_geometry(rh, rw, limit=232448, budget=233472 // 2 - 1024):
    one = _geometry(128, 64, (128 + 8 * t_fused.band_steps(rh) - 8 + 15) & ~15, 32, rh, rw)
    if one["cs"] >= t_fused.band_steps(rw) and one["smem"] <= budget:
        return one
    for tw in (64, 32):
        for th in (128, 64, 32):
            for g in (64, 32, 16):
                cap = 32
                while cap >= NB:
                    geo = _geometry(th, tw, g, cap, rh, rw)
                    if geo["smem"] <= limit:
                        return geo
                    cap //= 2
    return _geometry(32, 32, 16, NB, rh, rw)


def _emulate_k2(x, tab_row, tab_col, rh, rw, pre, geo):
    """fused_blur_f32_kernel at the geometry ``geo``, a block a tile."""
    planes, xh, w = x.shape
    h = xh - 2 * rh if pre else xh
    kLo = x.dtype == np.float32
    vec = w % 4 == 0
    th, tw, g, cs, px = (geo[k] for k in ("th", "tw", "g", "cs", "px"))
    lw, lh = tab_row.shape[0] // 2, tab_col.shape[0] // 2
    sw, sh = t_fused.band_steps(rw), t_fused.band_steps(rh)
    py, hp = tw + 8, th + 8 * sh - 8
    out = np.full((planes, h, w), np.nan, np.float32)
    tiles_w = -(-w // tw)
    cgroups = tw // ITEM_N
    for plane in range(planes):
        xp = x[plane].astype(np.float32)
        for blk in range(tiles_w * -(-h // th)):
            i0, j0 = (blk // tiles_w) * th, (blk % tiles_w) * tw
            smem = np.full(2 * lw + 2 * lh + hp * py + g * px, np.nan, np.float32)
            smem[: 2 * lw], smem[2 * lw : 2 * lw + 2 * lh] = tab_row, tab_col
            s_tc, s_y = 2 * lw, 2 * lw + 2 * lh
            s_x = s_y + hp * py
            jb = j0 - rw
            if rw == 0:
                for i in range(hp):
                    gi = int(_src_row(i0 - rh + i, h, rh, xh, pre))
                    smem[s_y + i * py : s_y + i * py + tw] = xp[gi, np.minimum(j0 + np.arange(tw), w - 1)]
            else:
                for g0 in range(0, hp, g):
                    # one chunk: the warps loop over the group's items
                    items = (-(-min(g, hp - g0) // 16) if cs >= sw else g // 16) * cgroups
                    bands = [_Band() for _ in range(items)]
                    for c0 in range(0, sw, cs):
                        c1 = min(c0 + cs, sw)
                        delta = (jb + 8 * c0) & 3
                        n_pos = 8 * (c1 - c0) + tw - 8
                        _stage_lines(smem, s_x, px, min(g, hp - g0), (n_pos + delta + 3) // 4, xp,
                                     w, jb + 8 * c0 - delta, i0 - rh + g0, h, rh, xh, pre, vec)
                        for warp in range(items):
                            lg, og = warp // cgroups, warp % cgroups
                            a = s_x + (16 * lg + GL) * px + delta + og * ITEM_N + TIG
                            _band_chunk(bands[warp], smem, a, px, 1, 7 + TIG - GL, lw, c0, c1, kLo)
                    for warp in range(items):
                        lg, og = warp // cgroups, warp % cgroups
                        for hv in range(2):
                            i = g0 + 16 * lg + GL + 8 * hv
                            for b in range(NB):
                                c = og * ITEM_N + 8 * b + 2 * TIG
                                for e in range(2):
                                    ok = i < hp
                                    smem[(s_y + i * py + c + e)[ok]] = bands[warp].out(b, 2 * hv + e)[ok]
            if rh == 0:
                for i in range(min(th, h - i0)):
                    n = min(tw, w - j0)
                    out[plane, i0 + i, j0 : j0 + n] = smem[s_y + i * py : s_y + i * py + n]
                continue
            lgroups = tw // 16
            for it in range(lgroups * (th // ITEM_N)):
                lg, og = it % lgroups, it // lgroups
                st = _Band()
                _band_chunk(st, smem, s_y + (og * ITEM_N + TIG) * py + 16 * lg + GL, 1, py,
                            s_tc + 7 + TIG - GL, lh, 0, sh, True)
                for hv in range(2):
                    gj = j0 + 16 * lg + GL + 8 * hv
                    for b in range(NB):
                        for e in range(2):
                            gi = i0 + og * ITEM_N + 8 * b + 2 * TIG + e
                            ok = (gi < h) & (gj < w)
                            out[plane, gi[ok], gj[ok]] = st.out(b, 2 * hv + e)[ok]
    return out


@pytest.mark.parametrize("axis", [1, 0], ids=["rows", "cols"])
@pytest.mark.parametrize("shape, r, kind, pre, cap", [
    ((40, 300), 5, "f32", False, 32),
    ((37, 263), 21, "u8", False, 32),
    ((150, 300), 70, "f32", False, 8),     # chunks of 8 steps: the ring and a fold across
    ((45, 150), 9, "f32", True, 8),        # pre-padded cols (rows ignore it)
], ids=["r5", "r21-u8-ragged", "r70-chunked", "r9-pre"])
def test_single_axis_tiling_emulation_matches_the_model(axis, shape, r, kind, pre, cap):
    rng = np.random.default_rng(r)
    taps = (rng.random(2 * r + 1) + 0.1).astype(np.float32)
    taps /= taps.sum()
    h, w = shape
    pre = pre and axis == 0
    xh = h + 2 * r if pre else h
    x = _case_input((xh, w), kind, seed=r).numpy()
    got = _emulate_axis(x, t_fused.tc_table(taps), r, axis, pre, cap)
    tp = [1.0]
    plan = (t_plan.make_custom_plan(shape, list(taps), tp) if axis == 1
            else t_plan.make_custom_plan(shape, tp, list(taps)))
    want = t_fused.blur_fused_f32_tc_model(torch.from_numpy(x), plan, pre_padded_col=pre).numpy()
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=_limit(torch.from_numpy(x)) / 10)


@pytest.mark.parametrize("shape, rh, rw, kind, pre, geo", [
    ((70, 100), 6, 9, "f32", False, None),  # one group
    ((60, 90), 5, 3, "u8", True, None),     # one group, pre-padded
    ((50, 90), 3, 0, "f32", True, None),    # radius-0 rows: a copy
    ((45, 70), 0, 4, "u8", False, None),     # radius-0 cols: a copy
    ((80, 70), 11, 13, "f32", True, (32, 32, 16, 4)),  # small tiles, chunked rows pass
    ((60, 140), 20, 5, "u8", False, (64, 64, 32, 8)),
], ids=["auto", "one-group-pre-u8", "row-radius-0-pre", "col-radius-0-u8", "small-tiles-pre",
        "g32-u8"])
def test_k2_tiling_emulation_matches_the_model(shape, rh, rw, kind, pre, geo):
    rng = np.random.default_rng(rh * 31 + rw)
    tr, tc = (rng.random(2 * r + 1).astype(np.float32) - 0.2 if r else np.ones(1, np.float32)
              for r in (rw, rh))
    h, w = shape
    x = _case_input((h + 2 * rh if pre else h, w), kind, seed=rh + rw, planes=1).numpy()
    g = _pick_geometry(rh, rw) if geo is None else _geometry(*geo, rh, rw)
    got = _emulate_k2(x, t_fused.tc_table(tr), t_fused.tc_table(tc), rh, rw, pre, g)
    plan = t_plan.make_custom_plan(shape, list(tr), list(tc))
    want = t_fused.blur_fused_f32_tc_model(torch.from_numpy(x), plan, pre_padded_col=pre).numpy()
    assert not np.isnan(got).any()
    gain = float(np.abs(tr).sum() * np.abs(tc).sum())
    np.testing.assert_allclose(got, want, rtol=0, atol=gain * _limit(torch.from_numpy(x)) / 10)
    if rw == 0 or rh == 0:  # the copy axis adds no rounding of its own
        ref = t_fused.blur_fused_f32_ref(torch.from_numpy(x), plan, pre_padded_col=pre).numpy()
        assert np.abs(got - ref).max() <= gain * _limit(torch.from_numpy(x))


def test_k2_geometry_fits_the_card_at_every_radius():
    """pick_geometry's choice fits 227 KB up to r 600 on both axes, keeps th
    128, tw 64 and 8 rows-pass items at sigma 10 (r 32), and to r 16 stages
    a 128 x 64 tile's whole window in one group, two blocks an SM."""
    geo = _pick_geometry(32, 32)
    assert (geo["th"], geo["tw"], geo["g"]) == (128, 64, 64)
    for r in (2, 7, 14, 16):
        geo = _pick_geometry(r, r)
        assert (geo["th"], geo["tw"]) == (128, 64)
        assert geo["g"] >= geo["hp"] and geo["smem"] <= 233472 // 2 - 1024
    for r in (0, 1, 32, 100, 165, 332, 598, 600):
        for rw in (0, r):
            assert _pick_geometry(r, rw)["smem"] <= 232448


# ---------------------------------------------------------------------------
# the float split radius the H100's phase 13 sweep set (utils/hw.py)

H100_SPLIT_MIN = 19  # utils/hw._MEASURED_SPLIT_MIN["NVIDIA H100 80GB HBM3"]


def _h100_spec(monkeypatch):
    from blur_algorithms_tpu_torch import api
    from blur_algorithms_tpu_torch.utils import hw

    spec = hw.spec_for("NVIDIA H100 80GB HBM3", 132, 232448, 80 << 30)
    for mod in (api, t_fused):
        monkeypatch.setattr(mod, "device_spec", lambda device: spec)
    return spec


def _radius_sigmas():
    """The sigma of the largest 4K support radius under the split radius
    and of the split radius itself (chip_smoke.py's SPLIT_SWEEP_SIGMAS)."""
    by_r = {t_plan.make_plan((2160, 3840), s).row.support_radius: s
            for s in (1.0, 1.5, 2.5, 3.5, 4.0, 5.0, 6.0, 7.5, 9.0, 10.0)}
    return by_r[max(r for r in by_r if r < H100_SPLIT_MIN)], by_r[H100_SPLIT_MIN]


def test_float_split_radius_on_the_h100(monkeypatch):
    """With K2 and its single-axis form on 3xTF32, the float path splits
    from the H100's swept radius: K2 under it, the split from it, for float
    planes and K2's uint8 path (the bf16x3 rung); K1's uint8 path keeps its
    own radius (82)."""
    spec = _h100_spec(monkeypatch)
    assert (spec.fused_split_min_radius, spec.fused_split_min_radius_u8) == (H100_SPLIT_MIN, 82)
    below, at = (t_plan.make_plan((2160, 3840), s) for s in _radius_sigmas())
    assert not t_fused._split_wins(below, 4, "bf16x3", "cpu")
    assert t_fused._split_wins(at, 4, "bf16x3", "cpu")
    assert t_fused._split_wins(at, 1, "bf16x3", "cpu")
    assert not t_fused._split_wins(at, 1, "int8", "cpu")


@pytest.mark.parametrize("which", ["below", "at"])
def test_blur_auto_splits_from_the_h100_float_radius(monkeypatch, which):
    from blur_algorithms_tpu_torch import blur

    _h100_spec(monkeypatch)
    sigma = dict(zip(("below", "at"), _radius_sigmas()))[which]
    ran = []
    real_k2, real_split = t_fused.blur_fused_f32, t_fused._blur_fused_split

    def k2(*args, **kw):
        ran.append("K2")
        return real_k2(*args, **kw)

    def split(*args, **kw):
        ran.append("split")
        return real_split(*args, **kw)

    monkeypatch.setattr(t_fused, "blur_fused_f32", k2)
    monkeypatch.setattr(t_fused, "_blur_fused_split", split)
    x = _f32((2, 3, 96, 128), 255.0, seed=5)
    got = blur(x, sigma)
    assert ran == (["K2"] if which == "below" else ["split"])
    plan = t_plan.make_plan((96, 128), sigma)
    want = t_fused.blur_fused_f32_ref(x, plan)
    assert float((got - want).abs().max()) <= _limit(x)
