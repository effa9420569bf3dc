"""A CPU model of the tiling of K1's tensor-core bodies.

``csrc/fused_dma.cu`` runs K1's int8 and hybrid bodies, in all five staging
forms, as band products on the card's tensor cores; no card is needed to
check how they cut the work:

- the rows pass (``rows_mma``, both bodies): the shifted tap copies the
  kernel builds in shared memory (``tap_copies``, after (-rw) mod 16
  leading zeros in the direct, strip and resident forms, none in the
  assembled ones), the A fragments each lane loads from them
  (``mma.m16n8k32``, 16 output columns x 32 window columns a k-step),
  checked against the band ``q[32s + k - m]``, multiplied out exactly
  (every partial sum an integer below 2^53) against the raw bytes the
  direct loader stages (``load_window``: 16-byte segments inside the row,
  mirrored aligned words past its edges, reflect-101 bytes elsewhere), and
  recentred by the one subtraction of 128 Q: equal to ``int8_rows_ref`` at
  r 1..600, on ragged frames and frames narrower than 2r + 1;
- the int8 cols pass (``cols_int8_mma``): the fragments of two 16-row
  blocks over the column-major digit planes, the third 16-row matrix
  carried to the next step, against the column taps' band: the three digit
  products equal ``int8_cols_ref``'s (rows past the window hold garbage,
  which only zero taps meet), and the whole int8 pipeline of the model
  equals ``blur_fused_u8_dma_ref`` bit for bit in both stores;
- the hybrid cols pass (``cols_hybrid_mma``): the bf16 tap groups and the
  B fragments each lane loads (``mma.m16n8k16``), checked against the
  block-Toeplitz ``c[16 (s - n) + k]``; the rows the fragments read: every
  tap of every output row once, in the aligned groups of 16 of its own tap
  index, ascending, the same in every form's tile, the strip's windows,
  K1r's ring steps and at a shard origin; and a float64 model of that
  grouped sum rounded to f32 once a group within 2e-2 at 0..255 scale (1
  count on the uint8 store) of ``blur_fused_u8_hybrid_ref`` and of the JAX
  ``_tile_hybrid`` run in interpret mode;
- the layout (``tc_layout``): ldmatrix rows on eight bank groups, the
  planes deep enough for every row a fragment reads, and the direct form
  serving every radius K1 takes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from blur_algorithms_tpu.ops.plan import make_plan as j_make_plan  # noqa: E402
from blur_algorithms_tpu.pallas_kernels import fused_dma as j_dma  # noqa: E402
from blur_algorithms_tpu_torch import make_plan  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fused_dma as t_dma  # noqa: E402
from blur_algorithms_tpu_torch.ops.pad import reflect_101  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the plain versions sum tap by tap in small
    torch ops, which beside the suite's other workers wait on one another."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


HYBRID_TOL = 2e-2  # the f32 store at 0..255 scale; the uint8 store: 1 count
FORMS = ("direct", "strip", "assembled", "resident")


def _frames(planes, shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(planes, *shape), dtype=np.uint8)


def _reflect101(i, n):
    """The kernels' reflect-101 index math: one reflection, then a clamp."""
    i = np.abs(i)
    i = np.where(i > n - 1, 2 * (n - 1) - i, i)
    return np.clip(i, 0, n - 1)


def _lay(form, rung, plan, th, tw, slots=2):
    return t_dma.tc_layout(form, rung, th, tw, plan.col.support_radius,
                           plan.row.support_radius, slots)


# ---------------------------------------------------------------------------
# the shifted tap copies and the int8 A fragments


def _table(plan, rung, framed):
    """``tc_tables``'s words as uint32, split as ``tc_carve`` reads them:
    (qoff, rows copies (2, 4, rwords), the cols part)."""
    rh, rw = plan.col.support_radius, plan.row.support_radius
    lay = t_dma.tc_layout("assembled" if framed else "direct", rung, 16, 64, rh, rw, 2)
    words = t_dma.tc_tables(plan, rung, framed).numpy().view(np.uint32)
    assert words.size * 4 == lay.taps and not words[1:4].any()
    rq = words[4 : 4 + 8 * lay.rwords].reshape(2, 4, lay.rwords)
    return int(words[0]), rq, words[4 + 8 * lay.rwords :], lay


def _a_fragments(copies, steps):
    """``(digit, step, 16, 32)``: the A matrices the lanes' four registers
    hold (m16n8k32: register j of lane (g, tig) holds row g (+8 for j odd),
    columns 4 tig (+16 for j >= 2) .. + 3), read where ``rows_mma`` and
    ``cols_int8_mma`` read them: copy (16 + 4 tig - g) mod 4, words 8s +
    (16 + 4 tig - g) // 4 + (0, -2, 4, 2)."""
    a = np.zeros((2, steps, 16, 32), np.int64)
    s = np.arange(steps)
    for lane in range(32):
        g, tig = lane >> 2, lane & 3
        b0 = 4 * tig - g + 16
        for m, k0, dw in ((g, 4 * tig, 0), (g + 8, 4 * tig, -2),
                          (g, 4 * tig + 16, 4), (g + 8, 4 * tig + 16, 2)):
            words = copies[:, b0 & 3, (b0 >> 2) + 8 * s + dw]  # (digit, step)
            for i in range(4):
                byte = ((words >> np.uint64(8 * i)) & np.uint64(0xFF)).astype(np.int64)
                a[:, :, m, k0 + i] = np.where(byte >= 128, byte - 256, byte)
    return a


def _band(q, delta, steps):
    """``(digit, step, 16, 32)``: the band ``q'[32s + k - m]``, ``q'`` the
    digit taps after delta leading zeros."""
    s, m, k = np.ogrid[:steps, :16, :32]
    t = 32 * s + k - m - delta
    ok = (t >= 0) & (t < q.size)
    return np.stack([np.where(ok, d[np.clip(t, 0, q.size - 1)], 0)
                     for d in (q >> 7, q & 127)]).astype(np.int64)


def _rows_fragments(plan, rung="int8", framed=False):
    """The rows pass's A fragments from the host's table, checked against
    the band of the rows taps; and the table's recentring 128 Q."""
    qoff, rq, _, lay = _table(plan, rung, framed)
    q = t_dma.int8_operands(plan).q_row.astype(np.int64)
    a = _a_fragments(rq, lay.rsteps)
    assert np.array_equal(a, _band(q, lay.delta, lay.rsteps))
    assert qoff == (128 * (128 * int((q >> 7).sum()) + int((q & 127).sum()))) % (1 << 32)
    return a, qoff


def _cols_fragments(plan):
    """The int8 cols pass's A fragments from the host's table, checked
    against the band of the column taps."""
    _, _, cq, lay = _table(plan, "int8", False)
    q = t_dma.int8_operands(plan).q_col.astype(np.int64)
    a = _a_fragments(cq[: 8 * lay.cwords].reshape(2, 4, lay.cwords), lay.csteps)
    assert np.array_equal(a, _band(q, 0, lay.csteps))
    return a


# ---------------------------------------------------------------------------
# the direct form's loader and the rows pass


def _byte_perm(a, b, sel):
    """``__byte_perm(a, b, sel)``: byte i of the result is byte
    ``(sel >> 4i) & 7`` of the pair (a low, b high)."""
    pair = int(a) | (int(b) << 32)
    return sum(((pair >> (8 * ((sel >> (4 * i)) & 7))) & 0xFF) << (8 * i) for i in range(4))


def _words(row, at):
    """The aligned uint4 at byte ``at`` of a row, as four little-endian words."""
    return [int.from_bytes(bytes(row[at + 4 * q : at + 4 * q + 4]), "little") for q in range(4)]


def _segment(row, gc, w, vec):
    """``load_window``'s 16 bytes from image column gc of one row."""
    if vec and gc >= 0 and gc + 16 <= w:
        return row[gc : gc + 16]
    if vec and gc < 0 and gc >= 16 - w:
        a, b = _words(row, -gc - 16), _words(row, -gc)
        q = [_byte_perm(a[3], b[0], 0x1234), _byte_perm(a[2], a[3], 0x1234),
             _byte_perm(a[1], a[2], 0x1234), _byte_perm(a[0], a[1], 0x1234)]
    elif vec and w <= gc <= 2 * w - 32:
        a, b = _words(row, 2 * w - 32 - gc), _words(row, 2 * w - 16 - gc)
        q = [_byte_perm(b[2], b[3], 0x3456), _byte_perm(b[1], b[2], 0x3456),
             _byte_perm(b[0], b[1], 0x3456), _byte_perm(a[3], b[0], 0x3456)]
    else:
        return row[_reflect101(gc + np.arange(16), w)]
    return np.frombuffer(b"".join(v.to_bytes(4, "little") for v in q), np.uint8)


def _load_window(plane, row0, nr, gc0, sw):
    """``load_window``: window rows [0, nr) (image rows reflect-101 of row0
    + rr) x sw bytes from image column gc0, 16 bytes a segment."""
    h, w = plane.shape
    vec = w % 16 == 0
    out = np.zeros((nr, sw), np.uint8)
    for rr in range(nr):
        row = plane[_reflect101(row0 + rr, h)]
        for c in range(0, sw, 16):
            out[rr, c : c + 16] = _segment(row, gc0 + c, w, vec)
    return out


def _rows_model(plane, plan, lay, tw, row0, nr):
    """R of the rows pass over window rows [0, nr) from image row ``row0``
    for every output column, as the direct form tiles it: per tw-column tile
    its window (``load_window`` from column j0 - rw - delta), per 16-column
    block the k-steps of 32 window columns against the A fragments, two
    digits, then R = 128 (hi - 128 Q_hi) + lo - 128 Q_lo."""
    rw = plan.row.support_radius
    a, qoff = _rows_fragments(plan)
    w = plane.shape[1]
    r = np.zeros((nr, -(-w // tw) * tw), np.int64)
    for j0 in range(0, w, tw):
        win = _load_window(plane, row0, nr, j0 - rw - lay.delta, lay.sw).astype(np.int64)
        for mb in range(tw // 16):
            cols = 16 * mb + 32 * np.arange(lay.rsteps)[:, None] + np.arange(32)[None, :]
            b = win[:, cols]  # (rows, step, 32): the B fragments, raw bytes
            hi, lo = np.einsum("dsmk,rsk->dmr", a, b)
            r[:, j0 + 16 * mb : j0 + 16 * mb + 16] = (128 * hi + lo - qoff).T
    # the kernel's R is exact modulo 2^32, and |R| < 2^31
    return (r[:, :w] + (1 << 31)) % (1 << 32) - (1 << 31)


ROWS_CASES = [
    # (h, w, sigma): aligned rows (the 16-byte and mirrored segments), a
    # ragged width (reflect-101 bytes), a frame narrower than 2r + 1
    (5, 256, 0.4),   # r 1
    (5, 256, 0.7),   # r 2
    (4, 320, 2.2),   # r 7
    (4, 320, 4.6),   # r 15
    (4, 320, 4.9),   # r 16
    (4, 320, 5.2),   # r 17
    (3, 272, 10.0),  # r 32
    (3, 301, 10.0),  # ragged
    (3, 48, 10.0),   # narrower than 2r + 1
    (3, 1024, 30.0),  # r 99
    (2, 1200, 100.0),  # r 332
    (2, 1312, 180.0),  # r 598
    (2, 700, 180.0),  # r 598 past one reflection
]


@pytest.mark.parametrize("h, w, sigma", ROWS_CASES)
def test_rows_fragments_times_raw_bytes_equal_the_rows_ref(h, w, sigma):
    plan = make_plan((h, w), sigma)
    rh, rw = plan.col.support_radius, plan.row.support_radius
    x = _frames(1, (h, w), seed=w + rw)
    geo = t_dma.k1_geometry("direct", "int8", plan, 1)
    lay = _lay("direct", "int8", plan, geo.th, geo.tw)
    got = _rows_model(x[0], plan, lay, geo.tw, 0, h)
    xp = reflect_101(torch.from_numpy(x), [(0, 0), (rw, rw)])
    want = t_dma.int8_rows_ref(xp, t_dma.int8_operands(plan).q_row, w)[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_assembled_rows_take_no_leading_zeros():
    """K1a's windows start at frame column j0 = image column j0 - rw, 16-byte
    aligned by A5: its taps get no leading zeros; the other forms' windows
    start at image column j0 - rw - delta, 16-byte aligned by delta = (-rw)
    mod 16 leading zeros. Either way the k-steps cover every tap of every
    output column of a 16-column block."""
    for rw in (1, 15, 16, 17, 32, 100, 600):
        for form in ("direct", "strip", "resident", "assembled", "pipelined"):
            lay = t_dma.tc_layout(form, "int8", 64, 64, 8, rw, 2)
            if form in ("assembled", "pipelined"):
                assert lay.delta == 0
            else:
                assert lay.delta == (-rw) % 16 and (rw + lay.delta) % 16 == 0
            assert 32 * lay.rsteps >= lay.delta + 2 * rw + 1 + 15
    # the host's tables carry each family's leading zeros
    for sigma in (0.7, 5.0, 10.0, 30.0):
        plan = make_plan((96, 640), sigma)
        for rung in ("int8", "hybrid"):
            for framed in (False, True):
                _rows_fragments(plan, rung, framed)


# ---------------------------------------------------------------------------
# the int8 cols pass


def _digits(e):
    e1 = (e + 64) >> 7
    return e1, e - 128 * e1


def _cols_int8_model(e, plan, lay, th, garbage_seed=0):
    """p1, p23, p4 of a tile's cols pass over column-major digit planes of
    ``e`` (int64 ``(rows, tw)``, window row 0 = output row 0's first tap) as
    ``cols_int8_mma`` runs it: per pair of 16-row blocks ib, ib + 16 and
    k-step s, A the column taps' digit band, B the digits of plane rows ib +
    32 s + (0..31) and ib + 16 + 32 s + (0..31), the matrix M0 of rows ib +
    32 s + (0..15) carried from the step before. Plane rows past ``e`` hold
    garbage (only zero taps meet them)."""
    a = _cols_fragments(plan)
    rows, tw = e.shape
    plane = np.random.default_rng(garbage_seed).integers(-128, 128, (2, lay.pr, tw))
    plane[:, :rows] = np.stack(_digits(e))
    p = np.zeros((3, -(-th // 32) * 32, tw), np.int64)
    for ib in range(0, th, 32):
        m0 = plane[:, ib : ib + 16]  # the first step's M0, loaded before the loop
        for s in range(lay.csteps):
            m1 = plane[:, ib + 32 * s + 16 : ib + 32 * s + 32]
            m2 = plane[:, ib + 32 * s + 32 : ib + 32 * s + 48]
            for blk, (lo_m, hi_m) in enumerate(((m0, m1), (m1, m2))):
                b = np.concatenate([lo_m, hi_m], axis=1)  # (digit, 32, tw)
                ah, al = a[0, s], a[1, s]
                rows_out = slice(ib + 16 * blk, ib + 16 * blk + 16)
                p[0, rows_out] += ah @ b[0]
                p[1, rows_out] += ah @ b[1] + al @ b[0]
                p[2, rows_out] += al @ b[1]
            m0 = m2
    return p[:, :th]


def _epilogue(p, consts, out_u8):
    """``int8_cols_ref``'s epilogue of the three digit sums."""
    p1, p23, p4 = (torch.from_numpy(v).to(torch.int32) for v in p)
    c1, c2, c3 = consts
    y = torch.mul(p1.to(torch.float32), c1)
    if out_u8:
        y = torch.add(y, torch.mul(p23.to(torch.float32), c2))
        y = torch.add(y, torch.mul(p4.to(torch.float32), c3))
        return t_dma.store_u8_ref(torch.add(y, 128.0))
    y = t_dma.fma_f32_ref(p23.to(torch.float32), c2, y)
    return torch.add(t_dma.fma_f32_ref(p4.to(torch.float32), c3, y), 128.0)


COLS_CASES = [
    (40, 96, 1.0),    # r 3
    (70, 128, 5.0),   # r 17
    (301, 128, 10.0),  # r 32, a ragged last tile
    (96, 64, (12.0, 2.0)),  # rh 39 past the frame's height... anisotropic
    (200, 64, (60.0, 1.0)),  # rh 199 over a short frame
]


@pytest.mark.parametrize("h, w, sigma", COLS_CASES)
@pytest.mark.parametrize("out_u8", [True, False])
def test_int8_pipeline_model_equals_the_plain_version(h, w, sigma, out_u8):
    plan = make_plan((h, w), sigma)
    rh = plan.col.support_radius
    ops = t_dma.int8_operands(plan)
    x = _frames(1, (h, w), seed=h + rh)
    geo = t_dma.k1_geometry("direct", "int8", plan, 1)
    lay = _lay("direct", "int8", plan, geo.th, geo.tw)
    out = np.zeros((h, -(-w // geo.tw) * geo.tw), np.uint8 if out_u8 else np.float32)
    s = ops.rows_shift
    for i0 in range(0, h, geo.th):
        r = _rows_model(x[0], plan, lay, geo.tw, i0 - rh, lay.rows)
        e = (r + (1 << (s - 1))) >> s
        for j0 in range(0, w, geo.tw):
            tile = e[:, j0 : j0 + geo.tw]
            if tile.shape[1] < geo.tw:  # the last window's columns past w
                tile = np.pad(tile, ((0, 0), (0, geo.tw - tile.shape[1])))
            p = _cols_int8_model(tile, plan, lay, geo.th, garbage_seed=i0 + j0)
            n = min(geo.th, h - i0)
            out[i0 : i0 + n, j0 : j0 + geo.tw] = _epilogue(
                p[:, :n], ops.epilogue_constants(), out_u8).numpy()
    want = t_dma.blur_fused_u8_dma_ref(torch.from_numpy(x), plan, out_u8)[0].numpy()
    np.testing.assert_array_equal(out[:, :w], want)


def test_int8_cols_products_equal_the_cols_ref_sums():
    """The three digit sums themselves, at a column radius past the tile
    (rh 199 over 64 rows), against the taps' digits dotted row by row."""
    plan = make_plan((64, 32), (60.0, 1.0))
    rh = plan.col.support_radius
    q = t_dma.int8_operands(plan).q_col
    lay = _lay("direct", "int8", plan, 64, 32)
    e = np.random.default_rng(3).integers(-9000, 9000, (64 + 2 * rh, 32))
    p = _cols_int8_model(e, plan, lay, 64, garbage_seed=9)
    e1, e0 = _digits(e)
    idx = np.arange(64)[:, None] + np.arange(2 * rh + 1)[None, :]
    b_hi, b_lo = q >> 7, q & 127
    want = [np.einsum("t,itc->ic", b_hi, e1[idx]),
            np.einsum("t,itc->ic", b_hi, e0[idx]) + np.einsum("t,itc->ic", b_lo, e1[idx]),
            np.einsum("t,itc->ic", b_lo, e0[idx])]
    np.testing.assert_array_equal(p, np.stack(want))


# ---------------------------------------------------------------------------
# the hybrid cols pass


def _b_fragments(table, steps):
    """``(step, 16, 8)``: the B matrices the lanes' two registers hold
    (m16n8k16: register j of lane (g, tig) holds rows 2 tig, 2 tig + 1 (+8
    for j = 1) of column g), read at words 12 (s - g + 7) + tig (+4)."""
    b = np.zeros((steps, 16, 8), np.int64)
    for lane in range(32):
        g, tig = lane >> 2, lane & 3
        for s in range(steps):
            for j in range(2):
                word = table[s - g + 7, tig + 4 * j]
                b[s, 2 * tig + 8 * j, g] = word & 0xFFFF
                b[s, 2 * tig + 8 * j + 1, g] = word >> 16
    return b


@pytest.mark.parametrize("sigma", [0.6, 2.1, 2.4, 10.0, 30.0, 90.0])  # rh 1..299
def test_hybrid_b_fragments_are_the_block_toeplitz_taps(sigma):
    """The host's tap groups (``tc_tables`` of a hybrid plan, its cols part)
    give each lane the B fragment of ``c[16 (s - n) + k]``."""
    plan = make_plan((700, 64), (sigma, 1.0))
    rh = plan.col.support_radius
    c = t_dma.hybrid_operands(plan).c_col
    groups = -(-(2 * rh + 1) // 16)
    _, _, cq, lay = _table(plan, "hybrid", False)
    assert lay.groups == groups
    b = _b_fragments(cq[: 12 * (groups + 14)].reshape(groups + 14, 12), groups + 7)
    bits = torch.from_numpy(c).to(torch.bfloat16).view(torch.int16).numpy().astype(
        np.int64) & 0xFFFF
    s, k, n = np.ogrid[: groups + 7, :16, :8]
    t = 16 * (s - n) + k
    want = np.where((t >= 0) & (t <= 2 * rh), bits[np.clip(t, 0, 2 * rh)], 0)
    np.testing.assert_array_equal(b, want)
    # a load's 8 lanes of one tig fall on 8 banks: 12 words a group
    for tig in range(4):
        assert len({(12 * (7 - g) + tig) % 32 for g in range(8)}) == 8


def _hybrid_reads(th, rh, b0=0, ring=0):
    """Per output row of a th-row tile, the (step, lane, tap, plane row) of
    every k-step product ``cols_hybrid_mma`` gives it against a non-zero
    tap: unit (block bk, fragment pair f, f + 8), fragment row n = output row
    128 bk + f + 8 fi + 16 n, step s: A rows b0 + 128 bk + f + 8 fi + 16 s +
    k (mod ring) against taps 16 (s - n) + k."""
    groups = -(-(2 * rh + 1) // 16)
    reads = {}
    for bk in range(-(-th // 128)):
        for f in range(8):
            for fi in range(2):
                for n in range(8):
                    ii = 128 * bk + f + 8 * fi + 16 * n
                    if ii >= th:
                        continue
                    got = []
                    for s in range(groups + 7):
                        for k in range(16):
                            t = 16 * (s - n) + k
                            if 0 <= t <= 2 * rh:
                                row = b0 + 128 * bk + f + 8 * fi + 16 * s + k
                                got.append((s, k, t, row % ring if ring else row))
                    reads[ii] = got
    return reads


@pytest.mark.parametrize("rh", [1, 8, 32, 100])
def test_hybrid_grouping_is_each_rows_own_whatever_the_tile(rh):
    """Every tap of every output row is read once, at lane t mod 16 of the
    step that adds its group t // 16, the groups in ascending order, from the
    plane row of window row ii + t; the (group, lane) sequence of a row is
    the same in the direct tile, a strip window, each K1r ring step and at a
    shard origin, so the f32 sums, and the forms' results, agree bit for
    bit."""
    signature = None
    for th, b0, ring in ((256, 0, 0), (240, 0, 0), (128, 0, 0),  # direct and strip tiles
                         (128, 48, _r16(128 + 2 * rh)),  # K1r: a step's ring base
                         (128, (5 * 128) % _r16(128 + 2 * rh), _r16(128 + 2 * rh))):
        reads = _hybrid_reads(th, rh, b0, ring)
        assert sorted(reads) == list(range(th))
        for ii, got in reads.items():
            steps = [s for s, _, _, _ in got]
            assert steps == sorted(steps)
            assert [t for _, _, t, _ in got] == list(range(2 * rh + 1))
            for s, k, t, row in got:
                assert k == t % 16
                want = b0 + ii + t
                assert row == (want % ring if ring else want)
            sig = [(t // 16, k) for _, k, t, _ in got]
            signature = signature or sig
            assert sig == signature


def _r16(n):
    return (n + 15) & ~15


def _hybrid_grouped(y, c, h):
    """float64 model of the hybrid cols pass: per output row, each aligned
    group of 16 of its own taps summed exactly, the running f32 sum rounded
    once a group, in ascending group order."""
    groups = -(-c.size // 16)
    acc = np.zeros((h, y.shape[1]), np.float32)
    cf = c.astype(np.float64)
    for g in range(groups):
        t = np.arange(16 * g, min(16 * g + 16, c.size))
        part = sum(cf[k] * y[k : k + h].astype(np.float64) for k in t)
        acc = (acc.astype(np.float64) + part).astype(np.float32)
    return acc


HYBRID_CASES = [
    ((64, 96), 1.0),
    ((96, 128), 3.0),
    ((300, 96), 10.0),
    ((96, 160), (12.0, 2.0)),
]


@pytest.mark.parametrize("shape, sigma", HYBRID_CASES)
def test_hybrid_grouped_model_is_within_tolerance_of_plain_and_jax(shape, sigma):
    h, w = shape
    plan = make_plan(shape, sigma)
    rh, rw = plan.col.support_radius, plan.row.support_radius
    ops = t_dma.hybrid_operands(plan)
    x = _frames(2, shape, seed=h + w)
    xp = reflect_101(torch.from_numpy(x), [(rh, rh), (rw, rw)])
    y = t_dma.bf16_round_ref(t_dma.int8_rows_ref(xp, ops.q_row, w).to(torch.float32))
    out = []
    for p in range(2):
        acc = torch.from_numpy(_hybrid_grouped(y[p].numpy(), ops.c_col, h))
        out.append(t_dma.fma_f32_ref(acc, ops.scale, 128.0))
    model = torch.stack(out)
    plain = t_dma.blur_fused_u8_hybrid_ref(torch.from_numpy(x), plan, out_u8=False)
    assert float((model - plain).abs().max()) <= HYBRID_TOL
    plain8 = t_dma.blur_fused_u8_hybrid_ref(torch.from_numpy(x), plan)
    model8 = t_dma.store_u8_ref(model)
    assert int((model8.int() - plain8.int()).abs().max()) <= 1
    jax = np.asarray(j_dma._blur_fused_dma_impl(jnp.asarray(x), j_make_plan(shape, sigma),
                                                "hybrid", False))
    assert float(np.abs(model.numpy() - jax).max()) <= HYBRID_TOL


# ---------------------------------------------------------------------------
# the layout


@pytest.mark.parametrize("rung, form", [
    *((rung, form) for rung in ("int8", "hybrid") for form in FORMS),
    ("int8", "pipelined"),  # the pipelined variant serves int8 only
])
def test_layout_fragments_fit_and_spread_over_the_banks(rung, form):
    for r in (1, 15, 16, 33, 99, 165, 332, 598):
        plan = make_plan((2160, 3840), r / 3.32)
        geo = t_dma.k1_geometry(form, rung, plan, 12)
        if geo is None:
            # the strip's whole window, and the pipelined variant's two
            # planes at r 598, stop fitting (as before the tensor cores)
            assert form == "strip" or (form == "pipelined" and r == 598), (form, r)
            continue
        rh, rw = plan.col.support_radius, plan.row.support_radius
        lay = _lay(form, rung, plan, geo.th, geo.tw, geo.slots)
        assert lay.total == geo.smem <= t_dma.HOPPER_SMEM_OPTIN
        # ldmatrix's eight row addresses on eight 16-byte bank groups
        assert lay.sp % 16 == 0 and (lay.sp // 16) % 2 == 1
        assert lay.cs % 16 == 0 and (lay.cs // 16) % 2 == 1
        assert lay.sw >= geo.tw - 16 + 32 * lay.rsteps and lay.sw <= lay.sp
        assert lay.g % 8 == 0 and lay.rows % 16 == 0 and lay.rows >= geo.th + 2 * rh
        # every plane row a fragment reads exists (K1r reads modulo its ring)
        if form != "resident":
            if rung == "int8":
                last = -(-geo.th // 32) * 32 - 32 + 32 * lay.csteps + 15
            else:
                last = -(-geo.th // 128) * 128 - 128 + 7 + 16 * (lay.groups + 6) + 8 + 15
            assert last < lay.pr
        else:
            assert lay.pr == lay.rows
        if form in ("assembled", "pipelined"):
            nbh, nbw = -(-2160 // geo.th), -(-3840 // geo.tw)
            assert geo.hp >= (nbh - 1) * geo.th + lay.rows
            assert geo.wp >= (nbw - 1) * geo.tw + lay.sw and geo.wp % 16 == 0


def test_direct_form_serves_every_radius():
    """K1 serves support radii 1..600 in its direct form on both bodies:
    the block fits the H100's shared memory at every radius, 4K or small."""
    for shape in ((2160, 3840), (40, 48)):
        for r in (1, 2, 5, 16, 31, 64, 100, 101, 200, 400, 401, 500, 600):
            plan = make_plan(shape, (r / 3.32, r / 3.32))
            for rung in ("int8", "hybrid"):
                assert t_dma.k1_geometry("direct", rung, plan, 12) is not None, (shape, r)


# ---------------------------------------------------------------------------
# the bf16 body on the tensor cores: its rows tap table, its B bytes, and
# its grouping (rows_bf16_mma, then cols_hybrid_mma with no epilogue)


def _pi(k):
    """The window byte of k-step position k (0..15) a lane's B fragment
    reads: k = 2 tig + e from byte 4 tig + e, k = 2 tig + 8 + e from byte 4
    tig + 2 + e."""
    k = np.asarray(k)
    j = k % 8
    return 4 * (j >> 1) + (j & 1) + 2 * (k >= 8)


def _bf16_a_fragments(copies, steps):
    """``(step, 16, 16)``: the A matrices the lanes' four registers hold
    (m16n8k16 bf16: register j of lane (g, tig) holds row g (+8 for j odd),
    columns 2 tig (+8 for j >= 2) and + 1), read where ``rows_bf16_mma``
    reads them: copy (4 tig - g + 32) & 1, words 8 s + (4 tig - g + 32) >> 1
    + (0, -4, 1, -3), the low half first."""
    a = np.zeros((steps, 16, 16), np.float64)
    s = np.arange(steps)
    for lane in range(32):
        g, tig = lane >> 2, lane & 3
        base = 4 * tig - g + 32
        for m, k0, dw in ((g, 2 * tig, 0), (g + 8, 2 * tig, -4),
                          (g, 2 * tig + 8, 1), (g + 8, 2 * tig + 8, -3)):
            words = copies[base & 1, (base >> 1) + 8 * s + dw].astype(np.uint32)
            for i in range(2):
                bits = ((words >> np.uint32(16 * i)) & np.uint32(0xFFFF)) << np.uint32(16)
                a[:, m, k0 + i] = bits.view(np.float32)
    return a


@pytest.mark.parametrize("sigma", [0.6, 2.1, 3.0, 9.7, 30.0, 90.0])  # rw 1..299
@pytest.mark.parametrize("form", ["direct", "assembled"])
def test_bf16_rows_table_is_the_band_of_the_bf16_taps(sigma, form):
    """The bf16 rows table (``tc_tables(..., "bf16", ...)``) holds the row
    taps rounded to bf16 (``_bf16_taps`` of the plan's taps): each lane's A
    registers hold the band ``c[16 s + pi(k) - m - delta]`` for the window
    byte ``pi(k)`` its B fragment reads at position k, with (-rw) mod 16
    leading zeros in every form (the assembled form's too); the header is
    zero (no recentring), and the column part is the hybrid's tap groups of
    the same bf16 column taps."""
    plan = make_plan((64, 2000), (2.0, sigma))
    rh, rw = plan.col.support_radius, plan.row.support_radius
    framed = form == "assembled"
    lay = t_dma.tc_layout(form, "bf16", 16, 64, rh, rw, 2)
    assert lay.delta == (16 - rw % 16) % 16
    assert lay.rsteps == -(-(lay.delta + 2 * rw + 16) // 16) and lay.sw == 64 - 16 + 16 * lay.rsteps
    words = t_dma.tc_tables(plan, "bf16", framed).numpy().view(np.uint32)
    assert words.size * 4 == lay.taps and not words[:4].any()
    copies = words[4 : 4 + 2 * lay.rwords].reshape(2, lay.rwords)
    c = t_dma._bf16_taps(plan.row.taps).astype(np.float64)
    assert np.array_equal(c, t_dma.bf16_operands(plan).c_row)
    a = _bf16_a_fragments(copies, lay.rsteps)
    s, m, k = np.ogrid[:lay.rsteps, :16, :16]
    t = 16 * s + _pi(k) - m - lay.delta
    want = np.where((t >= 0) & (t < c.size), c[np.clip(t, 0, c.size - 1)], 0.0)
    assert np.array_equal(a, want)
    # every tap of every output column once: the band covers 2rw + 1 taps
    assert np.array_equal(np.count_nonzero((t >= 0) & (t < c.size), axis=(0, 2)).ravel(),
                          np.full(16, c.size))
    cols = words[4 + 2 * lay.rwords : 4 + 2 * lay.rwords + 12 * (lay.groups + 14)]
    ops = t_dma.bf16_operands(plan)
    assert np.array_equal(cols, t_dma._tap_groups(ops.c_col, lay.groups).ravel())


@pytest.mark.parametrize("byte", [0, 1, 127, 128, 200, 255])
def test_bf16_b_fragments_are_the_raw_bytes(byte):
    """``bytes_bf16``: 2^23 + byte as an f32, less 2^23, rounded to bf16, is
    the byte (every value 0..255 is exact in bf16); the four bytes of a
    lane's word go to k = 2 tig, 2 tig + 1 (b0) and 2 tig + 8, + 9 (b1)."""
    f = np.float32(np.uint32(0x4B000000 | byte).view(np.float32)) - np.float32(2.0 ** 23)
    assert f == byte
    assert torch.tensor(float(f)).to(torch.bfloat16).item() == byte
    assert list(_pi(np.arange(16))) == [0, 1, 4, 5, 8, 9, 12, 13, 2, 3, 6, 7, 10, 11, 14, 15]


def _bf16_rows_grouped(xp, c, w):
    """float64 model of the bf16 rows pass: output column j's taps grouped
    into k-steps by the 16-aligned run of image columns they read (window
    byte j - rw + t, the same in every form), each step's products summed
    exactly, the running f32 sum rounded once a step, then bf16."""
    rw = (c.size - 1) // 2
    cf = c.astype(np.float64)
    n, rows, _ = xp.shape
    acc = np.zeros((n, rows, w), np.float32)
    j = np.arange(w)
    # group of tap t for column j: floor((j - rw + t) / 16), relative to
    # the first group column j reads
    first = np.floor_divide(j - rw, 16)
    last = np.floor_divide(j + rw, 16)
    for step in range(int((last - first).max()) + 1):
        part = np.zeros((n, rows, w), np.float64)
        for t in range(c.size):
            inside = np.floor_divide(j - rw + t, 16) - first == step
            if cf[t] and inside.any():
                part[:, :, inside] += cf[t] * xp[:, :, t : t + w][:, :, inside]
        acc = (acc.astype(np.float64) + part).astype(np.float32)
    return t_dma.bf16_round_ref(torch.from_numpy(acc)).numpy()


BF16_CASES = [((64, 96), 1.0), ((96, 128), 3.0), ((80, 300), 10.0), ((96, 160), (12.0, 2.0)),
              ((40, 260), (2.0, 30.0))]


@pytest.mark.parametrize("shape, sigma", BF16_CASES)
def test_bf16_grouped_model_is_within_the_bound_of_the_plain_version(shape, sigma):
    """A CPU model of K1's bf16 body as the card runs it (rows in k-steps of
    16 image-aligned window bytes, columns in aligned groups of 16 of each
    output's own tap index, both f32 sums rounded once a step) against
    ``blur_fused_u8_bf16_ref`` (tap by tap, ascending): within
    ``bf16_bound`` on the f32 store and 1 count on the uint8 store; the
    bound is COLS_TOL where no rows value lies near a bf16 rounding
    boundary and never below it."""
    h, w = shape
    plan = make_plan(shape, sigma)
    rh, rw = plan.col.support_radius, plan.row.support_radius
    ops = t_dma.bf16_operands(plan)
    x = _frames(2, shape, seed=h + 3 * w)
    xt = torch.from_numpy(x)
    xp = reflect_101(xt, [(rh, rh), (rw, rw)]).numpy().astype(np.float64)
    y = _bf16_rows_grouped(xp, ops.c_row, w)
    model = torch.stack([torch.from_numpy(_hybrid_grouped(y[p], ops.c_col, h))
                         for p in range(2)])
    plain = t_dma.blur_fused_u8_bf16_ref(xt, plan, out_u8=False)
    bound = t_dma.bf16_bound(xt, plan)
    assert bound.shape == plain.shape and float(bound.min()) >= t_dma.COLS_TOL
    d = (model.double() - plain.double()).abs()
    assert bool((d <= bound).all()), float((d - bound).max())
    model8 = t_dma.store_u8_ref(model)
    plain8 = t_dma.blur_fused_u8_bf16_ref(xt, plan)
    assert int((model8.int() - plain8.int()).abs().max()) <= 1


def test_bf16_bound_counts_each_rows_value_near_a_rounding_boundary():
    """``bf16_bound``: COLS_TOL alone where every rows sum is a bf16 value
    (a constant frame), and COLS_TOL + sum |c_t| where every rows sum is a
    rounding boundary: columns alternating 128 and 129 under row taps (1/4,
    1/2, 1/4) sum to 128.5 everywhere, half way between the bf16 neighbours
    128 and 129, so each rows value may take either and every output reads
    a step of 1.0 at each of its column taps."""
    from blur_algorithms_tpu_torch import make_custom_plan

    taps = np.array([0.25, 0.5, 0.25], np.float32)
    plan = make_custom_plan((40, 64), taps, np.array([0.125, 0.75, 0.125], np.float32))
    flat = torch.full((1, 40, 64), 200, dtype=torch.uint8)
    assert torch.equal(t_dma.bf16_bound(flat, plan),
                       torch.full((1, 40, 64), t_dma.COLS_TOL, dtype=torch.float64))
    stripes = torch.from_numpy(np.tile(np.array([128, 129], np.uint8), (1, 40, 32)))
    got = t_dma.bf16_bound(stripes, plan)
    assert torch.equal(got, torch.full((1, 40, 64), t_dma.COLS_TOL + 1.0, dtype=torch.float64))
    # and the plain version and the model agree within it
    plain = t_dma.blur_fused_u8_bf16_ref(stripes, plan, out_u8=False)
    assert float((plain.double() - 128.5).abs().max()) <= 0.5 + t_dma.COLS_TOL
