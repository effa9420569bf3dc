"""A CPU model of the tiling of the split's tensor-core kernels.

``csrc/fused_split.cu`` runs the split's two passes as band products on
the card's tensor cores; no card is needed to check how they cut the work:

- the rows pass (``split_rows_int8_kernel``): the shifted tap copies the
  kernel builds in shared memory, the A fragments each lane of a warp loads
  from them (``mma.m16n8k32``, 16 output columns x 32 window columns a
  k-step), checked against the band ``q[32s + k - m]``, multiplied out
  exactly (one float64 product, every sum an integer below 2^53) over the
  kernel's 16-column warp blocks and k-steps against the raw bytes of
  their 128-column blocks' windows (reflect-101 as its loader does it),
  then recentred: equal to ``fused_split_rows_int8_ref`` exactly at r 1 to
  4096, on ragged widths and widths under 2r + 1;
- the hybrid pass 2 (``split_cols_hybrid_kernel``): the bf16 tap groups
  (12 words apart) and the A fragments each lane loads (``mma.m16n8k16``,
  on 32 banks), checked against the block-Toeplitz band ``c[16 (s - m) + k]``;
  the rows each fragment's B operand reads: every tap of every output row
  is read once, in the aligned groups of 16 of its own tap index, the same
  whatever the tile and shard origin; and a float64 model of that grouped
  sum rounded to f32 once per group, within 2e-2 at 0..255 scale (1 count
  on the uint8 store) of ``fused_split_cols_hybrid_ref`` and of the JAX
  ``_kernel_int8(hybrid_cols=True)`` run in interpret mode.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from blur_algorithms_tpu.ops.plan import make_plan as j_make_plan  # noqa: E402
from blur_algorithms_tpu.pallas_kernels import fused_blur as j_fused  # noqa: E402
from blur_algorithms_tpu_torch import make_plan  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fused_blur as t_fused  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fused_split as fs  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels.fused_dma import (  # noqa: E402
    _bf16_taps,
    bf16_round_ref,
    fma_f32_ref,
    store_u8_ref,
)
from blur_algorithms_tpu_torch.ops.pad import reflect_101  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test. The plain versions sum tap by tap in small
    torch ops; beside the suite's other workers their intra-op threads wait
    on one another (the r 4096 rows case: 0.1 s alone, 65 s beside seven
    busy processes, on 8 cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

HYBRID_TOL = 2e-2  # the f32 store at 0..255 scale; the uint8 store: 1 count


def _frames(planes, shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(planes, *shape), dtype=np.uint8)


def _reflect101(i, n):
    """The kernels' reflect-101 index math: one reflection, then a clamp."""
    i = np.abs(i)
    i = np.where(i > n - 1, 2 * (n - 1) - i, i)
    return np.clip(i, 0, n - 1)


# ---------------------------------------------------------------------------
# the rows pass


def _tap_copies(q, rw):
    """The kernel's four byte-shifted copies of each digit's taps,
    ``[digit][copy][word]``: copy c word i holds bytes ``4i + c .. 4i + c +
    3`` of the digit taps after 16 + delta zeros."""
    delta, steps = fs.rows_geometry(rw)
    need = 8 * steps + 4
    words = need + (8 - need) % 32
    assert words % 32 == 8 and words >= need
    out = np.zeros((2, 4, words), np.uint64)
    for d, digits in enumerate((q >> 7, q & 127)):
        t = np.zeros(4 * words + 4, np.uint64)
        t[16 + delta : 16 + delta + digits.size] = digits.astype(np.int64) & 0xFF
        for c in range(4):
            idx = 4 * np.arange(words)[:, None] + c + np.arange(4)[None, :]
            out[d, c] = (t[idx] << (8 * np.arange(4, dtype=np.uint64))).sum(axis=1)
    return out


def _rows_fragments(copies, steps):
    """``(digit, step, 16, 32)``: the A matrices the lanes' four registers
    hold (m16n8k32 layout: register j of lane (g, tig) holds row g (+8 for j
    odd), columns 4 tig (+16 for j >= 2) .. + 3), read where the kernel reads
    them: copy (16 + 4 tig - g) mod 4, words 8s + (16 + 4 tig - g) // 4 + (0,
    -2, 4, 2)."""
    a = np.zeros((2, steps, 16, 32), np.int64)
    s = np.arange(steps)
    for lane in range(32):
        g, tig = lane >> 2, lane & 3
        b0 = 4 * tig - g + 16
        for j, (m, k0, dw) in enumerate(((g, 4 * tig, 0), (g + 8, 4 * tig, -2),
                                         (g, 4 * tig + 16, 4), (g + 8, 4 * tig + 16, 2))):
            words = copies[:, b0 & 3, (b0 >> 2) + 8 * s + dw]  # (digit, step)
            for i in range(4):
                byte = ((words >> np.uint64(8 * i)) & np.uint64(0xFF)).astype(np.int64)
                a[:, :, m, k0 + i] = np.where(byte >= 128, byte - 256, byte)
    return a


def _rows_band(q, rw, steps):
    """``(digit, step, 16, 32)``: the band ``q'[32s + k - m]``, with ``q'`` the
    digit taps after delta leading zeros."""
    delta, _ = fs.rows_geometry(rw)
    s, m, k = np.ogrid[:steps, :16, :32]
    t = 32 * s + k - m - delta
    ok = (t >= 0) & (t < q.size)
    return np.stack([np.where(ok, d[np.clip(t, 0, q.size - 1)], 0)
                     for d in (q >> 7, q & 127)]).astype(np.int64)


def _rows_model(x, plan, q):
    """R of the rows pass with taps ``q`` as the kernel tiles it: per
    16-column warp block (its 128-column block's window of raw bytes,
    reflect-101, from the block's own first column) the k-steps of 32
    columns, two digits; then R = 128 (hi - 128 Q_hi) + lo - 128 Q_lo. All
    blocks and k-steps are one float64 product per digit: every partial sum
    is an integer below 2^53 (|digit x byte| < 2^16 over at most ~8200
    columns), so it is exact whatever order the product sums in."""
    rw = plan.row.support_radius
    delta, steps = fs.rows_geometry(rw)
    a = _rows_fragments(_tap_copies(q, rw), steps)
    assert np.array_equal(a, _rows_band(q, rw, steps))
    n, h, w = x.shape
    assert fs.ROWS_TILE[1] % 16 == 0  # warp blocks never straddle a 128-column block
    # warp block c0 (a multiple of 16 below w) reads window columns c0 - j0
    # .. + 32 steps of its block's window, which starts at j0 - rw - delta
    starts = np.arange(0, w, 16)
    cols = _reflect101(starts[:, None] - rw - delta + np.arange(32 * steps), w)
    b = x[:, :, cols].astype(np.float64)  # (n, h, blocks, steps * 32)
    am = a.transpose(0, 1, 3, 2).reshape(2, 32 * steps, 16).astype(np.float64)
    hi, lo = (np.rint(b @ am[d]).astype(np.int64) for d in (0, 1))  # (n, h, blocks, 16)
    r = 128 * hi + lo - 128 * int(q.sum())
    return r.reshape(n, h, -1)[:, :, :w]


@pytest.mark.parametrize("shape, sigma", [
    ((5, 130), 0.55),        # r 1, a ragged width
    ((4, 5), 0.85),          # r 2, a width under 2r + 1
    ((9, 77), 14.95),        # r 49, width 77 < 99
    ((7, 300), 49.8),        # r 165, width 300 < 331
    ((6, 1000), 249.85),     # r 831, width 1000 < 1663
    ((3, 2000), 249.85),     # r 831, ragged: 16 blocks, the last of 80 columns
    ((2, 8200), 1230.65),    # r 4096, the split's reach
], ids=["r1", "r2-narrow", "r49-narrow", "r165-narrow", "r831-narrow", "r831-ragged",
        "r4096"])
def test_rows_band_fragments_multiply_out_to_the_plain_version(shape, sigma):
    plan = make_plan(shape, sigma)
    rows, _ = t_fused._split_plans(plan)
    x = _frames(2, shape, seed=91)
    xt = torch.from_numpy(x)
    q, _, shift = fs.rows_operands(rows, True)
    r = _rows_model(x, rows, q)
    e = torch.from_numpy((r + (1 << (shift - 1))) >> shift).to(torch.int16)
    assert torch.equal(e, fs.fused_split_rows_int8_ref(xt, rows, True))
    q, scale, _ = fs.rows_operands(rows, False)  # the f32 store: its own scale
    r = torch.from_numpy(_rows_model(x, rows, q))
    y = r.to(torch.float32).to(torch.float64) * float(np.float32(1.0 / scale)) + 128.0
    assert torch.equal(y.to(torch.float32), fs.fused_split_rows_int8_ref(xt, rows, False))


def _byte_perm(x, y, sel):
    """CUDA's ``__byte_perm(x, y, sel)``: byte j of the result is byte
    ``(sel >> 4j) & 7`` of the eight bytes of ``y:x``."""
    b = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(b[(sel >> (4 * j)) & 7] << (8 * j) for j in range(4))


def _words(row, at):
    """The four little-endian 32-bit words of ``row[at : at + 16]``."""
    return [int.from_bytes(bytes(row[at + 4 * q : at + 4 * q + 4]), "little") for q in range(4)]


@pytest.mark.parametrize("w", [16, 32, 48, 3840])
def test_rows_mirrored_edge_segments_equal_reflect_101(w):
    """The rows pass's 16-byte segments past the frame's edge (window column
    ``gc`` a multiple of 16 with ``16 - w <= gc < 0`` or ``w <= gc <= 2w -
    32``): the two aligned words the kernel loads, byte-reversed by its
    ``__byte_perm`` selectors, are the reflect-101 bytes."""
    row = np.random.default_rng(w).integers(0, 256, size=w, dtype=np.uint8)
    for gc in range(16 - w, 2 * w - 31, 16):
        if 0 <= gc < w:
            continue
        if gc < 0:
            a, b = _words(row, -gc - 16), _words(row, -gc)
            got = [_byte_perm(a[3], b[0], 0x1234), _byte_perm(a[2], a[3], 0x1234),
                   _byte_perm(a[1], a[2], 0x1234), _byte_perm(a[0], a[1], 0x1234)]
        else:
            a, b = _words(row, 2 * w - 32 - gc), _words(row, 2 * w - 16 - gc)
            got = [_byte_perm(b[2], b[3], 0x3456), _byte_perm(b[1], b[2], 0x3456),
                   _byte_perm(b[0], b[1], 0x3456), _byte_perm(a[3], b[0], 0x3456)]
        want = row[_reflect101(gc + np.arange(16), w)]
        assert b"".join(v.to_bytes(4, "little") for v in got) == want.tobytes(), gc


@pytest.mark.parametrize("rw", [1, 2, 15, 16, 17, 49, 165, 831, 4094, 4096])
def test_rows_geometry_covers_every_tap_of_every_row(rw):
    """Row m of a 16-column block reads taps 32s + k - m - delta over its
    k-steps: every tap 0 .. 2rw exactly once, and the window starts 16-byte
    aligned at any block (128 | j0) since rw + delta = 0 (mod 16)."""
    delta, steps = fs.rows_geometry(rw)
    assert (rw + delta) % 16 == 0 and 0 <= delta < 16
    s, k = np.meshgrid(np.arange(steps), np.arange(32), indexing="ij")
    for m in range(16):
        t = (32 * s + k - m - delta).ravel()
        t = np.sort(t[(t >= 0) & (t <= 2 * rw)])
        assert np.array_equal(t, np.arange(2 * rw + 1))
    assert 32 * steps - 32 < delta + 2 * rw + 1 + 15  # no whole step of zeros


# ---------------------------------------------------------------------------
# the hybrid pass 2


def _tap_groups(c, rh):
    """The kernel's tap groups in shared memory: word ``12 gs + p`` holds
    taps ``16 (gs - 15) + 2p`` and ``+ 1`` (zero outside 0 .. 2rh), as the
    pair (low, high); words 8..11 of a group are padding."""
    groups, _ = fs.hybrid_groups(rh)
    words = np.full(((groups + 30) * 12, 2), np.nan)
    for gs in range(groups + 30):
        for p in range(8):
            t = 16 * (gs - 15) + 2 * p
            words[12 * gs + p] = [c[i] if 0 <= i <= 2 * rh else 0.0 for i in (t, t + 1)]
    return words


def _hybrid_fragments(words, steps):
    """``(step, 16, 16)``: the A matrices of the lanes' four registers
    (m16n8k16 layout: register j of lane (g, tig) holds row g (+8 for j
    odd), columns 2 tig (+8 for j >= 2) and + 1), read where the kernel
    reads them: words ``12 (s - g + 15) + tig`` (+4) and 96 words before;
    asserts that each of the four loads of a step hits 32 banks (lanes on
    one word share it)."""
    a = np.zeros((steps, 16, 16))
    for s in range(steps):
        loads = [{} for _ in range(4)]
        for lane in range(32):
            g, tig = lane >> 2, lane & 3
            base = 12 * (15 - g) + tig + 12 * s
            at = (base, base - 96, base + 4, base - 92)
            for j, (m, k) in enumerate(((g, 2 * tig), (g + 8, 2 * tig),
                                        (g, 2 * tig + 8), (g + 8, 2 * tig + 8))):
                a[s, m, k : k + 2] = words[at[j]]
                loads[j].setdefault(at[j] % 32, set()).add(at[j])
        assert all(len(v) == 1 for load in loads for v in load.values())
    return a


@pytest.mark.parametrize("rh", [1, 2, 7, 8, 49, 165, 831, 4094])
def test_hybrid_fragments_are_the_block_toeplitz_band(rh):
    rng = np.random.default_rng(rh)
    c = rng.random(2 * rh + 1)
    groups, steps = fs.hybrid_groups(rh)
    a = _hybrid_fragments(_tap_groups(c, rh), steps)
    s, m, k = np.ogrid[:steps, :16, :16]
    t = 16 * (s - m) + k
    want = np.where((t >= 0) & (t <= 2 * rh), c[np.clip(t, 0, 2 * rh)], 0.0)
    assert np.array_equal(a, want)


def _b_rows(f, fi, s):
    """Window rows of the B operand of fragment ``f + 8 fi`` (warp f) at
    step s, k = 0 .. 15: x0, x1 for fi 0; x1, x2 for fi 1 (``x0`` rows f +
    16s + 0..7, ``x1`` + 8..15, ``x2`` + 16..23)."""
    k = np.arange(16)
    return f + 16 * s + 8 * fi + k


def _groups_of_rows(origin, rows, rh):
    """For each global output row of a shard of ``rows`` rows at ``origin``
    cut into the kernel's 256-row tiles: the taps each k-step adds, as the
    kernel's fragments read them, in the order of the steps."""
    groups, steps = fs.hybrid_groups(rh)
    th = fs.HYBRID_TILE[0]
    seen = {}
    for i0 in range(0, rows, th):
        tile = origin + i0  # window row 0 is the global row tile - rh
        for f in range(8):
            for fi in range(2):
                for m in range(16):
                    row = tile + f + 8 * fi + 16 * m
                    if row >= origin + rows:
                        continue
                    order = []
                    for s in range(steps):
                        taps = (tile - rh + _b_rows(f, fi, s)) - (row - rh)
                        taps = taps[(taps >= 0) & (taps <= 2 * rh)]
                        if taps.size:
                            order.append(tuple(taps.tolist()))
                    seen[row] = order
    return seen


@pytest.mark.parametrize("rh", [1, 49, 165, 331])
def test_hybrid_grouping_is_independent_of_the_tile_and_shard_origin(rh):
    """Each output row adds its taps 0 .. 2rh once each, in the aligned
    groups [16g, 16g + 16) of its own tap index, ascending, and that is the
    same for every row whatever the origin of the shard (0, 7, 135, 465,
    251) and of the 256-row tile it falls in."""
    groups, _ = fs.hybrid_groups(rh)
    want = [tuple(range(16 * g, min(16 * g + 16, 2 * rh + 1))) for g in range(groups)]
    first = None
    for origin in (0, 7, 135, 465, 251):
        seen = _groups_of_rows(origin, 600, rh)
        assert sorted(seen) == list(range(origin, origin + 600))
        assert all(order == want for order in seen.values())
        rows = {row: seen[row] for row in range(465, 600)}  # rows every shard holds
        first = first or rows
        assert rows == first


def _grouped_model(e16, plan, pre_padded_col=False):
    """The hybrid pass 2 as the kernel groups it, in float64: per output
    row, each group of 16 taps summed exactly (bf16 x bf16 products), added
    to the f32 sum and rounded to f32, groups ascending; then fma(acc, 1 /
    127, 128) in f32."""
    h, w = plan.shape
    rh = plan.col.support_radius
    if pre_padded_col:
        e = e16.reshape(-1, h + 2 * rh, w)
    else:
        e = reflect_101(e16.reshape(-1, h, w), [(rh, rh)], axes=[-2])
    y = bf16_round_ref(e.to(torch.float32)).to(torch.float64)
    c = _bf16_taps(plan.col.taps).astype(np.float64)
    groups, _ = fs.hybrid_groups(rh)
    acc = torch.zeros((y.shape[0], h, w), dtype=torch.float32)
    for g in range(groups):
        part = torch.zeros((y.shape[0], h, w), dtype=torch.float64)
        for t in range(16 * g, min(16 * g + 16, 2 * rh + 1)):
            part += c[t] * y[:, t : t + h]
        acc = (acc.to(torch.float64) + part).to(torch.float32)
    return fma_f32_ref(acc, float(np.float32(1.0 / 127.0)), 128.0)


@pytest.mark.parametrize("shape, sigma", [
    ((64, 80), 18.0),
    ((40, 200), 3.0),
    ((300, 24), (70.0, 2.0)),
    ((1700, 12), (250.0, 1.0)),  # column r 831
])
def test_hybrid_grouped_model_against_plain_version(shape, sigma):
    plan = make_plan(shape, sigma)
    rows, cols = t_fused._split_plans(plan)
    e = fs.fused_split_rows_int8_ref(torch.from_numpy(_frames(2, shape, seed=93)), rows)
    got = _grouped_model(e, cols)
    want = fs.fused_split_cols_hybrid_ref(e, cols, out_u8=False)
    assert float((got - want).abs().max()) <= HYBRID_TOL
    d = (store_u8_ref(got).int() - fs.fused_split_cols_hybrid_ref(e, cols).int()).abs()
    assert int(d.max()) <= 1


def test_hybrid_grouped_model_pre_padded_rows_equal_the_whole_frame():
    """The model on a shard's pre-padded rows (halo rows as the sharded
    path supplies them) is bit-equal to the same rows of the whole frame."""
    shape, sigma = (540, 96), 50.0
    plan = make_plan(shape, sigma)
    rows, cols = t_fused._split_plans(plan)
    rh = cols.col.support_radius
    e = fs.fused_split_rows_int8_ref(torch.from_numpy(_frames(1, shape, seed=94)), rows)
    whole = _grouped_model(e, cols)
    ep = reflect_101(e, [(rh, rh)], axes=[-2])
    for origin, h_loc in ((0, 135), (135, 135), (251, 251), (7, 300)):
        from blur_algorithms_tpu_torch.parallel.sharded import _local_plan

        _, lcols = t_fused._split_plans(_local_plan(plan, h_loc, shape[1]))
        part = ep[:, origin : origin + h_loc + 2 * rh].contiguous()
        got = _grouped_model(part, lcols, pre_padded_col=True)
        assert torch.equal(got, whole[:, origin : origin + h_loc])


@pytest.mark.parametrize("shape, sigma", [
    ((64, 80), 18.0),
    ((40, 200), 3.0),
    ((300, 24), (70.0, 2.0)),
])
def test_hybrid_grouped_model_against_jax(monkeypatch, shape, sigma):
    monkeypatch.setattr(j_fused, "_FORCE_INTERPRET", True)
    monkeypatch.setattr(j_fused, "_hybrid_cols_ok", lambda plan: True)
    plan, jplan = make_plan(shape, sigma), j_make_plan(shape, sigma)
    rows, cols = t_fused._split_plans(plan)
    x = _frames(2, shape, seed=95)
    e = fs.fused_split_rows_int8_ref(torch.from_numpy(x), rows)
    got = _grouped_model(e, cols)
    for out_u8 in (False, True):
        want = np.asarray(j_fused._blur_fused_split(jnp.asarray(x), jplan, "int8",
                                                    out_u8=out_u8)).astype(np.float64)
        mine = (store_u8_ref(got) if out_u8 else got).numpy().astype(np.float64)
        assert np.abs(mine - want).max() <= (1 if out_u8 else HYBRID_TOL)
