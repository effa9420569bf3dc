"""A CPU model of the tiling of the split's int8 cols pass.

``csrc/fused_split.cu`` runs the int8 cols pass (``split_cols_int8_kernel``)
as a band product along the columns on the int8 tensor cores
(``mma.m16n8k32``, 16 output rows x 32 input rows a k-step); no card is
needed to check how it cuts the work:

- the four byte-shifted tap copies the kernel builds (word ``i`` of copy
  ``c`` a funnel shift of tap words ``i - 4`` and ``i - 3``) and the A
  fragments each lane of a warp loads from them equal the band ``b[32s + k
  - m]`` of both tap digits;
- the digit words its loader writes (``split_digits``: the bit tricks on
  ``E + 64`` and the ``__byte_perm`` gathers, modelled in NumPy) equal
  ``e1 = asr(E + 64, 7)`` and ``e0 = E - 128 e1`` of 4 consecutive rows;
- an int64 model of the whole tiling (256 x 32 blocks, a warp's two 16-row
  blocks, k-steps, 256-row chunks through the 768-row ring in the kernel's
  order of fetch, convert and compute, ``src_row``) equals
  ``fused_split_cols_int8_ref`` exactly in both stores at r 1 to 4096, on
  ragged heights and widths, and with the caller's halo rows at shard
  origins 0, 7, 135 and 465; and equals the JAX ``_kernel_int8(in_e32=True)``
  run in interpret mode, as the JAX tests run it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from blur_algorithms_tpu.ops.plan import make_plan as j_make_plan  # noqa: E402
from blur_algorithms_tpu.pallas_kernels import fused_blur as j_fused  # noqa: E402
from blur_algorithms_tpu_torch import make_custom_plan, make_plan  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fused_blur as t_fused  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fused_split as fs  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels.fused_dma import (  # noqa: E402
    _pack_int8_words,
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

M32 = 0xFFFFFFFF


def _reflect101(i, n):
    """The kernels' reflect-101 index math: one reflection, then a clamp."""
    i = np.abs(i)
    i = np.where(i > n - 1, 2 * (n - 1) - i, i)
    return np.clip(i, 0, n - 1)


def _src_row(i, h, rh, xh, pre):
    """The kernel's ``src_row``: halo row ``i`` (-rh <= i) of a cols pass."""
    return np.minimum(i + rh, xh - 1) if pre else _reflect101(i, h)


def _e16(planes, shape, seed):
    """int16 E as the rows pass makes it: 127 (rows_conv(x) - 128), rounded
    (|E| <= 16256)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, size=(planes, *shape))
    return torch.from_numpy((127 * (x - 128) + rng.integers(-63, 64, size=x.shape))
                            .astype(np.int16))


# ---------------------------------------------------------------------------
# the A fragments


def _tap_copies(q, rh):
    """The kernel's copies ``[digit][copy][word]`` as it builds them: word i
    of copy c = __funnelshift_r(T[i - 4], T[i - 3], 8c), T the digit's tap
    words (four int8 taps a word, zero outside)."""
    _, words = fs.cols_geometry(rh)
    out = np.zeros((2, 4, words), np.int64)
    for d, digits in enumerate((q >> 7, q & 127)):
        tw = _pack_int8_words(digits.astype(np.int8)).astype(np.int64) & M32
        t = lambda k: int(tw[k]) if 0 <= k < tw.size else 0  # noqa: E731
        for i in range(words):
            pair = t(i - 4) | (t(i - 3) << 32)
            for c in range(4):
                out[d, c, i] = (pair >> (8 * c)) & M32
    return out


def _fragments(copies, steps):
    """``(digit, step, 16, 32)``: the A matrices the lanes' four registers
    hold (register j of lane (g, tig): row g (+8 for j odd), columns 4 tig
    (+16 for j >= 2) .. + 3), read where the kernel reads them: copy (16 + 4
    tig - g) mod 4, words 8s + (16 + 4 tig - g) // 4 + (0, -2, 4, 2); every
    read within the copy."""
    words = copies.shape[-1]
    a = np.zeros((2, steps, 16, 32), np.int64)
    s = np.arange(steps)
    for lane in range(32):
        g, tig = lane >> 2, lane & 3
        b0 = 4 * tig - g + 16
        for j, (m, k0, dw) in enumerate(((g, 4 * tig, 0), (g + 8, 4 * tig, -2),
                                         (g, 4 * tig + 16, 4), (g + 8, 4 * tig + 16, 2))):
            at = (b0 >> 2) + 8 * s + dw
            assert at.min() >= 0 and at.max() < words
            got = copies[:, b0 & 3, at]  # (digit, step)
            for i in range(4):
                byte = (got >> (8 * i)) & 0xFF
                a[:, :, m, k0 + i] = np.where(byte >= 128, byte - 256, byte)
    return a


def _band(q, steps):
    s, m, k = np.ogrid[:steps, :16, :32]
    t = 32 * s + k - m
    ok = (t >= 0) & (t < q.size)
    return np.stack([np.where(ok, d[np.clip(t, 0, q.size - 1)], 0)
                     for d in (q >> 7, q & 127)]).astype(np.int64)


@pytest.mark.parametrize("rh", [1, 2, 15, 16, 17, 49, 165, 831, 4094, 4096])
def test_a_fragments_are_the_band_of_both_digits(rh):
    taps = np.exp(-0.5 * (np.arange(-rh, rh + 1) / (0.3 * rh + 0.5)) ** 2)
    cols = make_custom_plan((2 * rh + 8, 3), [1.0], taps / taps.sum())
    q, _ = fs.cols_operands(cols)
    assert q.size == 2 * rh + 1 and cols.col.support_radius == rh
    steps, words = fs.cols_geometry(rh)
    assert words % 32 == 8 and words >= 8 * steps + 4
    a = _fragments(_tap_copies(q, rh), steps)
    assert np.array_equal(a, _band(q, steps))
    # every tap of every row of a block exactly once, no whole step of zeros
    s, k = np.meshgrid(np.arange(steps), np.arange(32), indexing="ij")
    for m in range(16):
        t = (32 * s + k - m).ravel()
        assert np.array_equal(np.sort(t[(t >= 0) & (t <= 2 * rh)]), np.arange(2 * rh + 1))
    assert 32 * steps - 32 < 2 * rh + 1 + 15


# ---------------------------------------------------------------------------
# the digit words


def _byte_perm(x, y, sel):
    """CUDA's ``__byte_perm`` on arrays: byte j of the result is byte ``(sel
    >> 4j) & 7`` of the eight bytes of ``y:x``."""
    b = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(b[(sel >> (4 * j)) & 7] << (8 * j) for j in range(4))


def _split_digits(v):
    """The kernel's ``split_digits``: ``v`` (4 rows, ...) 32-bit words of two
    int16 columns (the first low) -> (d1, d0), each (2 columns, ...), the
    word of the 4 rows' digits a column, row i in byte i."""
    t = ((v ^ 0x80008000) + 0x00400040) & M32
    a1 = t >> 7
    a0 = v ^ (t & 0x00800080)
    h1, l1 = _byte_perm(a1[0], a1[1], 0x6240), _byte_perm(a1[2], a1[3], 0x6240)
    h0, l0 = _byte_perm(a0[0], a0[1], 0x6240), _byte_perm(a0[2], a0[3], 0x6240)
    return ((_byte_perm(h1, l1, 0x5410), _byte_perm(h1, l1, 0x7632)),
            (_byte_perm(h0, l0, 0x5410), _byte_perm(h0, l0, 0x7632)))


def _bytes_of(word):
    """(4, ...) signed bytes of 32-bit words."""
    b = np.stack([(word >> (8 * i)) & 0xFF for i in range(4)])
    return np.where(b >= 128, b - 256, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_digit_words_are_e1_e0_of_four_rows(seed):
    rng = np.random.default_rng(seed)
    # every E whose high digit fits int8, the edges of the digit split
    # first, then random rows
    edges = np.array([-16448, -16384, -16256, -129, -128, -65, -64, -63, -1, 0, 1, 63, 64,
                      65, 127, 128, 191, 192, 16255, 16256, 16319], np.int64)
    e = np.concatenate([np.resize(edges, 4 * 2 * 64),
                        rng.integers(-16448, 16320, size=4 * 2 * 4096)]).reshape(4, 2, -1)
    v = (e[:, 0] & 0xFFFF) | ((e[:, 1] & 0xFFFF) << 16)  # (rows, words)
    (d1a, d1b), (d0a, d0b) = _split_digits(v)
    e1 = (e + 64) >> 7
    e0 = e - 128 * e1
    assert e1.min() >= -128 and e1.max() <= 127 and e0.min() >= -64 and e0.max() <= 63
    for col, (d1, d0) in enumerate(((d1a, d0a), (d1b, d0b))):
        assert np.array_equal(_bytes_of(d1), e1[:, col])
        assert np.array_equal(_bytes_of(d0), e0[:, col])


# ---------------------------------------------------------------------------
# the digit planes in shared memory


def test_digit_plane_columns_are_disjoint_and_conflict_free():
    """Column j of a digit plane holds ring rows 0 .. 767 from byte
    ``cols_column(j)``: the 32 columns' bytes are disjoint and inside the
    plane, 16-byte aligned; an ldmatrix matrix (8 columns of one group, 16
    rows at one ring row) hits 8 different 16-byte bank groups; and a warp's
    staging writes (lane l: column group (l & 1) + 2 (warp & 1), row quad (l
    >> 1) + 16 (warp >> 1); one 32-bit word of a column) hit 32 banks."""
    pitch, ring, tw = fs.COLS_PITCH, fs.COLS_RING, fs.COLS_TILE[1]
    plane = fs.cols_column(tw - 1) + pitch
    spans = sorted((fs.cols_column(j), fs.cols_column(j) + ring) for j in range(tw))
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:])) and spans[-1][1] <= plane
    assert all(fs.cols_column(j) % 16 == 0 for j in range(tw)) and plane % 16 == 0
    assert 2 * plane + 256 * 80 + 2 * 4 * 4 * fs.cols_geometry(831)[1] == fs.cols_smem_bytes(831)
    for n in range(tw // 8):
        for row in range(0, ring, 16):
            groups = {((fs.cols_column(8 * n + r) + row) // 16) % 8 for r in range(8)}
            assert len(groups) == 8
    for warp in range(8):
        for chunk_slot in range(3):
            for col in range(8):  # column 8 cs + col of each lane's group
                banks = set()
                for lane in range(32):
                    cs = (lane & 1) + 2 * (warp & 1)
                    qd = (lane >> 1) + 16 * (warp >> 1)
                    at = fs.cols_column(8 * cs + col) + chunk_slot * fs.COLS_CHUNK + 4 * qd
                    banks.add((at // 4) % 32)
                assert len(banks) == 32


# ---------------------------------------------------------------------------
# the whole tiling


def _model_sums(e16, plan, pre=False):
    """(p1, p23, p4) of the int8 cols pass as the kernel tiles it, int64:
    per 256 x 32 block, the window rows of each 256-row chunk through the
    768-row ring (convert 0 and 1 before the products, chunk ch + 2 after
    chunk ch's products, a chunk's rows read only while its slot holds it);
    per warp w and 16-row block b the k-steps from window row 32w + 16b,
    the A fragments against the digit rows there."""
    h, w = plan.shape
    rh = plan.col.support_radius
    xh = h + 2 * rh if pre else h
    e = e16.reshape(-1, xh, w).numpy().astype(np.int64)
    n = e.shape[0]
    q, _ = fs.cols_operands(plan)
    steps, _ = fs.cols_geometry(rh)
    a = _fragments(_tap_copies(q, rh), steps)
    th, tw = fs.COLS_TILE
    chunk, ring = fs.COLS_CHUNK, fs.COLS_RING
    nload = -(-(32 * steps + th - 16) // chunk)
    nch = -(-steps // 8)
    assert nload <= nch + 1  # fetch(ch + 3) and convert(ch + 2) past the window are no-ops
    sums = np.zeros((3, n, h, w), np.int64)
    for i0 in range(0, h, th):
        rows = _src_row(i0 - rh + np.arange(nload * chunk), h, rh, xh, pre)
        for j0 in range(0, w, tw):
            cols = np.minimum(j0 + np.arange(tw), w - 1)
            win = e[:, rows][:, :, cols]  # (n, window rows, 32)
            e1 = (win + 64) >> 7
            d = np.stack([e1, win - 128 * e1])  # (digit, n, rows, 32)
            slot = [None] * 3
            for c in (0, 1):
                slot[c % 3] = c
            # the warps' 16-row blocks that hold rows of the frame (a
            # ragged last tile leaves whole warps idle)
            blocks = [(wp, b) for wp in range(8) for b in range(2) if i0 + 32 * wp < h]
            r0 = np.array([32 * wp + 16 * b for wp, b in blocks])
            out = i0 + r0[:, None] + np.arange(16)  # (blocks, 16)
            keep = out < h
            jj = j0 + np.arange(tw)
            kc = jj < w
            for ch in range(nch):
                s_lo, s_hi = 8 * ch, min(8 * ch + 8, steps)
                read = (r0[:, None, None] + 32 * np.arange(s_lo, s_hi)[None, :, None]
                        + np.arange(32))  # (blocks, steps, 32 k)
                assert read.max() < nload * chunk
                assert ring == 3 * chunk and all(
                    slot[c % 3] == c for c in np.unique(read // chunk).tolist())
                bm = d[:, :, read]  # (digit, n, blocks, steps, 32 k, 32 cols)
                # the products of a chunk's k-steps, exact in float64 (|sum|
                # < 2^22), as one matmul over (step, k)
                sk = (s_hi - s_lo) * 32
                am = a[:, s_lo:s_hi].transpose(0, 2, 1, 3).reshape(2, 1, 1, 1, 16, sk)
                bk = bm.reshape(*bm.shape[:3], sk, bm.shape[-1])[None]
                prod = np.rint(np.matmul(am.astype(np.float64), bk.astype(np.float64)))
                prod = prod.astype(np.int64)  # (A digit, E digit, n, blocks, 16, 32)
                upd = np.stack([prod[0, 0], prod[0, 1] + prod[1, 0], prod[1, 1]])
                # the blocks' output rows are distinct: one scatter for all
                sums[:, :, out[keep][:, None], jj[kc][None, :]] += upd[:, :, keep][..., kc]
                if ch + 2 < nload:
                    slot[(ch + 2) % 3] = ch + 2
    return sums


def _model(e16, plan, out_u8, pre=False, sums=None):
    """The model's output: the sums (``_model_sums`` unless given) through
    K1's int8 epilogue, as the kernel's ``int8_epilogue`` rounds it for each
    store (each sum rounded to f32 as ``__int2float_rn`` does)."""
    if sums is None:
        sums = _model_sums(e16, plan, pre)
    p1, p23, p4 = (torch.from_numpy(p).to(torch.float32) for p in sums)
    _, (c1, c2, c3) = fs.cols_operands(plan)
    y = torch.mul(p1, c1)
    if out_u8:
        y = torch.add(torch.add(y, torch.mul(p23, c2)), torch.mul(p4, c3))
    else:
        y = fma_f32_ref(p4, c3, fma_f32_ref(p23, c2, y))
    y = torch.add(y, 128.0)
    h, w = plan.shape
    y = y.reshape(*e16.shape[:-2], h, w)
    return store_u8_ref(y) if out_u8 else y


CASES = [
    ((5, 130), (0.55, 0.3), "r1-ragged"),       # column r 1, ragged width
    ((300, 7), (14.95, 0.3), "r49-narrow"),     # r 49, one ragged 32-column tile
    ((557, 40), (49.8, 0.3), "r165-ragged"),    # r 165, three row tiles, the last of 45
    ((1700, 33), (249.85, 0.3), "r831"),        # r 831, 7 tiles, a 1-column tile
    ((8200, 3), (1230.65, 0.3), "r4096"),       # r 4096, the split's reach
]


_SUMS = {}  # the model's sums of each case, shared by its two stores


@pytest.mark.parametrize("out_u8", [True, False], ids=["u8", "f32"])
@pytest.mark.parametrize("shape, sigma, name", CASES, ids=[c[2] for c in CASES])
def test_tiling_model_equals_plain_version(shape, sigma, name, out_u8):
    plan = make_plan(shape, sigma)
    _, cols = t_fused._split_plans(plan)
    e = _e16(1 if name == "r4096" else 2, shape, seed=97)
    if name not in _SUMS:
        _SUMS[name] = _model_sums(e, cols)
    want = fs.fused_split_cols_int8_ref(e, cols, out_u8=out_u8)
    assert torch.equal(_model(e, cols, out_u8, sums=_SUMS[name]), want)


@pytest.mark.parametrize("origin, h_loc", [(0, 135), (7, 300), (135, 135), (465, 75)])
def test_tiling_model_on_halo_rows_equals_the_whole_frame(origin, h_loc):
    """``pre=1``: a shard's E with its rh halo rows each side, read as they
    are; the model equals the plain version on the same rows and the whole
    frame's rows at the shard's origin, in both stores."""
    shape, sigma = (540, 40), (50.0, 0.3)
    plan = make_plan(shape, sigma)
    _, cols = t_fused._split_plans(plan)
    rh = cols.col.support_radius
    e = _e16(1, shape, seed=98)
    ep = reflect_101(e, [(rh, rh)], axes=[-2])
    from blur_algorithms_tpu_torch.parallel.sharded import _local_plan

    _, lcols = t_fused._split_plans(_local_plan(plan, h_loc, shape[1]))
    part = ep[:, origin : origin + h_loc + 2 * rh].contiguous()
    for out_u8 in (True, False):
        whole = fs.fused_split_cols_int8_ref(e, cols, out_u8=out_u8)
        got = _model(part, lcols, out_u8, pre=True)
        assert torch.equal(got, fs.fused_split_cols_int8_ref(part, lcols, out_u8, True))
        assert torch.equal(got, whole[:, origin : origin + h_loc])


@pytest.mark.parametrize("shape, sigma", [((300, 40), (14.95, 0.3)), ((557, 24), (49.8, 1.0))],
                         ids=["r49", "r165"])
def test_tiling_model_equals_jax(monkeypatch, shape, sigma):
    """The model against the JAX ``_kernel_int8(in_e32=True)`` in interpret
    mode, on E from the JAX rows pass, both stores; and on pre-padded E."""
    monkeypatch.setattr(j_fused, "_FORCE_INTERPRET", True)
    plan, jplan = make_plan(shape, sigma), j_make_plan(shape, sigma)
    _, cols = t_fused._split_plans(plan)
    _, jcols = j_fused._split_plans(jplan)
    e = _e16(2, shape, seed=99)
    tile = j_fused._pick_tile(jcols, 2, "int8")
    for out_u8 in (True, False):
        want = np.asarray(j_fused._blur_fused_planar(
            jnp.asarray(e.numpy()), jcols, tile, "int8", out_u8=out_u8, e32="in"))
        assert np.array_equal(_model(e, cols, out_u8).numpy(), want)
    rh = cols.col.support_radius
    ep = reflect_101(e, [(rh, rh)], axes=[-2]).contiguous()
    want = np.asarray(j_fused._blur_fused_planar(
        jnp.asarray(ep.numpy()), jcols, tile, "int8", out_u8=True, e32="in",
        pre_padded_col=True))
    assert np.array_equal(_model(ep, cols, True, pre=True).numpy(), want)
