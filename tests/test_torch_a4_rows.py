"""A4 on row segments, and the sharded path's views, on the CPU.

On the sharded K1a route a shard's haloed rows reach A4 as an
``assemble.HaloedRows``: up to three row segments where they lie (the
block, the neighbours' edge rows, or the block's own edge rows marked
reversed for the reflect-101 halo at the frame's top and bottom), which the
kernel (``assemble_rows_kernel`` of ``csrc/fused_dma.cu``) reads in place.

- the segmented plain version (``assemble_padded_prepad_rows_ref``) equals
  the JAX ``_assemble_padded_prepad`` of the concatenated rows, bit for
  bit, at column radii 1..598, widths 250, 256 and 1777, row counts on and
  off a multiple of 8, each halo from a neighbour or reversed, and one
  segment;
- ``sharded._haloed_row`` hands out rows whose ``cat()`` equals shard j's
  rows ``[j h_loc - r, (j + 1) h_loc + r)`` of the whole frame reflected
  (sp 1, 2 and 4; every shard; dp 2; the pad-row fill; the multi-hop
  gather), and on the single-hop path the block and its interior halos
  share the frame's storage: nothing is cut or concatenated;
- a NumPy model of the kernel's mapping (2-D grid, a warp a frame row, its
  lanes the row's 16-byte chunks, four at a time; the aligned 16- or 32-byte granule
  loads, the byte gathers at the edges, the zero slack) over many shapes,
  segment layouts and source alignments: every output chunk written once,
  every source read inside its row, reversed segments reading row
  ``rows - 1 - i``, and the frame equal to the plain version.

The kernel itself runs on the card in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from blur_algorithms_tpu.pallas_kernels import fused_dma as j_dma  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import assemble  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels.assemble import HaloedRows  # noqa: E402
from blur_algorithms_tpu_torch.ops.pad import reflect_101  # noqa: E402
from blur_algorithms_tpu_torch.parallel import make_mesh, sharded  # noqa: E402

A4_WARPS = 8  # kA4Warps of csrc/fused_dma.cu: frame rows a CTA, a warp each
A4_UNROLL = 4  # kA4Unroll: the chunks a lane loads before it stores


def _frame(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8))


def _layout(frame, o, hb, r, top, bot) -> HaloedRows:
    """Rows ``[o, o + hb)`` of ``frame`` with ``r`` halo rows each side: a
    neighbour's view (``"nb"``), the block's own rows reversed (``"rev"``:
    rows 1..r on top, hb-1-r..hb-2 below) or, with ``r == 0``, none."""
    blk = frame[..., o : o + hb, :]
    if r == 0:
        return HaloedRows(None, blk, None)
    t = frame[..., o - r : o, :] if top == "nb" else blk[..., 1 : r + 1, :]
    b = frame[..., o + hb : o + hb + r, :] if bot == "nb" else blk[..., hb - 1 - r : hb - 1, :]
    return HaloedRows(t, blk, b, top_reversed=top == "rev", bot_reversed=bot == "rev")


def _k1a_frame(hs, w, rw):
    """A frame as K1a's geometry sizes one: the rows at (0, rw), rows past
    the last whole group of 8, width a multiple of 16 past the right border
    (the unclamped one, which the JAX frame needs room for)."""
    return -(-(hs + 1) // 8) * 8 + 8, -(-(w + 2 * rw) // 16) * 16


LAYOUTS = [("nb", "nb"), ("nb", "rev"), ("rev", "nb"), ("rev", "rev"), ("one", "one")]


@pytest.mark.parametrize("rw", [1, 3, 32, 332, 598])
@pytest.mark.parametrize("w", [250, 256, 1777])
@pytest.mark.parametrize("hs_mod8", [0, 5])
def test_segmented_plain_version_equals_jax(rw, w, hs_mod8):
    r = 6
    hs = 40 + hs_mod8  # 2r halo rows and the block
    hb = hs - 2 * r
    frame = _frame((2, 3, hs + 2 * r + 8, w), seed=rw + w + hs_mod8)
    hp, wp = _k1a_frame(hs, w, rw)
    for top, bot in LAYOUTS:
        rows = (HaloedRows(None, frame[..., 3 : 3 + hs, :], None) if top == "one"
                else _layout(frame, r + 4, hb, r, top, bot))
        assert tuple(rows.shape) == (2, 3, hs, w)
        cat = rows.cat()
        assert cat.is_contiguous()
        want = np.asarray(j_dma._assemble_padded_prepad(
            jnp.asarray(cat.reshape(-1, hs, w).numpy()), rw, rw, hp, wp))
        got = assemble.assemble_padded_prepad_rows_ref(rows, rw, rw, hp, wp)
        np.testing.assert_array_equal(got.reshape(-1, *got.shape[-2:]).numpy(), want)
        # the wrapper on CPU rows: the plain version, no launch counted
        before = assemble.assemble_padded_prepad.launches
        assert torch.equal(assemble.assemble_padded_prepad(rows, rw, rw, hp, wp), got)
        assert assemble.assemble_padded_prepad.launches == before


def test_haloed_rows_cat_reverses_the_marked_parts():
    frame = _frame((1, 2, 30, 17), seed=1)
    rows = _layout(frame, 0, 30, 4, "rev", "rev")
    want = reflect_101(frame, [(4, 4)], axes=[-2])
    assert torch.equal(rows.cat(), want)
    assert rows.shape == want.shape and rows.dtype == torch.uint8
    assert rows.device == frame.device


def test_a4_rejects_segments_it_cannot_read_in_place():
    frame = _frame((2, 3, 40, 64), seed=2)
    with pytest.raises(ValueError):  # neither CPU nor CUDA
        assemble.assemble_padded_prepad(_layout(frame.to("meta"), 4, 30, 4, "nb", "nb"),
                                        3, 3, 48, 80)
    with pytest.raises(ValueError):  # a CPU part beside no card
        assemble._segment_args(_layout(frame, 4, 30, 4, "nb", "nb").parts(), 0)
    # the planes' one stride: the batch's views fold, a transposed batch does not
    assert assemble._plane_stride(frame[..., 4:30, :].shape,
                                  frame[..., 4:30, :].stride()) == 40 * 64
    assert assemble._plane_stride(frame[:1, 1:2, 4:30].shape, frame[:1, 1:2].stride()) == 0
    assert assemble._plane_stride(frame[:, :1, 4:30].shape, frame[:, :1].stride()) == 3 * 40 * 64
    t = frame.transpose(0, 1)[..., :30, :]
    assert assemble._plane_stride(t.shape, t.stride()) is None


# ---------------------------------------------------------------------------
# the sharded path's rows


def _reference_rows(planar, i, j, n_dp, h_loc, r, h):
    """Shard (i, j)'s haloed rows from the whole frame: global rows [j h_loc
    - r, (j + 1) h_loc + r), reflect-101 against the true height h."""
    bl = planar.shape[0] // n_dp
    g = np.arange(j * h_loc - r, (j + 1) * h_loc + r)
    g = np.where(g < 0, -g, g)
    g = np.where(g > h - 1, 2 * (h - 1) - g, g)
    return planar[i * bl:(i + 1) * bl, :, :h][..., torch.from_numpy(g), :]


@pytest.mark.parametrize("h, sp, r", [
    (96, 1, 7), (96, 2, 7), (96, 4, 7), (96, 4, 23),  # single hop (r + 1 <= h_loc)
    (96, 4, 24), (96, 4, 40),  # r past the shard: the multi-hop gather
    (93, 4, 5),  # indivisible height: the pad-row fill
    (96, 2, 0),
])
def test_haloed_row_equals_the_reflected_frame(h, sp, r):
    n_dp = 2
    planar = _frame((4, 3, h, 40), seed=h + sp + r)
    pad_h = (-h) % sp
    padded = torch.nn.functional.pad(planar, (0, 0, 0, pad_h)) if pad_h else planar
    h_loc = (h + pad_h) // sp
    mesh = make_mesh(dp=n_dp, sp=sp, devices=[torch.device("cpu")] * (n_dp * sp))
    blocks = sharded._blocks(padded, mesh)
    single_hop = r + 2 * pad_h + 1 <= h_loc
    base = padded.untyped_storage().data_ptr()
    for i, row in enumerate(blocks):
        for blk in row:
            assert blk.untyped_storage().data_ptr() == base
        got = sharded._haloed_row(row, mesh.devices[i], r, h_loc, pad_h, h)
        for j, rows in enumerate(got):
            assert isinstance(rows, HaloedRows) == single_hop
            whole = rows.cat() if isinstance(rows, HaloedRows) else rows
            want = _reference_rows(padded, i, j, n_dp, h_loc, r, h)
            assert torch.equal(whole, want), (i, j)
        if not single_hop:
            continue
        # nothing cut or concatenated: every part a view of the frame, but
        # for the bottom block that an indivisible height fills, whose rows
        # the bottom shard and the first r rows of the one above it read
        fill = got[-1].block.untyped_storage().data_ptr()
        assert (fill != base) == bool(pad_h)
        for j, rows in enumerate(got):
            for t, rev in rows.parts():
                filled = bool(pad_h) and (j == sp - 1 and t is not rows.top
                                          or j == sp - 2 and t is rows.bot)
                assert t.untyped_storage().data_ptr() == (fill if filled else base), (i, j)
                assert rev == (t is rows.top and j == 0 or t is rows.bot and j == sp - 1)


def test_blocks_are_views_on_the_input_device_and_copies_elsewhere():
    planar = _frame((2, 3, 32, 16), seed=5)
    mesh = make_mesh(dp=1, sp=2, devices=[torch.device("cpu")] * 2)
    for j, blk in enumerate(sharded._blocks(planar, mesh)[0]):
        assert blk.untyped_storage().data_ptr() == planar.untyped_storage().data_ptr()
        assert torch.equal(blk, planar[:, :, 16 * j:16 * (j + 1)])
    # a non-contiguous input (the planar view of (B, H, W, C) frames) is copied
    strided = planar.permute(0, 2, 3, 1).contiguous().movedim(-1, -3)
    for j, blk in enumerate(sharded._blocks(strided, mesh)[0]):
        assert blk.is_contiguous()
        assert blk.untyped_storage().data_ptr() != strided.untyped_storage().data_ptr()
        assert torch.equal(blk, planar[:, :, 16 * j:16 * (j + 1)])
    meta = make_mesh(dp=1, sp=2, devices=[torch.device("meta")] * 2)
    for blk in sharded._blocks(planar, meta)[0]:
        assert blk.device.type == "meta"


# ---------------------------------------------------------------------------
# a NumPy model of the kernel's mapping


def _model_a4(segs, planes, w, rw, orw, hp, wp):
    """``assemble_rows_kernel`` run in NumPy: ``segs`` is a list of
    ``(rows array (planes, n, w), reversed, address of row 0 of plane 0,
    plane stride, row stride)`` (addresses only set each row's alignment).
    Returns the frame, the writes per output chunk, and asserts every read."""
    rcb = min(rw, w - 1)
    ends = np.cumsum([s[0].shape[1] for s in segs] + [0] * (3 - len(segs)))
    end0, end1, hs = int(ends[0]), int(ends[1]), int(ends[2])
    chunks = wp // 16
    out = np.full((planes, hp, wp), 77, np.uint8)
    writes = np.zeros((planes, hp, chunks), np.int64)
    grid_x = -(-hp // A4_WARPS)
    for plane in range(planes):
        for bx in range(grid_x):
            for warp in range(A4_WARPS):
                r = bx * A4_WARPS + warp
                if r >= hp:
                    continue
                for lane in range(32):  # kA4Unroll chunks at a time, 32 apart
                    for k0 in range(lane, chunks, 32 * A4_UNROLL):
                        for u in range(A4_UNROLL):
                            if k0 + 32 * u < chunks:
                                writes[plane, r, k0 + 32 * u] += 1
                if r >= hs:
                    out[plane, r] = 0
                    continue
                g = int(r >= end0) + int(r >= end1)
                data, rev, addr, ps, rs = segs[g]
                n = data.shape[1]
                i = r - (0, end0, end1)[g]
                src_row = n - 1 - i if rev else i
                assert 0 <= src_row < n
                if rev:
                    assert src_row == n - 1 - i
                src = data[plane, src_row]
                row_addr = addr + plane * ps + src_row * rs
                sh = (row_addr - orw) % 16
                span = 32 if sh else 16
                for k in range(chunks):
                    j0 = 16 * k - orw
                    if j0 >= sh and j0 - sh + span <= w:
                        lo = j0 - sh
                        assert (row_addr + lo) % 16 == 0  # aligned granule loads
                        assert 0 <= lo and lo + span <= w  # inside the row
                        val = src[lo : lo + span][sh : sh + 16]
                    elif j0 + 16 > -rcb and j0 < w + rcb:
                        val = np.zeros(16, np.uint8)
                        for b in range(16):
                            c = j0 + b
                            if -rcb <= c < w + rcb:
                                cr = abs(c)
                                cr = 2 * (w - 1) - cr if cr > w - 1 else cr
                                assert 0 <= cr < w
                                val[b] = src[cr]
                    else:
                        val = np.zeros(16, np.uint8)
                    out[plane, r, 16 * k : 16 * k + 16] = val
    return out, writes


@pytest.mark.parametrize("seed", range(12))
def test_kernel_model_writes_every_chunk_once_and_reads_inside_rows(seed):
    rng = np.random.default_rng(seed)
    w = int(rng.choice([1, 5, 16, 17, 33, 64, 100, 250, 256]))
    rw = int(rng.choice([0, 1, 3, 7, 32, 332]))
    orw = min(rw, w - 1) + int(rng.integers(0, 20))
    wp = -(-(orw + w + min(rw, w - 1) + int(rng.integers(0, 40))) // 16) * 16
    planes = int(rng.integers(1, 4))
    r = int(rng.integers(0, 5))
    hb = int(rng.integers(r + 2, 30))
    hs = hb + 2 * r
    hp = max(1, hs + int(rng.integers(-3, 20)))
    frame = rng.integers(0, 256, (planes, hb + 2 * r + 4, w), dtype=np.uint8)
    kinds = [("nb", "nb"), ("rev", "rev"), ("nb", "rev"), ("rev", "nb")][seed % 4]
    rows = _layout(torch.from_numpy(frame), r + 2, hb, r, *kinds)
    base = int(rng.integers(0, 64))  # the frame's address mod 64
    segs = [(t.reshape(-1, *t.shape[-2:]).numpy(), rev, base + t.storage_offset(),
             t.stride(-3), t.stride(-2)) for t, rev in rows.parts()]
    got, writes = _model_a4(segs, planes, w, rw, orw, hp, wp)
    assert (writes == 1).all()
    want = assemble.assemble_padded_ref(rows.cat(), 0, rw, 0, orw, hp, wp)
    np.testing.assert_array_equal(got, want.numpy())


def test_kernel_model_at_the_main_paths_row_alignments():
    """Every source alignment (row address mod 16) at the main path's column
    radius 29 on a 250-wide cut: the funnel-shift path at each shift."""
    rng = np.random.default_rng(7)
    w, rw, planes = 250, 29, 1
    hp, wp = _k1a_frame(20, w, rw)
    data = rng.integers(0, 256, (planes, 20, w), dtype=np.uint8)
    for addr in range(16):
        got, writes = _model_a4([(data, False, addr, 20 * w, w)], planes, w, rw, rw, hp, wp)
        assert (writes == 1).all()
        want = assemble.assemble_padded_prepad_ref(torch.from_numpy(data), rw, rw, hp, wp)
        np.testing.assert_array_equal(got, want.numpy())
