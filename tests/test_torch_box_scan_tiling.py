"""A CPU model of how K4 (``csrc/box_scan.cu``) cuts its work.

No card is needed to check the structure of the two kernels; each model
repeats its kernel's float64 operations in the kernel's order, on every line
at once:

- the rows kernel (``box_rows_kernel``): the span of a tile staged into runs
  of ``ceil(span / 256) | 1`` values a thread, per pass the run totals, the
  warps' inclusive shuffle scans, the warp totals added in order, each
  run's prefixes from its exclusive start, and the window means from the
  prefix differences (over uint8 the first pass in int32, whose exact sums
  the float64 model reproduces);
- the lines kernel (``box_lines_kernel``): segments of ``_line_segment``
  outputs, the first pass's segment totals read from the line, each
  segment's first window sum from the totals of the segments it spans and
  the few values at its end, the float64 running sum over the segment, and
  the next pass's totals summed from the emitted f32 values.

Each model equals ``box_blur_scan_axis_ref`` within the card tests'
tolerance on f32 data (1e-3 * max|x| / 255), within 1 count on the uint8
store, and exactly on uint8 data in a single pass (every window sum an exact
integer), on both axes, at passes 1-3, with the radius clamp, lines shorter
than a segment, tall columns (segments of 572 values), and rows too long
for the rows kernel.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blur_algorithms_tpu_torch.cuda_kernels import box_blur as k4  # noqa: E402
from blur_algorithms_tpu_torch.ops.layout import round_to_u8  # noqa: E402

THREADS, WARPS = 256, 8
SMEM = 232448  # an H100's opt-in shared memory a block


def _reflect101(i, n):
    i = np.abs(i)
    i = np.where(i > n - 1, 2 * (n - 1) - i, i)
    return np.clip(i, 0, n - 1)


def _mean(s, w):
    return (s * (1.0 / w)).astype(np.float32)


def _rows_tile_model(span, r, passes, w):
    """One tile of the rows kernel on ``span`` (lines, len) f32 values ->
    (lines, len - 2 passes r) f32."""
    lines, length = span.shape
    run = -(-length // THREADS) | 1  # odd: a warp's float64 accesses on distinct banks
    v = np.zeros((lines, THREADS * run), np.float32)
    v[:, :length] = span
    v = v.reshape(lines, THREADS, run).astype(np.float64)
    for _ in range(passes):
        tot = np.cumsum(v, axis=-1)[..., -1]  # the run's total, in order
        inc = tot.reshape(lines, WARPS, 32).copy()
        for o in (1, 2, 4, 8, 16):  # the warp's inclusive shuffle scan
            inc[..., o:] = inc[..., o:] + inc[..., :-o].copy()
        exc = np.concatenate([np.zeros((lines, WARPS, 1)), inc[..., :-1]], axis=-1)
        before = np.zeros((lines, WARPS))
        for k in range(1, WARPS):  # the warp totals added in order
            before[:, k] = before[:, k - 1] + inc[:, k - 1, -1]
        p0 = (before[..., None] + exc).reshape(lines, THREADS, 1)
        prefix = np.cumsum(np.concatenate([p0, v], axis=-1), axis=-1)  # P[a .. a + run]
        flat = prefix[..., 1:].reshape(lines, -1)  # P[1 ..]
        p_all = np.concatenate([np.zeros((lines, 1)), flat], axis=-1)
        m = length - 2 * r
        i = np.arange(THREADS * run).reshape(THREADS, run)
        ok = i < m
        got = _mean(p_all[:, np.minimum(i + w, THREADS * run)] - prefix[..., :-1], w)
        v = np.where(ok, got, 0.0).astype(np.float64)
        length = m
    return v.reshape(lines, -1)[:, :length].astype(np.float32)


def _rows_model(x, r, passes):
    """The rows kernel over lines ``x`` (lines, n), tile by tile."""
    lines, n = x.shape
    pad, w = passes * r, 2 * r + 1
    tile = k4._rows_tile(n, pad, SMEM)
    assert tile > 0 and tile + 2 * pad <= 256 * 63
    out = np.zeros((lines, n), np.float32)
    for o0 in range(0, n, tile):
        nout = min(tile, n - o0)
        span = x[:, _reflect101(o0 - pad + np.arange(nout + 2 * pad), n)]
        out[:, o0 : o0 + nout] = _rows_tile_model(span, r, passes, w)
    return out


def _lines_model(x, r, passes, stats=None):
    """The lines kernel over lines ``x`` (lines, n): per pass, the segments
    in order (the warps take them in turn; each reads only the pass's input
    and the totals), their first window sums and running sums."""
    lines, n = x.shape
    pad, w = passes * r, 2 * r + 1
    seg = k4._line_segment(n, r, passes)
    length = n + 2 * pad
    assert -(-length // seg) <= k4._MAX_SEGMENTS
    line = x[:, _reflect101(np.arange(length) - pad, n)].astype(np.float64)
    tot = [line[:, u * seg : (u + 1) * seg].cumsum(axis=-1)[:, -1]
           for u in range(-(-length // seg))]
    for p in range(passes):
        m = length - 2 * r
        out = np.zeros((lines, m), np.float32)
        nxt = []
        nseg = -(-m // seg)
        if stats is not None:
            stats["segments"] = max(stats.get("segments", 0), nseg)
            stats["short"] = stats.get("short", False) or m < seg
        for k in range(nseg):
            start, stop = k * seg, min(k * seg + seg, m)
            end = start + w
            ub = -(-end // seg)
            top = min(ub * seg, length)
            if top - end <= end - (ub - 1) * seg:
                wsum = np.zeros(lines)
                for u in range(k, ub):
                    wsum = wsum + tot[u]
                part = np.zeros(lines)
                for t in range(end, top):
                    part = part + line[:, t]
                wsum = wsum - part
            else:
                wsum = np.zeros(lines)
                for u in range(k, ub - 1):
                    wsum = wsum + tot[u]
                part = np.zeros(lines)
                for t in range((ub - 1) * seg, end):
                    part = part + line[:, t]
                wsum = wsum + part
            nt = np.zeros(lines)
            for i in range(start, stop):
                v = _mean(wsum, w)
                out[:, i] = v
                nt = nt + v
                if i + 1 < stop:
                    wsum = (wsum + line[:, i + w]) - line[:, i]
            nxt.append(nt)
        line, tot, length = out.astype(np.float64), nxt, m
    return line.astype(np.float32)


def _model(planar, r, passes, axis, out_u8):
    """K4 as the wrapper launches it: the radius clamp, then the rows
    kernel (axis -1 where a tile holds the span) or the lines kernel."""
    eff = k4.clamped_radius(planar.shape[axis], r, passes)
    x = planar.movedim(axis, -1)
    shape = x.shape
    lines = x.reshape(-1, shape[-1]).to(torch.float32).numpy()
    use_rows = axis == -1 and k4._rows_tile(shape[-1], passes * eff, SMEM) > 0
    y = (_rows_model if use_rows else _lines_model)(lines, eff, passes)
    y = torch.from_numpy(y).reshape(shape).movedim(-1, axis).contiguous()
    return (round_to_u8(y) if out_u8 else y), use_rows


def _planes(shape, seed, u8):
    rng = np.random.default_rng(seed)
    if u8:
        return torch.from_numpy(rng.integers(0, 256, size=shape, dtype=np.uint8))
    return torch.from_numpy((rng.random(shape, dtype=np.float32) * 255.0))


CASES = [
    ((3, 40, 300), 5, 2, -1, "rows"),
    ((2, 7, 1500), 200, 3, -1, "rows-3-pass"),          # runs of 14
    ((2, 3, 9000), 1700, 2, -1, "rows-tiled"),          # tiles of span <= 7936
    ((2, 3, 6000), 1200, 3, -1, "rows-runs-of-63"),     # one tile of span 13200
    ((1, 2, 24000), 9800, 1, -1, "rows-as-lines"),      # past the longest span
    ((2, 300, 33), 40, 2, -2, "cols"),
    ((2, 1080, 9), 400, 2, -2, "cols-r400"),
    ((2, 20000, 5), 4000, 3, -2, "cols-tall"),          # segments of 572 values
    ((3, 20, 7), 3, 2, -2, "cols-short"),               # a line shorter than a segment
    ((2, 30, 9), 25, 2, -2, "cols-clamped"),            # pad 50 clamped to 29
    ((2, 9, 40), 25, 3, -1, "rows-clamped"),
]


@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
@pytest.mark.parametrize("shape, r, passes, axis, name", CASES, ids=[c[-1] for c in CASES])
def test_model_against_plain_version(shape, r, passes, axis, name, u8):
    x = _planes(shape, seed=len(name), u8=u8)
    limit = 1e-3 * float(x.float().abs().max()) / 255
    got, use_rows = _model(x, r, passes, axis, out_u8=False)
    assert use_rows == (name.startswith("rows") and name != "rows-as-lines")
    want = k4.box_blur_scan_axis_ref(x, r, passes, axis, out_u8=False)
    assert float((got - want).abs().max()) <= limit
    got8, _ = _model(x, r, passes, axis, out_u8=True)
    want8 = k4.box_blur_scan_axis_ref(x, r, passes, axis, out_u8=True)
    assert int((got8.int() - want8.int()).abs().max()) <= 1


@pytest.mark.parametrize("shape, axis", [((3, 40, 300), -1), ((2, 1500, 7), -1),
                                         ((2, 300, 33), -2), ((2, 5000, 3), -2)])
@pytest.mark.parametrize("r", [1, 16, 333])
def test_first_pass_on_uint8_is_exact(shape, axis, r):
    """One pass over uint8: every window sum is an exact integer in float64,
    so both kernels' means equal the plain version's bit for bit."""
    x = _planes(shape, seed=r, u8=True)
    got, _ = _model(x, r, 1, axis, out_u8=False)
    assert torch.equal(got, k4.box_blur_scan_axis_ref(x, r, 1, axis, out_u8=False))


def test_segment_cuts():
    """The lines kernel's segments: at most one round of 64 in the first pass
    (a taller column takes longer segments), a window spanning q of them
    ends fewer than q values past a segment boundary, at most 192 totals a
    line; the models above cover tall columns and lines shorter than a
    segment."""
    for n, r, passes in ((2160, 400, 2), (1080, 625, 2), (20000, 4000, 3), (2160, 1, 2),
                         (33, 16, 1), (3760, 1200, 3), (20, 3, 2)):
        seg = k4._line_segment(n, r, passes)
        span, w = n + 2 * passes * r, 2 * r + 1
        assert -(-span // seg) <= k4._MAX_SEGMENTS
        assert k4.smem_bytes(n, r, passes, 0) <= 48 * 1024  # two sets of totals, 16 lines
        assert seg >= 32 and seg >= -(-(span - 2 * r) // 64)
        if w >= seg:
            q = -(-w // seg)
            assert q * seg - w < q
    stats = {}
    _lines_model(np.ones((1, 20000), np.float32), 4000, 3, stats)
    assert 32 < stats["segments"] <= 64  # a tall column: one round of longer segments
    stats = {}
    _lines_model(np.ones((1, 20), np.float32), 3, 2, stats)
    assert stats["short"]


def test_segment_policy_is_the_sources():
    """The Python mirror of the lines kernel's segment policy states the
    constants ``csrc/box_scan.cu`` compiles (16 lines a strip, 32 warps, 48
    KB of totals), and repeats ``line_segment``'s arithmetic."""
    import re

    from blur_algorithms_tpu_torch.utils import build

    text = (build._CSRC / "box_scan.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (kLine\w+) = (\d+);", text)}
    assert const["kLineCols"] == k4._LINE_COLS
    assert const["kLineWarps"] * 32 // const["kLineCols"] == k4._LINE_SEGMENTS
    assert "kLineMaxSegs = 48 * 1024 / (2 * kLineCols * 8)" in text
    assert k4._MAX_SEGMENTS == 48 * 1024 // (2 * k4._LINE_COLS * 8)
    body = text[text.index("int line_segment("):]
    body = body[:body.index("\n}\n")]
    for line in ("const int span = n + 2 * passes * r;",
                 "std::max(32, (span - 2 * r + kLineSegs - 1) / kLineSegs)",
                 "w >= target ? (w + w / target - 1) / (w / target) : target",
                 "std::max(seg, (span + kLineMaxSegs - 1) / kLineMaxSegs)"):
        assert line in body
