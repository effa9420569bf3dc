"""The uint8 layout moves (``ops/layout.py``, ``cuda_kernels/layout.py``,
``csrc/layout.cu``) on the CPU.

Which inputs reach the kernel and which keep the torch expression; the
plain versions against ``movedim(...).contiguous()``; the wrapper's reading
of a tensor's strides into the frames and launches the C entries take; and
a NumPy model of the kernel's index math (its launch plan, the
``__byte_perm`` selectors read from the source, the 16-pixel groups, the
strided path) run over a view's own storage, its base on a 16-byte
boundary as an allocation's: every output byte written once, and the bytes
those of the torch expression. The card tests are in
``tests/test_torch_cuda.py``.
"""

import itertools
import pathlib
import re

import numpy as np
import pytest
import torch

from blur_algorithms_tpu_torch.cuda_kernels import layout as layout_kernels
from blur_algorithms_tpu_torch.ops import layout

SOURCE = (pathlib.Path(layout_kernels.__file__).resolve().parents[1] / "csrc" / "layout.cu")
THREADS = 256  # csrc/layout.cu: kThreads
PIXELS = {True: 8, False: 4}  # csrc/layout.cu: kPixelsOf<kToPlanar>, by direction


def _frames(shape, seed, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return torch.from_numpy(rng.integers(0, 256, size=shape, dtype=np.uint8))
    return torch.from_numpy((rng.random(shape) * 300 - 20).astype(dtype))


# views a caller may pass, of (4, 30, 40, 3) frames with the channels last
VIEWS = {
    "contiguous": lambda x: x,
    "crop": lambda x: x[..., 3:27, 5:38, :],
    "every_other_frame": lambda x: x[::2],
    "one_row": lambda x: x[..., 7:8, :, :],
    "one_column": lambda x: x[..., :, 9:10, :],
    "expanded": lambda x: x[:1].expand(3, *x.shape[1:]),
    "rgba_slice": None,  # the first 3 channels of 4
    "channels_apart": None,  # the other layout's bytes, its axes moved
}


def _view(name: str, planar: bool, seed: int = 3) -> torch.Tensor:
    """A uint8 CPU view of the named kind, channels last, or third from
    last when ``planar`` (the same view of planar frames)."""
    if name == "rgba_slice":
        x = _frames((4, 30, 40, 4), seed)[..., :3]
        return x.movedim(-1, -3) if planar else x
    if name == "channels_apart":
        if planar:
            return _frames((4, 30, 40, 3), seed).movedim(-1, -3)
        return _frames((4, 3, 30, 40), seed).movedim(-3, -1)
    if planar:
        return VIEWS[name](_frames((4, 3, 30, 40), seed).movedim(-3, -1)).movedim(-1, -3)
    return VIEWS[name](_frames((4, 30, 40, 3), seed))


# ---- routing ----


class _OnCard(torch.Tensor):
    """A CPU tensor that reads as a CUDA one to the router."""

    @property
    def is_cuda(self):
        return True


@pytest.fixture
def spies(monkeypatch):
    """The kernel wrappers replaced by their plain versions, counting calls."""
    calls = []

    def spy(name, ref):
        def run(x):
            calls.append(name)
            return ref(x.as_subclass(torch.Tensor))
        return run

    monkeypatch.setattr(layout_kernels, "to_planar_u8",
                        spy("to", layout_kernels.to_planar_u8_ref))
    monkeypatch.setattr(layout_kernels, "from_planar_u8",
                        spy("from", layout_kernels.from_planar_u8_ref))
    return calls


@pytest.mark.parametrize("shape", [(2, 24, 40, 3), (24, 40, 3), (1, 1, 7, 3)])
def test_uint8_rgb_on_the_card_takes_the_kernel_both_ways(spies, shape):
    x = _frames(shape, seed=1)
    planar = layout.to_planar(x.as_subclass(_OnCard), torch.uint8)
    back = layout.from_planar(planar.as_subclass(_OnCard))
    assert spies == ["to", "from"]
    assert torch.equal(planar.as_subclass(torch.Tensor), x.movedim(-1, -3).contiguous())
    assert torch.equal(back.as_subclass(torch.Tensor), x)


@pytest.mark.parametrize("name", list(VIEWS))
def test_uint8_rgb_views_on_the_card_take_the_kernel(spies, name):
    x, planes = _view(name, planar=False), _view(name, planar=True)
    got = layout.to_planar(x.as_subclass(_OnCard), torch.uint8)
    back = layout.from_planar(planes.as_subclass(_OnCard))
    assert spies == ["to", "from"]
    assert torch.equal(got.as_subclass(torch.Tensor), x.movedim(-1, -3).contiguous())
    assert torch.equal(back.as_subclass(torch.Tensor), planes.movedim(-3, -1).contiguous())


def _case(case: str, planar: bool):
    """An input of the named kind that does not take the kernel, and the
    dtype to move it to (None: the default)."""
    c = {"c1": 1, "c4": 4}.get(case, 3)
    shape = (2, c, 24, 40) if planar else (2, 24, 40, c)
    x = _frames(shape, seed=2, dtype=np.float32 if case == "float_in" else np.uint8)
    dtype = {"float_out": torch.float32, "default": None}.get(case, torch.uint8)
    return (x if case == "cpu" else x.as_subclass(_OnCard)), x, dtype


OTHER = ["float_in", "float_out", "c1", "c4", "cpu"]


# to_planar's default dtype is float32; from_planar's is uint8, which a
# uint8 input of 3 channels on the card takes the kernel to
@pytest.mark.parametrize("case", [*OTHER, "default"])
def test_other_moves_to_planar_keep_the_torch_expression(spies, case):
    x, plain, dtype = _case(case, planar=False)
    got = layout.to_planar(x) if dtype is None else layout.to_planar(x, dtype)
    want = plain.movedim(-1, -3).to(dtype or torch.float32).contiguous()
    assert spies == []
    assert got.dtype == want.dtype and torch.equal(got.as_subclass(torch.Tensor), want)


@pytest.mark.parametrize("case", OTHER)
def test_other_moves_from_planar_keep_the_torch_expression(spies, case):
    x, plain, dtype = _case(case, planar=True)
    got = layout.from_planar(x, dtype)
    want = plain.movedim(-3, -1)
    if dtype == torch.uint8 and plain.dtype != torch.uint8:
        want = layout.round_to_u8(want)
    want = want.to(dtype).contiguous()
    assert spies == []
    assert got.dtype == want.dtype and torch.equal(got.as_subclass(torch.Tensor), want)


# ---- the wrappers on the CPU: the plain versions ----


@pytest.mark.parametrize("shape", [(3, 20, 36, 3), (1001, 1777, 3), (5, 1, 1, 3)])
def test_plain_versions_are_the_torch_expression(shape):
    x = _frames(shape, seed=5)
    planar = layout_kernels.to_planar_u8(x)
    assert planar.is_contiguous() and planar.shape == (*shape[:-3], 3, *shape[-3:-1])
    assert torch.equal(planar, x.movedim(-1, -3).contiguous())
    back = layout_kernels.from_planar_u8(planar)
    assert back.is_contiguous() and torch.equal(back, x)
    assert torch.equal(back, planar.movedim(-3, -1).contiguous())


@pytest.mark.parametrize("bad", ["float", "c4", "2d"])
def test_wrappers_refuse_what_the_kernel_does_not_take(bad):
    x = {"float": torch.zeros((4, 5, 3)), "c4": torch.zeros((4, 5, 4), dtype=torch.uint8),
         "2d": torch.zeros((5, 3), dtype=torch.uint8)}[bad]
    with pytest.raises(ValueError, match="uint8"):
        layout_kernels.to_planar_u8(x)
    with pytest.raises(ValueError, match="uint8"):
        layout_kernels.from_planar_u8(x.movedim(-1, 0))


# ---- the frames and launches the wrapper passes ----


def test_wrapper_takes_the_sources_leading_dims_limit():
    limit = re.search(r"constexpr int kMaxLead = (\d+);", SOURCE.read_text())
    assert limit and int(limit.group(1)) == layout_kernels.MAX_LEAD


def test_model_takes_the_sources_pixels_a_thread():
    most = re.search(r"constexpr int kPixelsOf = kToPlanar \? (\d+) : (\d+);", SOURCE.read_text())
    assert most and (int(most.group(1)), int(most.group(2))) == (PIXELS[True], PIXELS[False])


@pytest.mark.parametrize("view, want", [
    # contiguous: one leading dim of 3P bytes, a frame one row of P pixels
    (lambda x: x, ([4], [3600], 1, 1200, 0, 3, 1)),
    (lambda x: x[0], ([], [], 1, 1200, 0, 3, 1)),
    (lambda x: x[::2], ([2], [7200], 1, 1200, 0, 3, 1)),
    (lambda x: x[:, 3:27, 5:38], ([4], [3600], 24, 33, 120, 3, 1)),  # a crop keeps its rows
    (lambda x: x[:, :, 9:10], ([4], [3600], 1, 30, 0, 120, 1)),  # a column: a row of H
    (lambda x: x[:1].expand(3, 30, 40, 3), ([3], [0], 1, 1200, 0, 3, 1)),
    (lambda x: x.view(2, 2, 30, 40, 3), ([4], [3600], 1, 1200, 0, 3, 1)),  # merged
    (lambda x: x.view(2, 2, 30, 40, 3)[:, :1], ([2], [7200], 1, 1200, 0, 3, 1)),  # size 1 out
    (lambda x: x.view(2, 2, 30, 40, 3).transpose(0, 1),
     ([2, 2], [3600, 7200], 1, 1200, 0, 3, 1)),  # not merged
    (lambda x: x.view(2, 2, 30, 40, 3)[:, :, ::3], ([4], [3600], 10, 40, 360, 3, 1)),
    (lambda x: x.movedim(-1, -3).contiguous().movedim(-3, -1),
     ([4], [3600], 1, 1200, 0, 1, 1200)),  # channels a plane apart
])
def test_frames_read_the_strides(view, want):
    x = view(torch.zeros((4, 30, 40, 3), dtype=torch.uint8))
    assert tuple(layout_kernels.frames(x, -1)) == want


def test_frames_of_planes_read_the_strides():
    planes = torch.zeros((4, 3, 30, 40), dtype=torch.uint8)
    assert tuple(layout_kernels.frames(planes, -3)) == ([4], [3600], 1, 1200, 0, 1, 1200)
    crop = planes[:, :, 3:27, 5:38]
    assert tuple(layout_kernels.frames(crop, -3)) == ([4], [3600], 24, 33, 40, 1, 1200)


def test_launches_split_past_the_leading_dims_limit():
    x = torch.zeros((3,) * 6 + (4, 5, 3), dtype=torch.uint8)[(slice(0, 2),) * 6]
    moves = layout_kernels.launches(x, -1)
    assert len(moves) == 4  # the outer 2 of 6 unmergeable leading dims
    strides = x.stride()[:6]
    for k, (i, j) in enumerate(itertools.product(range(2), range(2))):
        i_off, o_off, sizes, lead_strides, *frame = moves[k]
        assert i_off == i * strides[0] + j * strides[1] and o_off == k * 16 * 60
        assert sizes == [2] * 4 and lead_strides == list(strides[2:])
        assert frame == [1, 20, 0, 3, 1]


# ---- the NumPy model of csrc/layout.cu ----

_PERM = re.compile(r"__byte_perm\(__byte_perm\((\w), (\w), (0x[0-9a-fA-F]{4})\), (\w), "
                   r"(0x[0-9a-fA-F]{4})\)")


def _source_perms():
    """The six nested ``__byte_perm`` of the source, in order: channels 0-2
    of to_planar, then interleaved words x, y, z of from_planar, each as
    ``(a, b, sel0, c, sel1)``."""
    perms = [(a, b, int(s0, 16), c, int(s1, 16)) for a, b, s0, c, s1
             in _PERM.findall(SOURCE.read_text())]
    assert len(perms) == 6
    return perms[:3], perms[3:]


def _byte_perm(x, y, sel):
    """CUDA's ``__byte_perm(x, y, sel)`` on uint32 arrays (selector nibbles
    0-7 only: the source uses no sign-replicating mode)."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        s = (sel >> (4 * i)) & 0xF
        assert s < 8
        out |= src[s] << np.uint32(8 * i)
    return out


def _perm(words, spec):
    a, b, s0, c, s1 = spec
    return _byte_perm(_byte_perm(words[a], words[b], s0), words[c], s1)


def _plan(to_planar: bool, in_addr: int, out_addr: int, sizes, strides, h, w, row, pixel,
          channel):
    """The C entry's choice (``launch``): the groups path, the images and
    their step, and the strided path's pixels a thread and stretches a row."""
    images, pixels = int(np.prod(sizes)), h * w
    step = strides[0] if len(sizes) == 1 else 3 * pixels
    run = h == 1 and ((pixel, channel) == (3, 1) if to_planar else (pixel, channel) == (1, pixels))
    groups = (run and len(sizes) <= 1 and pixels % 16 == 0 and step % 16 == 0
              and in_addr % 16 == 0 and out_addr % 16 == 0)
    per_thread = min(PIXELS[to_planar], -(-w // THREADS))
    chunks = -(-w // (per_thread * THREADS))
    return groups, images, step, per_thread, chunks


class _Memory:
    """The input's storage and the output as device bytes, both from a
    16-byte boundary; each store counted, each 16-byte access checked for
    alignment."""

    def __init__(self, storage: np.ndarray, out_bytes: int):
        self.src = storage
        self.dst = np.zeros(out_bytes, np.uint8)
        self.writes = np.zeros(out_bytes, np.int64)

    def load16(self, addr):  # uint32 words (n, 4) of 16-byte loads at addr (n,)
        assert np.all(addr % 16 == 0)
        return np.ascontiguousarray(self.src[addr[:, None] + np.arange(16)]).view(
            "<u4").reshape(-1, 4).astype(np.uint32)

    def store16(self, addr, words):
        assert np.all(addr % 16 == 0)
        self.store((addr[:, None] + np.arange(16)).ravel(),
                   words.astype("<u4").view(np.uint8).ravel())

    def store(self, addr, values):
        self.dst[addr] = values
        np.add.at(self.writes, addr, 1)


def _groups(mem, to_planar, base, o_off, images, step, pixels):
    """``layout_u8_groups_kernel``: image n's input at base + n * step and
    its output at o_off + 3 n P, a block's 256 groups at a time."""
    to_sel, from_sel = _source_perms()
    ngroups = pixels >> 4
    for n in range(images):
        src, dst = base + n * step, o_off + 3 * n * pixels
        for g0 in range(0, ngroups, THREADS):  # a block's groups
            nb = min(ngroups - g0, THREADS)
            p0 = 16 * g0
            p = p0 + 16 * np.arange(nb)
            if to_planar:
                w = mem.load16(src + 3 * p0 + 16 * np.arange(3 * nb)).reshape(nb, 12)
                for c in range(3):
                    quads = [{"x": w[:, 3 * q], "y": w[:, 3 * q + 1], "z": w[:, 3 * q + 2]}
                             for q in range(4)]
                    word = np.stack([_perm(qd, to_sel[c]) for qd in quads], axis=1)
                    mem.store16(dst + c * pixels + p, word)
            else:
                r, gr, b = (mem.load16(src + c * pixels + p) for c in range(3))
                out = np.zeros((nb, 12), np.uint32)
                for q in range(4):
                    ops = {"r": r[:, q], "g": gr[:, q], "b": b[:, q]}
                    for k in range(3):
                        out[:, 3 * q + k] = _perm(ops, from_sel[k])
                mem.store16(dst + 3 * p0 + 16 * np.arange(3 * nb), out.reshape(3 * nb, 4))


def _strided(mem, to_planar, base, o_off, sizes, strides, h, w, row, pixel, channel,
             per_thread, chunks):
    """``layout_u8_strided_kernel``: each block b of rows x chunks, each of
    its threads' pixels x0 + 256 i + t, the frame's leading indices
    innermost first."""
    rows, pixels = int(np.prod(sizes)) * h, h * w
    b = np.arange(rows * chunks)
    r = b // chunks
    x0 = (b - r * chunks) * per_thread * THREADS
    x = (x0[:, None] + np.arange(per_thread * THREADS)).ravel()  # 256 i + t
    r = np.repeat(r, per_thread * THREADS)
    keep = x < w
    x, r = x[keep], r[keep]
    n, y = r // h, r % h
    src = base + y * row + x * pixel
    m = n.copy()
    for size, stride in zip(reversed(sizes), reversed(strides)):
        src += (m % size) * stride
        m //= size
    dst = o_off + 3 * n * pixels
    for c in range(3):
        values = mem.src[src + c * channel]
        mem.store(dst + c * pixels + y * w + x if to_planar else dst + 3 * (y * w + x) + c,
                  values)


def _model(x: torch.Tensor, to_planar: bool):
    """Run the launches the wrapper makes for the CPU view ``x`` over its
    own storage into an output of ``x``'s bytes: the output's bytes and the
    paths taken."""
    storage = torch.empty(0, dtype=torch.uint8).set_(x.untyped_storage()).numpy()
    mem = _Memory(storage, x.numel())
    paths = []
    for i_off, o_off, *frame in layout_kernels.launches(x, -1 if to_planar else -3):
        base = x.storage_offset() + i_off
        groups, images, step, per_thread, chunks = _plan(to_planar, base, o_off, *frame)
        if groups:
            _groups(mem, to_planar, base, o_off, images, step, frame[2] * frame[3])
        else:
            _strided(mem, to_planar, base, o_off, *frame, per_thread, chunks)
        paths.append("groups" if groups else "strided")
    assert np.all(mem.writes == 1), "an output byte not written once"
    return mem.dst, paths


def test_source_selectors_permute_channels_as_documented():
    to_sel, from_sel = _source_perms()
    assert [s[:2] + s[3:4] for s in to_sel] == [("x", "y", "z")] * 3
    assert [s[:2] + s[3:4] for s in from_sel] == [("r", "g", "b"), ("g", "r", "b"),
                                                  ("r", "g", "b")]
    # to_planar: channel c of pixels 0-3 is bytes c, c + 3, c + 6, c + 9
    words = np.arange(12, dtype=np.uint8).view("<u4").astype(np.uint32)
    for c in range(3):
        got = _perm({"x": words[:1], "y": words[1:2], "z": words[2:3]}, to_sel[c])
        assert list(got.astype("<u4").view(np.uint8)) == [c, c + 3, c + 6, c + 9]


def _in_buffer(shape, seed: int, offset: int = 0) -> torch.Tensor:
    """Random uint8 values of ``shape``, a contiguous view ``offset`` bytes
    into a 1-D buffer."""
    n = int(np.prod(shape))
    return _frames((n + offset,), seed)[offset:].view(shape)


# (name, a view of interleaved frames, their shape, the buffer offset of
# their base, the paths of to_planar, those of from_planar); from_planar
# takes the same view of the frames' planes
MODEL_CASES = [
    ("batch", lambda x: x, (2, 48, 64, 3), 0, ["groups"], ["groups"]),
    ("frame", lambda x: x, (40, 56, 3), 0, ["groups"], ["groups"]),
    ("four_blocks", lambda x: x, (2, 96, 136, 3), 0, ["groups"], ["groups"]),  # 816 groups
    ("every_other", lambda x: x[::2], (4, 48, 64, 3), 0, ["groups"], ["groups"]),
    ("expanded", lambda x: x[:1].expand(3, -1, -1, -1), (2, 48, 64, 3), 0, ["groups"],
     ["groups"]),
    ("column", lambda x: x, (2, 64, 1, 3), 0, ["groups"], ["groups"]),  # a row of 64
    ("base_one_in", lambda x: x, (2, 48, 64, 3), 1, ["strided"], ["strided"]),
    ("p_1500", lambda x: x, (2, 30, 50, 3), 0, ["strided"], ["strided"]),
    ("ragged", lambda x: x, (1001, 1777, 3), 0, ["strided"], ["strided"]),
    ("ragged_batch_base_7", lambda x: x, (2, 301, 477, 3), 7, ["strided"], ["strided"]),
    ("crop", lambda x: x[:, 5:45, 3:70], (2, 60, 80, 3), 0, ["strided"], ["strided"]),
    ("crop_16", lambda x: x[:, 5:45, 16:48], (2, 60, 80, 3), 0, ["strided"], ["strided"]),
    # two whole rows: one aligned run of each frame's bytes, but the planes
    # of the two rows lie a frame's plane apart
    ("two_rows", lambda x: x[:, 7:9], (2, 60, 80, 3), 0, ["groups"], ["strided"]),
    ("wide_rows", lambda x: x[:, 1:3], (1, 4, 9000, 3), 0, ["strided"], ["strided"]),
    ("six_leading", lambda x: x[(slice(0, 2),) * 6], (3,) * 6 + (4, 5, 3), 0, ["strided"] * 4,
     ["strided"] * 4),
]
_IDS = [c[0] for c in MODEL_CASES]


@pytest.mark.parametrize("name, view, shape, offset, paths, _", MODEL_CASES, ids=_IDS)
def test_model_to_planar_equals_the_torch_expression(name, view, shape, offset, paths, _):
    x = view(_in_buffer(shape, 6, offset))
    got, taken = _model(x, True)
    assert taken == paths
    assert np.array_equal(got, x.movedim(-1, -3).contiguous().numpy().ravel())


@pytest.mark.parametrize("name, view, shape, offset, _, paths", MODEL_CASES, ids=_IDS)
def test_model_from_planar_equals_the_torch_expression(name, view, shape, offset, _, paths):
    planar_shape = (*shape[:-3], 3, *shape[-3:-1])
    planes = view(_in_buffer(planar_shape, 7, offset).movedim(-3, -1)).movedim(-1, -3)
    got, taken = _model(planes, False)
    assert taken == paths
    assert np.array_equal(got, planes.movedim(-3, -1).contiguous().numpy().ravel())


@pytest.mark.parametrize("name", ["rgba_slice", "channels_apart"])
def test_model_takes_other_channel_strides(name):
    x, planes = _view(name, planar=False), _view(name, planar=True)
    got, taken = _model(x, True)
    assert taken == ["strided"]
    assert np.array_equal(got, x.movedim(-1, -3).contiguous().numpy().ravel())
    got, taken = _model(planes, False)
    assert taken == ["strided"]
    assert np.array_equal(got, planes.movedim(-3, -1).contiguous().numpy().ravel())
