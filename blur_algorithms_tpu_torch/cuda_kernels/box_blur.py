"""Box blur by prefix sums (K4), the ``box_scan`` engine.

The port of the JAX package's ``pallas_kernels/box_blur_pallas.py``:
``box_blur_scan_axis`` launches the CUDA kernel of ``csrc/box_scan.cu`` on
a CUDA tensor and runs its plain PyTorch version ``box_blur_scan_axis_ref``
on a CPU tensor. Each runs ``passes`` sliding means of width ``2r + 1``
along one axis of the reflect-101-padded planes, with the JAX wrapper's
radius clamp (``pad = min(passes * r, n - 1)``, ``r = pad // passes``, a
pass-through where that leaves 0), uint8 or float32 in, float32 or uint8
out (``clip(floor(x + 0.5), 0, 255)``).

Both sum in float64 (the kernel by a block scan of register runs, or by
segment totals and running sums, the plain version by ``torch.cumsum``) and
round each pass's mean to float32, so they agree to float rounding at any
line length; the JAX kernel sums in float32.

- ``box_blur_scan``: float planes, rows then columns, differentiable (the
  backward pass is the blur's adjoint on the folded box plan, as the JAX
  ``_box_blur_bwd``);
- ``box_blur_scan_u8``: uint8 planes in and out, one float32 intermediate
  between the two axes.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from blur_algorithms_tpu_torch.ops.adjoint import blur_adjoint
from blur_algorithms_tpu_torch.ops.layout import round_to_u8
from blur_algorithms_tpu_torch.ops.pad import reflect_101
from blur_algorithms_tpu_torch.ops.plan import BlurPlan, make_plan
from blur_algorithms_tpu_torch.utils.hw import device_spec
from blur_algorithms_tpu_torch.utils import trace

__all__ = [
    "box_blur_scan",
    "box_blur_scan_axis",
    "box_blur_scan_axis_ref",
    "box_blur_scan_u8",
    "clamped_radius",
    "smem_bytes",
]

# Preferred longest span (tile + halo) of the rows kernel, in values: odd
# runs of up to 31 values a thread in registers, 8 bytes of shared memory a
# value (its float64 prefix); a longer line is cut into tiles, or takes runs
# of 63 up to _SPAN_MAX, or runs the lines kernel where not even that holds
# the halo and a tile of _MIN_TILE.
_SPAN_PREF = 256 * 31
_SPAN_MAX = 256 * 63
_MIN_TILE = 1024
# The lines kernel, as csrc/box_scan.cu states it (kLineCols, kLineSegs,
# kLineMaxSegs): a block runs 64 segments of its strip of 16 lines at once,
# and two sets of float64 totals of up to _MAX_SEGMENTS segments a line for
# the strip's lines fill 48 KB of shared memory.
_LINE_COLS = 16
_LINE_SEGMENTS = 64
_MAX_SEGMENTS = 48 * 1024 // (2 * _LINE_COLS * 8)


def clamped_radius(n: int, r: int, passes: int) -> int:
    """The per-pass radius after the JAX wrapper's clamp: the whole pad
    ``passes * r`` stays within ``n - 1`` (0 means pass-through)."""
    if r <= 0 or n <= 1:
        return 0
    return min(passes * r, n - 1) // passes


def _check(planar: torch.Tensor, axis: int) -> int:
    if planar.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"K4 takes uint8 or float32 planes, got {planar.dtype}")
    if planar.ndim < 2:
        raise ValueError("K4 takes planes (..., H, W)")
    if axis not in (-1, -2):
        raise ValueError(f"K4 scans axis -1 or -2, got {axis}")
    return axis


def _passthrough(planar: torch.Tensor, out_u8: bool) -> torch.Tensor:
    if out_u8:
        return planar if planar.dtype == torch.uint8 else round_to_u8(planar)
    return planar.to(torch.float32)


def box_blur_scan_axis_ref(planar: torch.Tensor, r: int, passes: int = 2,
                           axis: int = -1, out_u8: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K4 along ``axis`` of ``(..., H, W)``.

    Per pass: float64 exclusive cumulative sum of the float32 line, the
    window difference times ``1 / (2r + 1)`` in float64, rounded to
    float32. Runs on whatever device the input lies on."""
    axis = _check(planar, axis)
    eff = clamped_radius(planar.shape[axis], int(r), int(passes))
    if eff == 0:
        return _passthrough(planar, out_u8)
    x = planar.movedim(axis, -1)
    pad = passes * eff
    y = reflect_101(x, [(pad, pad)]).to(torch.float32)
    w = 2 * eff + 1
    for _ in range(passes):
        cs = F.pad(torch.cumsum(y.to(torch.float64), dim=-1), (1, 0))
        m = y.shape[-1] - 2 * eff
        y = ((cs[..., w : w + m] - cs[..., :m]) * (1.0 / w)).to(torch.float32)
    y = y.movedim(-1, axis)
    return round_to_u8(y) if out_u8 else y.contiguous()


def _rows_tile(n: int, pad: int, smem_limit: int) -> int:
    """Outputs per tile of the rows kernel, or 0 for the lines kernel."""
    if n + 2 * pad <= _SPAN_PREF:
        return n
    cap = min(_SPAN_MAX, (smem_limit - 1024) // 8 - 1)
    for limit in (_SPAN_PREF, cap):
        t = limit - 2 * pad
        if t >= _MIN_TILE:
            tiles = -(-n // t)
            return -(-n // tiles)
    return 0


def _line_segment(n: int, r: int, passes: int) -> int:
    """Outputs per segment of the lines kernel for lines of ``n`` values at
    per-pass radius ``r``, as ``line_segment`` of ``csrc/box_scan.cu``
    chooses them (this mirror serves the CPU model and ``smem_bytes``):
    about one round of the block's 64 segments in the first pass,
    ``ceil((2r + 1) / q)`` where the window spans ``q`` of them (a segment's
    first window sum is then ``q`` segment totals less fewer than ``q``
    values), and no more than ``_MAX_SEGMENTS`` segments a line."""
    span = n + 2 * passes * r
    target = max(32, -(-(span - 2 * r) // _LINE_SEGMENTS))
    w = 2 * r + 1
    seg = -(-w // (w // target)) if w >= target else target
    return max(seg, -(-span // _MAX_SEGMENTS))


def smem_bytes(n: int, r: int, passes: int, tile: int) -> int:
    """Dynamic shared memory of K4's launch along lines of ``n`` values at
    per-pass radius ``r``: the rows kernel's for a tile of ``tile`` outputs
    (float64 prefixes of its span and the eight warp totals), or with
    ``tile`` 0 the lines kernel's (two sets of segment totals)."""
    if tile:
        return (tile + 2 * passes * r + 1 + 8) * 8
    seg = _line_segment(n, r, passes)
    return 2 * -(-(n + 2 * passes * r) // seg) * _LINE_COLS * 8


def box_blur_scan_axis(planar: torch.Tensor, r: int, passes: int = 2,
                       axis: int = -1, out_u8: bool = False) -> torch.Tensor:
    """``passes`` box means of width ``2r + 1`` along ``axis`` (-1 or -2)
    of uint8 or float32 ``(..., H, W)`` -> float32, or uint8 with
    ``out_u8``.

    A CUDA tensor launches K4 (``csrc/box_scan.cu``); a CPU tensor runs the
    plain version. Any other device or a non-contiguous CUDA tensor raises.
    ``box_blur_scan_axis.launches`` counts kernel launches.
    """
    axis = _check(planar, axis)
    r, passes = int(r), int(passes)
    if passes < 1:
        raise ValueError(f"passes must be >= 1, got {passes}")
    eff = clamped_radius(planar.shape[axis], r, passes)
    if eff == 0:
        return _passthrough(planar, out_u8)
    if planar.device.type == "cpu":
        return box_blur_scan_axis_ref(planar, r, passes, axis, out_u8)
    if planar.device.type != "cuda":
        raise ValueError(f"K4 runs on CUDA or CPU tensors, not {planar.device}")
    if not planar.is_contiguous():
        raise ValueError("K4 needs contiguous planes")
    from blur_algorithms_tpu_torch.utils.build import load_library

    h, w = planar.shape[-2:]
    x = planar.reshape(-1, h, w)
    with trace.span("launch.box_scan_axis"):
        out = torch.empty(x.shape, dtype=torch.uint8 if out_u8 else torch.float32,
                          device=x.device)
        if x.shape[0] == 0:
            return out.reshape(planar.shape)
        n, pad = (w, h)[axis == -2], passes * eff
        tile = 0
        if axis == -1:
            tile = _rows_tile(n, pad, device_spec(x.device).smem_optin_bytes)
        scratch_len = n + 2 * pad - 2 * eff  # the first pass's output
        scratch = [None, None]
        if tile == 0 and passes > 1:
            for k in range(min(passes - 1, 2)):
                scratch[k] = torch.empty(x.shape[0] * (w if axis == -2 else h)
                                         * scratch_len, dtype=torch.float32,
                                         device=x.device)
        lib = load_library()
        with torch.cuda.device(x.device):
            rc = lib.box_scan_axis(
                x.data_ptr(), out.data_ptr(),
                *(s.data_ptr() if s is not None else None for s in scratch),
                int(x.dtype == torch.uint8), int(out_u8), x.shape[0], h, w,
                int(axis == -1), eff, passes, tile, scratch_len,
                torch.cuda.current_stream(x.device).cuda_stream,
            )
    if rc:
        msg = lib.blur_cuda_error_string(rc).decode()
        raise RuntimeError(f"K4 launch failed: CUDA error {rc} ({msg})")
    trace.launched(box_blur_scan_axis, "box_scan_axis", trace.nbytes(x, out, *scratch))
    return out.reshape(planar.shape)


box_blur_scan_axis.launches = 0


@functools.lru_cache(maxsize=64)
def _box_plan(h: int, w: int, radius: int, passes: int) -> BlurPlan:
    return make_plan((h, w), radius, kernel="box_fast", box_passes=passes)


class _BoxBlurScan(torch.autograd.Function):
    """Forward K4 on rows then columns; backward the blur's adjoint on the
    folded box plan (the same per-axis clamp as the scan)."""

    @staticmethod
    def forward(ctx, planar: torch.Tensor, radius: int, passes: int) -> torch.Tensor:
        ctx.radius, ctx.passes = radius, passes
        y = box_blur_scan_axis(planar, radius, passes, -1)
        return box_blur_scan_axis(y, radius, passes, -2)

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        plan = _box_plan(ct.shape[-2], ct.shape[-1], ctx.radius, ctx.passes)
        return blur_adjoint(ct, plan), None, None


def box_blur_scan(planar: torch.Tensor, radius: int, passes: int = 2) -> torch.Tensor:
    """FastBoxBlur semantics on float planar ``(..., H, W)`` -> float32:
    ``passes`` box passes of width ``2 * radius + 1`` per axis, rows then
    columns, reflect-101 borders. Differentiable."""
    if planar.dtype != torch.float32:
        planar = planar.to(torch.float32)
    return _BoxBlurScan.apply(planar, int(radius), int(passes))


def box_blur_scan_u8(planar_u8: torch.Tensor, radius: int, passes: int = 2) -> torch.Tensor:
    """uint8 planar ``(..., H, W)`` -> uint8 through K4: the rows pass reads
    uint8 and writes float32, the columns pass rounds back to uint8."""
    if planar_u8.dtype != torch.uint8:
        raise TypeError(f"expected uint8 planes, got {planar_u8.dtype}")
    y = box_blur_scan_axis(planar_u8, int(radius), int(passes), -1)
    return box_blur_scan_axis(y, int(radius), int(passes), -2, out_u8=True)
