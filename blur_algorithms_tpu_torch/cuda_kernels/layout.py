"""uint8 RGB layout moves: interleaved ``(..., H, W, 3)`` <-> planar
``(..., 3, H, W)``.

No TPU kernel stands behind these: the JAX package's ``ops/layout.py`` moves
the axis with ``jnp.moveaxis``. The port's ``ops/layout.py`` takes them for
every uint8 -> uint8 move of CUDA frames with 3 channels, the two moves
around every uint8 route's kernels. A CUDA tensor, of any strides, launches
``layout_to_planar_u8`` / ``layout_from_planar_u8`` of ``csrc/layout.cu``
(16-pixel groups moved by 16-byte accesses and byte permutes where each
frame is one aligned run of bytes; else the strided path, which addresses
the input by its strides); a CPU tensor runs the plain version, the
``movedim(...).contiguous()`` expression the port ran before. The two give
the same bytes.
"""

from __future__ import annotations

import ctypes
import itertools
import math

import torch

from blur_algorithms_tpu_torch.utils import trace

__all__ = ["from_planar_u8", "from_planar_u8_ref", "to_planar_u8", "to_planar_u8_ref"]

MAX_LEAD = 4  # csrc/layout.cu: kMaxLead, the leading dims a launch addresses


def to_planar_u8_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``to_planar_u8``."""
    return x.movedim(-1, -3).contiguous()


def from_planar_u8_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``from_planar_u8``."""
    return x.movedim(-3, -1).contiguous()


def frames(x: torch.Tensor, channel_axis: int) -> tuple:
    """``x``'s frames as the C entries take them, strides in bytes:
    ``(lead_sizes, lead_strides, h, w, row, pixel, channel)``. The leading
    dims leave out those of size 1 and merge neighbours that one stride
    steps over; a frame whose rows follow each other (or of one row or one
    column) is one row of ``h * w`` pixels."""
    h, w = x.shape[-3:-1] if channel_axis == -1 else x.shape[-2:]
    if x.is_contiguous():  # what the rest gives, at less host time
        images = x.numel() // (3 * h * w)
        lead = ([images], [3 * h * w]) if images > 1 else ([], [])
        return (*lead, 1, h * w, 0, *((3, 1) if channel_axis == -1 else (1, h * w)))
    if channel_axis == -1:
        row, pixel, channel = x.stride()[-3:]
    else:
        channel, row, pixel = x.stride()[-3:]
    if w == 1:  # a column: a row of h pixels
        h, w, row, pixel = 1, h, 0, row
    elif h == 1 or row == w * pixel:
        h, w, row = 1, h * w, 0
    sizes, strides = [], []
    for n, s in zip(x.shape[:-3], x.stride()[:-3]):
        if n == 1:
            continue
        if sizes and strides[-1] == n * s:
            sizes[-1] *= n
            strides[-1] = s
        else:
            sizes.append(n)
            strides.append(s)
    return sizes, strides, h, w, row, pixel, channel


def launches(x: torch.Tensor, channel_axis: int) -> list[tuple]:
    """The launches that move ``x``: ``(input offset, output offset, *frames)``
    each, offsets in bytes from ``x.data_ptr()`` and the output's. Past
    ``MAX_LEAD`` leading dims, a launch for each index of the outer ones."""
    sizes, strides, *frame = frames(x, channel_axis)
    outer = len(sizes) - MAX_LEAD
    if outer <= 0:
        return [(0, 0, sizes, strides, *frame)]
    step = 3 * frame[0] * frame[1] * math.prod(sizes[outer:])
    return [(sum(i * s for i, s in zip(index, strides)), k * step, sizes[outer:], strides[outer:],
             *frame)
            for k, index in enumerate(itertools.product(*map(range, sizes[:outer])))]


def _launch(fn, entry: str, x: torch.Tensor, shape: tuple, channel_axis: int) -> torch.Tensor:
    """The launches of the C entry ``entry`` that move the CUDA frames ``x``
    into a new contiguous ``shape`` tensor, in the span ``launch.<entry>``,
    on the current stream of ``x``'s card (the entry makes the card
    current); each counted on ``fn``."""
    with trace.span(f"launch.{entry}"):
        out = torch.empty(shape, dtype=torch.uint8, device=x.device)
        if not out.numel():
            return out
        from blur_algorithms_tpu_torch.utils.build import load_library

        lib = load_library()
        device = x.get_device()
        # the raw stream handle: what torch.cuda.current_stream(device).cuda_stream
        # returns, without making a Stream object on every launch
        stream = torch._C._cuda_getCurrentRawStream(device)
        moves = launches(x, channel_axis)
        for i_off, o_off, sizes, strides, *frame in moves:
            dims = (ctypes.c_int64 * (2 * len(sizes) + 5))(*sizes, *strides, *frame)
            rc = getattr(lib, entry)(x.data_ptr() + i_off, out.data_ptr() + o_off, len(sizes),
                                     dims, device, stream)
            if rc:
                msg = lib.blur_cuda_error_string(rc).decode()
                raise RuntimeError(f"{entry} launch failed: CUDA error {rc} ({msg})")
    nbytes = trace.nbytes(x, out) // len(moves)
    for _ in moves:
        trace.launched(fn, entry, nbytes)
    return out


def _check(x: torch.Tensor, axis: int, what: str) -> None:
    if x.dtype != torch.uint8 or x.dim() < 3 or x.shape[axis] != 3:
        form = "(..., H, W, 3)" if axis == -1 else "(..., 3, H, W)"
        raise ValueError(f"{what} takes uint8 {form} frames, got {x.dtype} {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on CUDA or CPU tensors, not {x.device}")


def to_planar_u8(x: torch.Tensor) -> torch.Tensor:
    """uint8 ``(..., H, W, 3)`` -> contiguous ``(..., 3, H, W)``, the bytes
    of ``x.movedim(-1, -3).contiguous()``. A CUDA tensor, of any strides,
    launches the kernel; a CPU tensor runs the plain version; any other
    device raises. ``to_planar_u8.launches`` counts kernel launches."""
    _check(x, -1, "to_planar_u8")
    if x.device.type == "cpu":
        return to_planar_u8_ref(x)
    *lead, h, w, _ = x.shape
    return _launch(to_planar_u8, "layout_to_planar_u8", x, (*lead, 3, h, w), -1)


def from_planar_u8(x: torch.Tensor) -> torch.Tensor:
    """uint8 ``(..., 3, H, W)`` -> contiguous ``(..., H, W, 3)``, the bytes
    of ``x.movedim(-3, -1).contiguous()``; as ``to_planar_u8`` otherwise.
    ``from_planar_u8.launches`` counts kernel launches."""
    _check(x, -3, "from_planar_u8")
    if x.device.type == "cpu":
        return from_planar_u8_ref(x)
    *lead, _, h, w = x.shape
    return _launch(from_planar_u8, "layout_from_planar_u8", x, (*lead, h, w, 3), -3)


to_planar_u8.launches = 0
from_planar_u8.launches = 0
