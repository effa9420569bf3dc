"""A5 and A4: the padded frames that K1's assembled form reads.

The port of the JAX ``pallas_kernels/fused_dma.py:_assemble_padded``
(``_assemble_kernel``, with the edge strips of ``_topbot_strips`` and
``_lr_borders``): uint8 planes ``(..., h, w)`` -> ``(..., hp, wp)`` with the
planes at ``(orh, orw)``, reflect-101 borders of ``min(rh, h - 1)`` rows and
``min(rw, w - 1)`` columns around them, and zeros in the rest (the JAX
frame's alignment slack and clamped reflection). A CUDA tensor launches
``assemble_padded_u8`` of ``csrc/fused_dma.cu``; a CPU tensor runs the plain
version ``assemble_padded_ref`` (any dtype). The function takes the JAX
geometry ``(rh, rw, orh, orw, hp, wp)`` as it is; K1's assembled form asks
for its own (``fused_dma.k1_geometry``: the planes at ``(rh, rw)``, rows a
multiple of 16 bytes, so every window starts on a 16-byte boundary).

A4 (``assemble_padded_prepad``) is the port of the JAX
``_assemble_padded_prepad`` (``_assemble_kernel4``): a shard whose rows
already carry the caller's halo rows (``(..., hs, w)``, ``hs = h + 2rh``,
the sharded path's per-shard step) -> ``(..., hp, wp)`` with the rows as
given from row 0, reflect-101 columns around them at ``orw`` and zeros in
the rest. The JAX kernel takes one buffer, which ``shard_map`` concatenates
from the neighbours' halo rows and the block; the port's takes the rows
where they lie, as a ``HaloedRows`` of up to three row segments (views of
the frame, the neighbours' edge rows, or the block's own edge rows read in
reverse order for the reflect-101 halo at the frame's edge), or as one
tensor, its one-segment case. On a CUDA tensor it launches
``assemble_padded_prepad_rows_u8`` of ``csrc/fused_dma.cu``.
"""

from __future__ import annotations

import math
import struct
from typing import NamedTuple

import torch

from blur_algorithms_tpu_torch.ops.pad import reflect_101
from blur_algorithms_tpu_torch.utils import trace

__all__ = [
    "HaloedRows",
    "assemble_padded",
    "assemble_padded_prepad",
    "assemble_padded_prepad_ref",
    "assemble_padded_prepad_rows_ref",
    "assemble_padded_ref",
]


def _check(h: int, w: int, rh: int, rw: int, orh: int, orw: int, hp: int, wp: int):
    if min(rh, rw) < 0 or orh < min(rh, h - 1) or orw < min(rw, w - 1) or hp < 1 or wp < 1:
        raise ValueError(f"the frame ({hp}, {wp}) at {(orh, orw)} cannot hold borders "
                         f"{(rh, rw)} of {(h, w)} planes")


def _planes_hw(x) -> tuple[int, int]:
    if len(x.shape) < 2:
        raise ValueError(f"expected planes (..., h, w), got {tuple(x.shape)}")
    return x.shape[-2], x.shape[-1]


def assemble_padded_ref(x: torch.Tensor, rh: int, rw: int, orh: int, orw: int,
                        hp: int, wp: int) -> torch.Tensor:
    """Plain PyTorch version of A5: ``reflect_101`` by the clamped radii,
    placed at ``(orh - min(rh, h - 1), orw - min(rw, w - 1))`` in a zero
    ``(..., hp, wp)`` frame (cut at its edges)."""
    h, w = _planes_hw(x)
    _check(h, w, rh, rw, orh, orw, hp, wp)
    rb, rcb = min(rh, h - 1), min(rw, w - 1)
    xr = reflect_101(x, [(rb, rb), (rcb, rcb)])
    r0, c0 = orh - rb, orw - rcb
    out = x.new_zeros((*x.shape[:-2], hp, wp))
    nr, nc = max(0, min(xr.shape[-2], hp - r0)), max(0, min(xr.shape[-1], wp - c0))
    out[..., r0 : r0 + nr, c0 : c0 + nc] = xr[..., :nr, :nc]
    return out


def assemble_padded(x: torch.Tensor, rh: int, rw: int, orh: int, orw: int,
                    hp: int, wp: int) -> torch.Tensor:
    """A5: ``(..., h, w)`` -> ``(..., hp, wp)``, as ``assemble_padded_ref``.

    A CUDA tensor (uint8, contiguous, ``wp`` a multiple of 16) launches the
    kernel; a CPU tensor runs the plain version; any other device raises.
    ``assemble_padded.launches`` counts kernel launches."""
    _check(*_planes_hw(x), rh, rw, orh, orw, hp, wp)
    if x.device.type == "cpu":
        return assemble_padded_ref(x, rh, rw, orh, orw, hp, wp)
    if x.device.type != "cuda":
        raise ValueError(f"A5 runs on CUDA or CPU tensors, not {x.device}")
    if x.dtype != torch.uint8 or not x.is_contiguous() or wp % 16:
        raise ValueError("A5 takes contiguous uint8 planes and a frame width that is a "
                         f"multiple of 16 (got {x.dtype}, wp {wp})")
    from blur_algorithms_tpu_torch.utils.build import load_library

    with trace.span("launch.assemble_padded_u8"):
        h, w = x.shape[-2:]
        planes = x.reshape(-1, h, w)
        if planes.shape[0] > 65535:
            raise ValueError(f"A5 takes at most 65535 planes, got {planes.shape[0]}")
        out = torch.empty((planes.shape[0], hp, wp), dtype=torch.uint8, device=x.device)
        if planes.shape[0]:
            lib = load_library()
            with torch.cuda.device(x.device):
                rc = lib.assemble_padded_u8(
                    planes.data_ptr(), out.data_ptr(), planes.shape[0], h, w, rh, rw, orh,
                    orw, hp, wp, torch.cuda.current_stream(x.device).cuda_stream)
            if rc:
                msg = lib.blur_cuda_error_string(rc).decode()
                raise RuntimeError(f"A5 launch failed: CUDA error {rc} ({msg})")
            trace.launched(assemble_padded, "assemble_padded_u8", trace.nbytes(planes, out))
    return out.reshape(*x.shape[:-2], hp, wp)


assemble_padded.launches = 0




class HaloedRows(NamedTuple):
    """A shard's rows with their halo rows, as up to three row segments
    where they lie: ``top`` (``r`` rows above the block, or None), the
    ``block``, ``bot`` (``r`` rows below it, or None). Each part is a
    ``(..., rows, w)`` view with the same leading shape and width, whose
    leading dims fold into one plane stride. ``top_reversed`` /
    ``bot_reversed`` mark a part whose rows stand in reverse order (the
    reflect-101 halo at the frame's top or bottom edge: the block's own rows
    ``1..r`` or ``lo..lo + r``, which a view cannot reverse, having no
    negative strides). ``cat()`` is the one contiguous tensor
    ``torch.cat([top.flip?, block, bot.flip?], dim=-2)`` that the rows stand
    for; A4 reads the parts without it. A named tuple: it is made for
    every shard of every sharded call, and costs little to make."""

    top: torch.Tensor | None
    block: torch.Tensor
    bot: torch.Tensor | None
    top_reversed: bool = False
    bot_reversed: bool = False

    def parts(self) -> list[tuple[torch.Tensor, bool]]:
        """The segments in order, each with its reversed flag."""
        return [(t, rev) for t, rev in ((self.top, self.top_reversed), (self.block, False),
                                        (self.bot, self.bot_reversed)) if t is not None]

    @property
    def shape(self) -> torch.Size:
        rows = sum(t.shape[-2] for t in (self.top, self.block, self.bot) if t is not None)
        return self.block.shape[:-2] + (rows, self.block.shape[-1])

    @property
    def dtype(self) -> torch.dtype:
        return self.block.dtype

    @property
    def device(self) -> torch.device:
        return self.block.device

    def cat(self) -> torch.Tensor:
        return torch.cat([t.flip(-2) if rev else t for t, rev in self.parts()], dim=-2)


def _prepad_rows(hs: int, w: int, rw: int, orw: int, hp: int, wp: int) -> int:
    """A4's frame height: ``hp``, or ``hp + 8`` where ``hp`` does not pass
    the shard's last whole group of 8 rows (the JAX frame keeps a bottom
    strip of at least 8 rows there; the port's K1a frames never need it)."""
    _check(hs, w, 0, rw, 0, orw, hp, wp)
    return hp if hp > (hs // 8) * 8 else hp + 8


def assemble_padded_prepad_ref(x: torch.Tensor, rw: int, orw: int, hp: int,
                               wp: int) -> torch.Tensor:
    """Plain PyTorch version of A4 (the JAX ``_assemble_padded_prepad``):
    ``(..., hs, w)`` -> ``(..., hp, wp)`` with the rows as given at ``(0,
    orw)``, reflect-101 columns (clamped to ``w - 1``, zeros past it) and
    zeros in the slack; ``hp + 8`` rows where ``hp <= 8 * (hs // 8)``."""
    hp = _prepad_rows(*_planes_hw(x), rw, orw, hp, wp)
    return assemble_padded_ref(x, 0, rw, 0, orw, hp, wp)


def assemble_padded_prepad_rows_ref(rows: HaloedRows, rw: int, orw: int, hp: int,
                                    wp: int) -> torch.Tensor:
    """Plain PyTorch version of A4 on row segments: A4's plain version on
    ``rows.cat()``."""
    return assemble_padded_prepad_ref(rows.cat(), rw, orw, hp, wp)


def _plane_stride(shape, stride) -> int | None:
    """The stride of a part's planes, its leading dims (``shape[:-2]``)
    folded into one; 0 for a single plane; None where they do not fold."""
    ps = span = 0
    for k in range(len(shape) - 3, -1, -1):  # innermost leading dim first
        if shape[k] == 1:
            continue
        if span and stride[k] != span:
            return None
        ps = ps or stride[k]
        span = stride[k] * shape[k]
    return ps


_SEGMENTS = struct.Struct("15q")  # the kernel's segment table: three segments of 5 int64


def _segment_args(parts: list[tuple[torch.Tensor, bool]], device: int) -> tuple[bytes, int]:
    """The kernel's segment table for CUDA row ``parts`` (``(tensor,
    reversed)``, in order) on card ``device``: address, plane stride, row
    stride, rows, reversed, a part (zeros past the last), packed as the C
    entry reads it; and the parts' rows together. ValueError where the
    kernel cannot read a part in place (another card or dtype, another
    leading shape or width, a row not contiguous, leading dims that do not
    fold into one plane stride)."""
    lead, w = parts[0][0].shape[:-2], parts[0][0].shape[-1]
    vals, hs, folded = [], 0, None  # folded: the last leading strides and their fold
    for t, rev in parts:
        shape, stride = t.shape, t.stride()
        if (t.dtype is not torch.uint8 or t.get_device() != device or shape[:-2] != lead
                or shape[-1] != w or stride[-1] != 1):
            raise ValueError("A4 takes uint8 row segments on one card, of one leading "
                             "shape and width, each row contiguous")
        if folded is None or stride[:-2] != folded[0]:  # views of one frame share them
            folded = stride[:-2], _plane_stride(shape, stride)
            if folded[1] is None:
                raise ValueError("A4 needs each segment's leading dims to fold into one "
                                 f"plane stride, not strides {stride} of {tuple(shape)}")
        vals += (t.data_ptr(), folded[1], stride[-2], shape[-2], rev)
        hs += shape[-2]
    return _SEGMENTS.pack(*vals, *(0,) * (15 - len(vals))), hs


_entry = None  # the kernel's ctypes function, once the library is loaded


def _launch(entry, parts: list[tuple[torch.Tensor, bool]], rw: int, orw: int, hp: int,
            wp: int) -> torch.Tensor:
    """One launch of ``entry`` (``assemble_padded_prepad_rows_u8`` of a
    library) on CUDA row ``parts`` (``HaloedRows.parts()``) into a new
    ``(..., hp, wp)`` frame (``hp`` grown as ``_prepad_rows`` says), on the
    current stream of the parts' card (the entry makes the card current)."""
    t = parts[0][0]
    device = t.get_device()
    segs, hs = _segment_args(parts, device)
    lead, w = t.shape[:-2], t.shape[-1]
    hp = _prepad_rows(hs, w, rw, orw, hp, wp)
    if wp % 16:
        raise ValueError(f"A4 takes a frame width that is a multiple of 16, not {wp}")
    planes = math.prod(lead)
    if planes > 65535:
        raise ValueError(f"A4 takes at most 65535 planes, got {planes}")
    out = torch.empty((*lead, hp, wp), dtype=torch.uint8, device=t.device)
    if not planes:
        return out
    # the raw stream handle: what torch.cuda.current_stream(device).cuda_stream
    # returns, without making a Stream object on every launch
    rc = entry(out.data_ptr(), planes, len(parts), segs, w, rw, orw, hp, wp, device,
               torch._C._cuda_getCurrentRawStream(device))
    if rc:
        from blur_algorithms_tpu_torch.utils.build import load_library

        msg = load_library().blur_cuda_error_string(rc).decode()
        raise RuntimeError(f"A4 launch failed: CUDA error {rc} ({msg})")
    return out


def assemble_padded_prepad(x: torch.Tensor | HaloedRows, rw: int, orw: int, hp: int,
                           wp: int) -> torch.Tensor:
    """A4: a shard's haloed rows ``(..., hs, w)``, one tensor or a
    ``HaloedRows``, -> ``(..., hp, wp)``, as ``assemble_padded_prepad_ref``
    on the rows they stand for. CUDA rows (uint8; a tensor contiguous; a
    ``HaloedRows``' parts with contiguous rows and leading dims that fold
    into one plane stride; ``wp`` a multiple of 16) launch
    ``assemble_padded_prepad_rows_u8``, which reads the parts where they
    lie; CPU rows run the plain version; any other device raises.
    ``assemble_padded_prepad.launches`` counts kernel launches, one a call
    however many parts."""
    global _entry
    given = isinstance(x, HaloedRows)
    t = x.block if given else x
    if len(t.shape) < 2:
        raise ValueError(f"expected planes (..., h, w), got {tuple(t.shape)}")
    if not t.is_cuda:
        if t.device.type != "cpu":
            raise ValueError(f"A4 runs on CUDA or CPU tensors, not {t.device}")
        return assemble_padded_prepad_ref(x.cat() if given else x, rw, orw, hp, wp)
    if not given and not x.is_contiguous():
        raise ValueError("A4 takes a contiguous tensor, or its rows as HaloedRows")
    if _entry is None:
        from blur_algorithms_tpu_torch.utils.build import load_library

        _entry = load_library().assemble_padded_prepad_rows_u8
    parts = x.parts() if given else [(x, False)]
    with trace.span("launch.assemble_padded_prepad_rows_u8"):
        out = _launch(_entry, parts, rw, orw, hp, wp)
    if out.numel():
        trace.launched(assemble_padded_prepad, "assemble_padded_prepad_rows_u8",
                       trace.nbytes(out, *(t for t, _ in parts)))
    return out


assemble_padded_prepad.launches = 0
