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
the rest. It is A5's function with no row border, so on a CUDA tensor it
launches A5's kernel with ``rh = orh = 0`` (``assemble_padded_prepad_u8``
of ``csrc/fused_dma.cu``), counted on its own wrapper.
"""

from __future__ import annotations

import torch

from blur_algorithms_tpu_torch.ops.pad import reflect_101

__all__ = [
    "assemble_padded",
    "assemble_padded_prepad",
    "assemble_padded_prepad_ref",
    "assemble_padded_ref",
]


def _check(x: torch.Tensor, rh: int, rw: int, orh: int, orw: int, hp: int, wp: int):
    if x.ndim < 2:
        raise ValueError(f"expected planes (..., h, w), got {tuple(x.shape)}")
    h, w = x.shape[-2:]
    if min(rh, rw) < 0 or orh < min(rh, h - 1) or orw < min(rw, w - 1) or hp < 1 or wp < 1:
        raise ValueError(f"the frame ({hp}, {wp}) at {(orh, orw)} cannot hold borders "
                         f"{(rh, rw)} of {(h, w)} planes")


def assemble_padded_ref(x: torch.Tensor, rh: int, rw: int, orh: int, orw: int,
                        hp: int, wp: int) -> torch.Tensor:
    """Plain PyTorch version of A5: ``reflect_101`` by the clamped radii,
    placed at ``(orh - min(rh, h - 1), orw - min(rw, w - 1))`` in a zero
    ``(..., hp, wp)`` frame (cut at its edges)."""
    _check(x, rh, rw, orh, orw, hp, wp)
    h, w = x.shape[-2:]
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
    _check(x, rh, rw, orh, orw, hp, wp)
    if x.device.type == "cpu":
        return assemble_padded_ref(x, rh, rw, orh, orw, hp, wp)
    if x.device.type != "cuda":
        raise ValueError(f"A5 runs on CUDA or CPU tensors, not {x.device}")
    if x.dtype != torch.uint8 or not x.is_contiguous() or wp % 16:
        raise ValueError("A5 takes contiguous uint8 planes and a frame width that is a "
                         f"multiple of 16 (got {x.dtype}, wp {wp})")
    from blur_algorithms_tpu_torch.utils.build import load_library

    h, w = x.shape[-2:]
    planes = x.reshape(-1, h, w)
    if planes.shape[0] > 65535:
        raise ValueError(f"A5 takes at most 65535 planes, got {planes.shape[0]}")
    out = torch.empty((planes.shape[0], hp, wp), dtype=torch.uint8, device=x.device)
    if planes.shape[0]:
        lib = load_library()
        with torch.cuda.device(x.device):
            rc = lib.assemble_padded_u8(
                planes.data_ptr(), out.data_ptr(), planes.shape[0], h, w, rh, rw, orh, orw,
                hp, wp, torch.cuda.current_stream(x.device).cuda_stream)
        if rc:
            msg = lib.blur_cuda_error_string(rc).decode()
            raise RuntimeError(f"A5 launch failed: CUDA error {rc} ({msg})")
        assemble_padded.launches += 1
    return out.reshape(*x.shape[:-2], hp, wp)


assemble_padded.launches = 0


def _prepad_rows(x: torch.Tensor, rw: int, orw: int, hp: int, wp: int) -> int:
    """A4's frame height: ``hp``, or ``hp + 8`` where ``hp`` does not pass
    the shard's last whole group of 8 rows (the JAX frame keeps a bottom
    strip of at least 8 rows there; the port's K1a frames never need it)."""
    _check(x, 0, rw, 0, orw, hp, wp)
    return hp if hp > (x.shape[-2] // 8) * 8 else hp + 8


def assemble_padded_prepad_ref(x: torch.Tensor, rw: int, orw: int, hp: int,
                               wp: int) -> torch.Tensor:
    """Plain PyTorch version of A4 (the JAX ``_assemble_padded_prepad``):
    ``(..., hs, w)`` -> ``(..., hp, wp)`` with the rows as given at ``(0,
    orw)``, reflect-101 columns (clamped to ``w - 1``, zeros past it) and
    zeros in the slack; ``hp + 8`` rows where ``hp <= 8 * (hs // 8)``."""
    hp = _prepad_rows(x, rw, orw, hp, wp)
    return assemble_padded_ref(x, 0, rw, 0, orw, hp, wp)


def assemble_padded_prepad(x: torch.Tensor, rw: int, orw: int, hp: int,
                           wp: int) -> torch.Tensor:
    """A4: ``(..., hs, w)`` -> ``(..., hp, wp)``, as
    ``assemble_padded_prepad_ref``. A CUDA tensor (uint8, contiguous, ``wp``
    a multiple of 16) launches A5's kernel with no row border; a CPU tensor
    runs the plain version; any other device raises.
    ``assemble_padded_prepad.launches`` counts kernel launches."""
    hp = _prepad_rows(x, rw, orw, hp, wp)
    if x.device.type == "cpu":
        return assemble_padded_ref(x, 0, rw, 0, orw, hp, wp)
    if x.device.type != "cuda":
        raise ValueError(f"A4 runs on CUDA or CPU tensors, not {x.device}")
    if x.dtype != torch.uint8 or not x.is_contiguous() or wp % 16:
        raise ValueError("A4 takes contiguous uint8 planes and a frame width that is a "
                         f"multiple of 16 (got {x.dtype}, wp {wp})")
    from blur_algorithms_tpu_torch.utils.build import load_library

    hs, w = x.shape[-2:]
    planes = x.reshape(-1, hs, w)
    if planes.shape[0] > 65535:
        raise ValueError(f"A4 takes at most 65535 planes, got {planes.shape[0]}")
    out = torch.empty((planes.shape[0], hp, wp), dtype=torch.uint8, device=x.device)
    if planes.shape[0]:
        lib = load_library()
        with torch.cuda.device(x.device):
            rc = lib.assemble_padded_prepad_u8(
                planes.data_ptr(), out.data_ptr(), planes.shape[0], hs, w, rw, orw, hp, wp,
                torch.cuda.current_stream(x.device).cuda_stream)
        if rc:
            msg = lib.blur_cuda_error_string(rc).decode()
            raise RuntimeError(f"A4 launch failed: CUDA error {rc} ({msg})")
        assemble_padded_prepad.launches += 1
    return out.reshape(*x.shape[:-2], hp, wp)


assemble_padded_prepad.launches = 0
