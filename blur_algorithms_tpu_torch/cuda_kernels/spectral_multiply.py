"""Spectral multiply of a complex64 spectrum by a separable real kernel
spectrum (K5).

The port of the JAX package's ``pallas_kernels/spectral_multiply.py``:
``spec[..., i, j] * (col[i] * row[j] * scale)``. A CUDA tensor launches the
kernel of ``csrc/spectral_multiply.cu``, which reads the complex64 tensor in
place as interleaved float pairs, two values per 16-byte access; a CPU
tensor runs the plain version, the elementwise expression the JAX package
uses off the TPU (``spectral_multiply.py:54-57``). The two agree bit for
bit. ``launch_geometry`` is the kernel's grid.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "launch_geometry",
    "spectral_multiply_2d",
    "spectral_multiply_2d_ref",
    "spectral_multiply_rows",
]


THREADS = 256  # threads per block of the kernel
_MAX_GRID_Y = 65535


def launch_geometry(planes: int, h: int, wf: int) -> tuple[int, int]:
    """The kernel's grid (x, y): ``x`` blocks of ``THREADS`` threads, one
    pair of values a thread (pair ``block * THREADS + thread``), cover the
    most pairs a plane can have (``h * wf // 2``); ``y`` takes the planes,
    at most 65535 (the kernel walks past it in steps of ``y``)."""
    return max(1, -(-(h * wf // 2) // THREADS)), min(planes, _MAX_GRID_Y)


@functools.lru_cache(maxsize=64)
def _device_factors(col: bytes, row: bytes, device: torch.device):
    """The float32 column and row spectra on the device, copied once per
    spectrum pair and device (a plan's spectra are reused call after
    call)."""
    return (torch.frombuffer(bytearray(col), dtype=torch.float32).to(device),
            torch.frombuffer(bytearray(row), dtype=torch.float32).to(device))


def _factors(col_re, row_re, scale: float) -> tuple[np.ndarray, np.ndarray, np.float32]:
    return (np.ascontiguousarray(col_re, np.float32),
            np.ascontiguousarray(row_re, np.float32), np.float32(scale))


def _check(spec: torch.Tensor, col: np.ndarray, row: np.ndarray) -> None:
    if spec.dtype != torch.complex64:
        raise TypeError(f"K5 takes a complex64 spectrum, got {spec.dtype}")
    if spec.ndim < 2 or col.shape != (spec.shape[-2],) or row.shape != (spec.shape[-1],):
        raise ValueError(
            f"spectrum {tuple(spec.shape)} does not match col {col.shape} "
            f"and row {row.shape}"
        )


def spectral_multiply_2d_ref(spec: torch.Tensor, col_re, row_re,
                             scale: float = 1.0) -> torch.Tensor:
    """Plain version of K5: the elementwise expression, the outer product
    rounded to float32 on the host."""
    col, row, s = _factors(col_re, row_re, scale)
    _check(spec, col, row)
    return spec * torch.from_numpy(col[:, None] * row[None, :] * s).to(spec.device)


def spectral_multiply_2d(spec: torch.Tensor, col_re, row_re,
                         scale: float = 1.0) -> torch.Tensor:
    """``spec[..., i, j] * col_re[i] * row_re[j] * scale`` for a complex64
    ``(..., H, Wf)`` spectrum; ``col_re`` / ``row_re`` are real spectra of
    length H / Wf.

    A CUDA tensor launches the kernel; a CPU tensor runs the plain version.
    ``spectral_multiply_2d.launches`` counts kernel launches.
    """
    col, row, s = _factors(col_re, row_re, scale)
    _check(spec, col, row)
    if spec.device.type == "cpu":
        return spectral_multiply_2d_ref(spec, col, row, scale)
    if spec.device.type != "cuda":
        raise ValueError(f"K5 runs on CUDA or CPU tensors, not {spec.device}")
    if not spec.is_contiguous():
        raise ValueError("K5 needs a contiguous spectrum")
    from blur_algorithms_tpu_torch.utils.build import load_library

    h, wf = spec.shape[-2], spec.shape[-1]
    planes = spec.numel() // (h * wf) if spec.numel() else 0
    if h * wf >= 1 << 31:
        raise ValueError("K5 takes planes of fewer than 2**31 values")
    if planes == 0:
        return torch.empty_like(spec)
    # out at the same offset from a 16-byte boundary as spec (the kernel's
    # 16-byte accesses pair the same values in both)
    odd = spec.data_ptr() % 16 // 8
    out = torch.empty(spec.numel() + odd, dtype=spec.dtype,
                      device=spec.device)[odd:].view(spec.shape)
    col_t, row_t = _device_factors(col.tobytes(), row.tobytes(), spec.device)
    lib = load_library()
    with torch.cuda.device(spec.device):
        rc = lib.spectral_multiply_2d(
            spec.data_ptr(), out.data_ptr(), col_t.data_ptr(), row_t.data_ptr(),
            float(s), planes, h, wf, *launch_geometry(planes, h, wf),
            torch.cuda.current_stream(spec.device).cuda_stream,
        )
    if rc:
        msg = lib.blur_cuda_error_string(rc).decode()
        raise RuntimeError(f"K5 launch failed: CUDA error {rc} ({msg})")
    spectral_multiply_2d.launches += 1
    return out


spectral_multiply_2d.launches = 0


def spectral_multiply_rows(spec: torch.Tensor, row_re, scale: float = 1.0) -> torch.Tensor:
    """1-D variant for the tile path: ``spec[..., j] * row_re[j] * scale``,
    every leading row of one 2-D multiply with a unit column spectrum."""
    if spec.ndim < 2:
        return spectral_multiply_rows(spec.reshape(1, -1), row_re, scale).reshape(spec.shape)
    ones = np.ones(spec.shape[-2], dtype=np.float32)
    return spectral_multiply_2d(spec, ones, row_re, scale)
