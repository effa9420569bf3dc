"""The reference's FFT-convolution engines over ``torch.fft``.

The port of the JAX package's ``ops/fft_conv.py``, which computes these
with ``jnp.fft`` outside any Pallas kernel; ``torch.fft`` (pocketfft on the
CPU, cuFFT on a CUDA device) is their counterpart here:

* ``blur_fft2``: the reference ``pocketfft_2D`` path (``Source.cpp:143-277``):
  reflect-101 pad the whole image (pad + FFT growth split across sides),
  one batched 2-D rFFT, a separable multiply by the outer product of the
  two 1-D kernel spectra, the inverse, the crop.
* ``blur_fft_tiles``: the reference tile engines ``pocketfft_1D`` /
  ``pffft_`` (``Source.cpp:280-392, 429-570``): per-axis 1-D transforms
  with reflected pads and trailing zeros for the FFT growth
  (``Source.cpp:297-306``); ``pffft_quirk=True`` adds the pffft engine's
  Nyquist shortcut (``_pffft_quirked``).

``kernel_multiply=True`` (the JAX ``pallas_multiply=``; off by default, as
there) runs the spectral multiply through the CUDA kernel K5
(``cuda_kernels/spectral_multiply.py``), symmetric taps only. Input and
output: float32 planar ``(..., H, W)`` on the input's device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from blur_algorithms_tpu_torch.ops.pad import reflect_101
from blur_algorithms_tpu_torch.ops.plan import BlurPlan

__all__ = ["blur_fft2", "blur_fft_tiles", "rfft2_pipeline"]


def _mirror_full(rspec: np.ndarray, n: int) -> np.ndarray:
    """CCS unpack (mirror around Nyquist): reference ``Source.cpp:215-218``."""
    full = np.zeros(n, dtype=rspec.dtype)
    half = n // 2 + 1
    full[:half] = rspec[:half]
    full[half:] = rspec[1 : n - half + 1][::-1]
    return full


def _mirror_full_c(rspec: np.ndarray, n: int) -> np.ndarray:
    """Complex CCS unpack: upper bins are conjugates of the mirrored lower."""
    full = np.zeros(n, dtype=np.complex64)
    half = n // 2 + 1
    full[:half] = rspec[:half]
    full[half:] = np.conj(rspec[1 : n - half + 1][::-1])
    return full


def _axis_spectrum(axis_plan) -> np.ndarray:
    """Half spectrum for the rows multiply: real (symmetric taps) or
    complex (asymmetric custom taps)."""
    return axis_plan.spectrum if axis_plan.symmetric else axis_plan.spectrum_c


def _pffft_quirked(spectrum: np.ndarray, fft_len: int) -> np.ndarray:
    """Kernel spectrum with the pffft ordered-layout Nyquist quirk applied.

    pffft's ordered real layout packs DC at ``[0]`` and Nyquist at ``[1]``,
    so the reference's pairwise multiply (``Source.cpp:414-427``) scales the
    data's Nyquist bin by the kernel's DC value instead of its Nyquist
    value. Emulated by editing one entry of the kernel spectrum.
    """
    if fft_len % 2 != 0:  # odd lengths have no Nyquist bin (never planned)
        return spectrum
    quirked = spectrum.copy()
    quirked[fft_len // 2] = quirked[0]
    return quirked


def _on(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(like.device)


def rfft2_pipeline(planar: torch.Tensor, plan: BlurPlan, on_spectrum) -> torch.Tensor:
    """Shared 2-D spectral scaffolding: reflect-101 pad by the plan borders,
    ``rfft2``, ``on_spectrum``, ``irfft2`` at the planned transform shape,
    crop the interior."""
    h, w = plan.shape
    (bt, bb), (bl, br) = plan.col.border, plan.row.border
    fft_h, fft_w = plan.fft_shape
    padded = reflect_101(planar, [(bt, bb), (bl, br)])
    spec = on_spectrum(torch.fft.rfft2(padded, dim=(-2, -1)))
    out = torch.fft.irfft2(spec, s=(fft_h, fft_w), dim=(-2, -1))
    return out[..., bt : bt + h, bl : bl + w]


def _require_symmetric(symmetric: bool, what: str) -> None:
    if not symmetric:
        raise ValueError(f"{what} supports symmetric (real-spectrum) taps only")


def blur_fft2(planar: torch.Tensor, plan: BlurPlan,
              kernel_multiply: bool = False) -> torch.Tensor:
    """2-D FFT convolution of float32 planar channels ``(..., H, W)``.

    ``kernel_multiply`` routes the spectral multiply through K5."""
    fft_h = plan.fft_shape[0]
    ker_col = (
        _mirror_full(plan.col.spectrum, fft_h)
        if plan.col.symmetric
        else _mirror_full_c(plan.col.spectrum_c, fft_h)
    )
    if kernel_multiply:
        _require_symmetric(plan.col.symmetric and plan.row.symmetric, "kernel_multiply")
        from blur_algorithms_tpu_torch.cuda_kernels.spectral_multiply import (
            spectral_multiply_2d,
        )

        def mult(spec):
            return spectral_multiply_2d(spec.contiguous(), ker_col, plan.row.spectrum)
    else:
        def mult(spec):
            return spec * _on(ker_col, spec)[:, None] * _on(_axis_spectrum(plan.row), spec)
    return rfft2_pipeline(planar.to(torch.float32), plan, mult)


def _tile_pass(
    x: torch.Tensor,
    axis_plan,
    axis: int,
    kernel_multiply: bool = False,
    pffft_quirk: bool = False,
) -> torch.Tensor:
    """One 1-D pass: reflect pad + trailing zeros, rFFT, times the kernel
    spectrum, irFFT, crop. All rows (or columns) form one batch."""
    pad, n, flen = axis_plan.pad, axis_plan.dim, axis_plan.fft_len
    x = x.movedim(axis, -1)
    tile = reflect_101(x, [(pad, pad)])
    if flen > tile.shape[-1]:
        tile = F.pad(tile, (0, flen - tile.shape[-1]))
    spec = torch.fft.rfft(tile, n=flen, dim=-1)
    if kernel_multiply:
        _require_symmetric(axis_plan.symmetric, "kernel_multiply")
        from blur_algorithms_tpu_torch.cuda_kernels.spectral_multiply import (
            spectral_multiply_rows,
        )

        spec = spectral_multiply_rows(spec.contiguous(), axis_plan.spectrum)
    elif pffft_quirk:
        _require_symmetric(
            axis_plan.symmetric,
            "pffft_quirk emulates the reference's real-spectrum multiply and",
        )
        spec = spec * _on(_pffft_quirked(axis_plan.spectrum, flen), spec)
    else:
        spec = spec * _on(_axis_spectrum(axis_plan), spec)
    out = torch.fft.irfft(spec, n=flen, dim=-1)
    out = out[..., pad : pad + n]
    return out.movedim(-1, axis)


def blur_fft_tiles(
    planar: torch.Tensor,
    plan: BlurPlan,
    kernel_multiply: bool = False,
    pffft_quirk: bool = False,
) -> torch.Tensor:
    """Separable 1-D tile path: rows pass then columns pass.

    ``pffft_quirk=True`` reproduces the reference pffft engine's
    ordered-layout Nyquist shortcut (``Source.cpp:414-427``); with
    ``size_mode="smooth235"`` (pffft's own transform-length rule) it is the
    reference's flag-3 engine.
    """
    out = _tile_pass(planar.to(torch.float32), plan.row, -1, kernel_multiply, pffft_quirk)
    return _tile_pass(out, plan.col, -2, kernel_multiply, pffft_quirk)
