"""Many sigmas in one call: the sigma sweep as a batch axis.

The port of the JAX package's ``ops/multi_sigma.py``, which computes it with
``jnp.fft`` outside any Pallas kernel (``torch.fft`` here: pocketfft on the
CPU, cuFFT on a CUDA device), on the input's device:

* geometry (pad, borders, FFT lengths) comes from the LARGEST sigma; a
  reflect-101 pad wider than a kernel's radius is exact for that kernel, so
  every sigma shares one padded frame;
* per-sigma kernel spectra are stacked into an ``(N, bins)`` table per
  axis (each sigma's own taps, wrapped into the shared transform lengths);
* the forward 2-D rFFT of the frame is computed once and broadcast over the
  sigma axis: only the spectral multiply and the inverse transform pay per
  sigma.

Same math as the ``fft2`` engine; each slice matches ``blur(x, sigma_i,
engine="fft2")``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from blur_algorithms_tpu_torch.ops import kernels
from blur_algorithms_tpu_torch.ops.fft_conv import _mirror_full, rfft2_pipeline
from blur_algorithms_tpu_torch.ops.layout import from_planar, round_to_u8, to_planar
from blur_algorithms_tpu_torch.ops.plan import BlurPlan, clamped_axis_width, make_plan

__all__ = ["blur_multi_sigma", "blur_multi_sigma_u8"]


def _sigma_tuple(sigmas) -> tuple[float, ...]:
    sig = tuple(float(s) for s in np.atleast_1d(np.asarray(sigmas)))
    if not sig:
        raise ValueError("sigmas must be a non-empty sequence of floats")
    return sig


@functools.lru_cache(maxsize=64)
def _multi_plan(h: int, w: int, sigmas: tuple[float, ...], size_mode: str
                ) -> tuple[BlurPlan, np.ndarray, np.ndarray]:
    """The widest sigma's plan and the stacked real spectra: columns
    ``(N, fft_h)`` full, rows ``(N, fft_w // 2 + 1)`` half. Each sigma's
    taps follow its own plan (``clamped_axis_width`` and
    ``gaussian_kernel``, as ``make_plan``), wrapped into the shared
    transform lengths; sigma <= 0 is the identity."""
    plan = make_plan((h, w), max(max(sigmas), 0.1), size_mode=size_mode)
    fft_h, fft_w = plan.fft_shape
    cols = np.empty((len(sigmas), fft_h), np.float32)
    rows = np.empty((len(sigmas), fft_w // 2 + 1), np.float32)
    for i, s in enumerate(sigmas):
        if s <= 0.0:
            cols[i] = 1.0
            rows[i] = 1.0
            continue
        gw = kernels.gaussian_window(s, max(h, w))
        col_taps = kernels.gaussian_kernel(s, clamped_axis_width(h, gw))
        row_taps = kernels.gaussian_kernel(s, clamped_axis_width(w, gw))
        cols[i] = _mirror_full(kernels.real_spectrum(col_taps, fft_h), fft_h)
        rows[i] = kernels.real_spectrum(row_taps, fft_w)
    return plan, cols, rows


def _multi(planar: torch.Tensor, sigmas: tuple[float, ...], size_mode: str) -> torch.Tensor:
    """float32 ``(N, ..., H, W)``: the shared forward spectrum times each
    sigma's outer product (two broadcasts, never the 2-D table)."""
    planar = planar.to(torch.float32)
    plan, cols, rows = _multi_plan(planar.shape[-2], planar.shape[-1], sigmas, size_mode)
    shape = (len(sigmas),) + (1,) * (planar.ndim - 2)
    ck = torch.from_numpy(cols).to(planar.device).reshape(*shape, -1, 1)
    rk = torch.from_numpy(rows).to(planar.device).reshape(*shape, 1, -1)
    return rfft2_pipeline(planar, plan, lambda spec: spec[None] * ck * rk)


def blur_multi_sigma(planar: torch.Tensor, sigmas, size_mode: str = "auto") -> torch.Tensor:
    """Gaussian-blur float planar ``(..., H, W)`` at N sigmas at once.

    Returns ``(N, ..., H, W)`` float32, the sigma sweep stacked in front;
    the frame's forward FFT is shared across the sweep."""
    return _multi(planar, _sigma_tuple(sigmas), size_mode)


def blur_multi_sigma_u8(img: torch.Tensor, sigmas, size_mode: str = "auto") -> torch.Tensor:
    """uint8 interleaved ``(..., H, W, C)`` -> uint8 ``(N, ..., H, W, C)``."""
    if img.dtype != torch.uint8:
        raise TypeError(f"blur_multi_sigma_u8 expects uint8, got {img.dtype}")
    out = _multi(to_planar(img), _sigma_tuple(sigmas), size_mode)
    return from_planar(round_to_u8(out))
