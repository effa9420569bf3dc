"""Pure-NumPy CPU oracle replicating the reference's pocketfft_2D engine.

A copy of the JAX package's ``oracle.py`` (``reflect_101_np``,
``blur_planar_fft2``, ``blur_u8``, ``blur_direct``), so that the port is
checked against the same oracle without importing jax. ``np.fft`` *is*
pocketfft, so this reproduces the reference flag-2 path
(``Source.cpp:143-277``) with the same FFT library and float32 math:
reflect-101 pad -> planar float -> 2-D r2c per channel -> separable multiply
by the kernel's row x col spectra -> c2r -> +0.5 uint8 merge -> crop.
``blur_direct`` is an independent second oracle (naive spatial convolution,
no FFT) for small inputs.
"""

from __future__ import annotations

import numpy as np

from blur_algorithms_tpu_torch.ops.plan import BlurPlan, make_plan

__all__ = ["reflect_101_np", "blur_planar_fft2", "blur_u8", "blur_direct"]


def reflect_101_np(x: np.ndarray, pads, axes=None) -> np.ndarray:
    """Reflect-101 pad with per-side clamp to ``dim - 1``; excess is zeros.

    NumPy twin of ``ops.pad.reflect_101`` (reference ``Utils.hpp:212-243``).
    """
    if axes is None:
        axes = range(x.ndim - len(pads), x.ndim)
    axes = [a % x.ndim for a in axes]
    reflect_cfg = [(0, 0)] * x.ndim
    zero_cfg = [(0, 0)] * x.ndim
    for axis, (before, after) in zip(axes, pads):
        dim = x.shape[axis]
        rb = max(0, min(before, dim - 1))
        ra = max(0, min(after, dim - 1))
        reflect_cfg[axis] = (rb, ra)
        zero_cfg[axis] = (before - rb, after - ra)
    out = np.pad(x, reflect_cfg, mode="reflect")
    if any(p != (0, 0) for p in zero_cfg):
        out = np.pad(out, zero_cfg, mode="constant")
    return out


def _mirror_full(rspec: np.ndarray, n: int) -> np.ndarray:
    """CCS unpack: mirror an rFFT real part around Nyquist to full length.

    Reference ``Source.cpp:215-218``.
    """
    full = np.zeros(n, dtype=rspec.dtype)
    half = n // 2 + 1
    full[:half] = rspec[:half]
    full[half:] = rspec[1 : n - half + 1][::-1]
    return full


def blur_planar_fft2(planar: np.ndarray, plan: BlurPlan) -> np.ndarray:
    """Blur float32 planar channels ``(..., H, W)`` via the 2-D FFT path."""
    (bt, bb), (bl, br) = plan.col.border, plan.row.border
    padded = reflect_101_np(planar.astype(np.float32), [(bt, bb), (bl, br)])
    fft_h, fft_w = plan.fft_shape
    assert padded.shape[-2:] == (fft_h, fft_w)

    spec = np.fft.rfft2(padded, axes=(-2, -1))  # complex64
    if plan.col.symmetric:
        ker_col = _mirror_full(plan.col.spectrum, fft_h).astype(np.float32)
    else:
        # asymmetric custom taps: full complex correlation spectrum, upper
        # bins conjugate-mirrored (CCS unpack)
        ker_col = np.zeros(fft_h, np.complex64)
        half = fft_h // 2 + 1
        ker_col[:half] = plan.col.spectrum_c[:half]
        ker_col[half:] = np.conj(
            plan.col.spectrum_c[1 : fft_h - half + 1][::-1]
        )
    ker_row = (
        plan.row.spectrum.astype(np.float32)
        if plan.row.symmetric
        else plan.row.spectrum_c
    )
    spec *= ker_col[:, None] * ker_row[None, :]
    out = np.fft.irfft2(spec, s=(fft_h, fft_w), axes=(-2, -1))

    h, w = plan.shape
    return out[..., bt : bt + h, bl : bl + w].astype(np.float32)


def blur_u8(
    img_hwc: np.ndarray,
    nsmooth: float,
    kernel: str = "gaussian",
    size_mode: str = "auto",
) -> np.ndarray:
    """End-to-end uint8 HWC blur: the reference flag-2 pipeline."""
    if img_hwc.dtype != np.uint8:
        raise ValueError("oracle expects uint8 HWC input")
    h, w = img_hwc.shape[:2]
    plan = make_plan((h, w), nsmooth, kernel=kernel, size_mode=size_mode)
    chw = np.moveaxis(img_hwc, -1, 0).astype(np.float32)
    blurred = blur_planar_fft2(chw, plan)
    merged = np.moveaxis(blurred, 0, -1)
    return np.clip(np.floor(merged + 0.5), 0, 255).astype(np.uint8)


def blur_direct(planar: np.ndarray, plan: BlurPlan) -> np.ndarray:
    """Independent oracle: naive separable spatial convolution, float64.

    Reflect-101 pad by the per-axis support, then direct dot with the taps.
    O(N * width) — for small test images only.
    """
    x = planar.astype(np.float64)

    def conv_axis(arr: np.ndarray, taps: np.ndarray, axis: int) -> np.ndarray:
        radius = (len(taps) - 1) // 2
        arr = np.moveaxis(arr, axis, -1)
        padded = reflect_101_np(arr, [(radius, radius)])
        n = arr.shape[-1]
        out = np.zeros_like(arr)
        for t, tap in enumerate(np.asarray(taps, dtype=np.float64)):
            out += tap * padded[..., t : t + n]
        return np.moveaxis(out, -1, axis)

    x = conv_axis(x, plan.row.taps, -1)
    x = conv_axis(x, plan.col.taps, -2)
    return x
