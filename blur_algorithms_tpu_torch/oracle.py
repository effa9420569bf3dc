"""Pure-NumPy CPU oracle replicating the reference's pocketfft_2D engine.

A copy of the JAX package's ``oracle.py`` (``reflect_101_np``,
``blur_planar_fft2``, ``blur_u8``, ``blur_planar_pffft``, ``blur_u8_pffft``,
``blur_direct``, ``dft_spectrum_np``, ``crc32c``), so that the port is
checked against the same oracle without importing jax. ``np.fft`` *is*
pocketfft, so this reproduces the reference flag-2 path
(``Source.cpp:143-277``) with the same FFT library and float32 math:
reflect-101 pad -> planar float -> 2-D r2c per channel -> separable multiply
by the kernel's row x col spectra -> c2r -> +0.5 uint8 merge -> crop.
``blur_direct`` is an independent second oracle (naive spatial convolution,
no FFT) for small inputs; ``box_blur_u8`` is the FastBoxBlur oracle, O(1)
per pixel by float64 cumulative sums.
"""

from __future__ import annotations

import numpy as np

from blur_algorithms_tpu_torch.ops.plan import BlurPlan, make_plan

__all__ = [
    "reflect_101_np",
    "blur_planar_fft2",
    "blur_u8",
    "blur_planar_pffft",
    "blur_u8_pffft",
    "blur_direct",
    "box_blur_u8",
    "dft_spectrum_np",
    "crc32c",
]


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


def blur_planar_pffft(planar: np.ndarray, plan: BlurPlan) -> np.ndarray:
    """NumPy emulation of the reference flag-3 (pffft) tile engine.

    Per axis (rows then columns, ``Source.cpp:510-562``): reflect-101 pad by
    ``pad`` each side, trailing zeros to the transform length, r2c, multiply
    by Re(kernel spectrum) with pffft's ordered-layout Nyquist shortcut (the
    data's Nyquist bin scaled by the kernel's DC value,
    ``Source.cpp:414-427``), c2r with 1/N, crop the interior. Float32.
    """

    def tile_pass(x: np.ndarray, axis_plan, axis: int) -> np.ndarray:
        pad, n, flen = axis_plan.pad, axis_plan.dim, axis_plan.fft_len
        x = np.moveaxis(x, axis, -1)
        tile = reflect_101_np(x, [(pad, pad)])
        spec = np.fft.rfft(tile, n=flen, axis=-1)
        ker = axis_plan.spectrum.astype(np.float32).copy()
        if flen % 2 == 0:
            ker[flen // 2] = ker[0]  # the Nyquist-gets-DC quirk
        out = np.fft.irfft(spec * ker, n=flen, axis=-1)
        return np.moveaxis(out[..., pad : pad + n], -1, axis)

    x = planar.astype(np.float32)
    x = tile_pass(x, plan.row, -1)
    x = tile_pass(x, plan.col, -2)
    return x.astype(np.float32)


def blur_u8_pffft(img_hwc: np.ndarray, nsmooth: float) -> np.ndarray:
    """End-to-end uint8 HWC blur through the flag-3 emulation, planned with
    ``smooth235`` sizing (pffft's own transform-length rule)."""
    if img_hwc.dtype != np.uint8:
        raise ValueError("oracle expects uint8 HWC input")
    h, w = img_hwc.shape[:2]
    plan = make_plan((h, w), nsmooth, size_mode="smooth235")
    chw = np.moveaxis(img_hwc, -1, 0).astype(np.float32)
    blurred = blur_planar_pffft(chw, plan)
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


def dft_spectrum_np(planar: np.ndarray, plan: BlurPlan) -> np.ndarray:
    """``DFT_image`` mode: 20*log10(|Re(spectrum)| + 1e-5), fftshifted, with
    the reference's index math (``Source.cpp:240-252``)."""
    (bt, bb), (bl, br) = plan.col.border, plan.row.border
    padded = reflect_101_np(planar.astype(np.float32), [(bt, bb), (bl, br)])
    s0, s1 = plan.fft_shape
    spec = np.fft.rfft2(padded, axes=(-2, -1))
    rows = np.arange(s0)
    cols = np.arange(s1)
    row_ = (rows + (s0 if s0 % 2 == 0 else s0 + 1) // 2) % s0
    col_ = (cols + (s1 if s1 % 2 == 0 else s1 + 1) // 2) % s1
    half = s1 // 2 + 1
    cval = np.where(col_ < half, col_, (s1 // 2) - col_ % (s1 // 2))
    re = np.real(spec[..., row_[:, None], cval[None, :]]).astype(np.float32)
    return (20.0 * np.log10(np.abs(re) + np.float32(1e-5))).astype(np.float32)


def box_blur_u8(img_hwc: np.ndarray, radius: int, passes: int = 2) -> np.ndarray:
    """FastBoxBlur oracle for uint8 ``(H, W, C)``: ``passes`` reflect-101 box
    passes of width ``2 * radius + 1`` per axis (rows, then columns, each
    pass), float64 cumulative-sum differences, one +0.5 rounding at the end.
    ``radius`` must be at most ``min(H, W) - 1``."""
    w = 2 * radius + 1

    def box1(a: np.ndarray, axis: int) -> np.ndarray:
        pad = [(0, 0)] * a.ndim
        pad[axis] = (radius, radius)
        cs = np.cumsum(np.pad(a, pad, mode="reflect"), axis=axis, dtype=np.float64)
        cs = np.concatenate([np.zeros_like(np.take(cs, [0], axis=axis)), cs], axis=axis)
        n = cs.shape[axis] - w
        return (np.take(cs, range(w, w + n), axis=axis)
                - np.take(cs, range(0, n), axis=axis)) / w

    out = np.moveaxis(img_hwc, -1, 0).astype(np.float64)
    for _ in range(passes):
        out = box1(out, -1)
        out = box1(out, -2)
    return np.clip(np.floor(np.moveaxis(out, 0, -1) + 0.5), 0, 255).astype(np.uint8)


_CRC_TABLE: np.ndarray | None = None


def crc32c(*buffers: np.ndarray) -> int:
    """CRC-32 (poly 0xEDB88320) over buffers — reference ``Source.cpp:15-56``
    (the NumPy path of ``utils/native.crc32``)."""
    global _CRC_TABLE
    if _CRC_TABLE is None:
        table = np.zeros(256, dtype=np.uint32)
        for i in range(256):
            r = np.uint32(i)
            for _ in range(8):
                r = (r >> np.uint32(1)) ^ (
                    np.uint32(0xEDB88320) if r & np.uint32(1) else np.uint32(0)
                )
            table[i] = r
        _CRC_TABLE = table
    crc = np.uint32(0xFFFFFFFF)
    for buf in buffers:
        for b in np.ascontiguousarray(buf).view(np.uint8).ravel():
            crc = _CRC_TABLE[(crc ^ b) & np.uint32(0xFF)] ^ (crc >> np.uint32(8))
    return int(crc ^ np.uint32(0xFFFFFFFF))
