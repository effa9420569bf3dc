"""Host-side blur planning: shapes, pads, FFT lengths, kernel spectra.

A copy of the JAX package's ``ops/plan.py`` (same fields, same values), so
that the port plans without importing jax. A ``BlurPlan`` is computed once
per (image shape, sigma/radius, engine options) on the host with NumPy and
handed to the kernel wrappers — the analog of the reference's per-call setup
code
(``Source.cpp:143-176, 280-306, 429-457``): kernel sizing, pad computation,
FFT-size growth, and kernel-spectrum precomputation.

Per-axis clamping policy (documented deviation): the reference clamps the
kernel width to the *largest* image dimension (``Source.cpp:149``) and the
2-D path additionally clamps pads to ``dim - 1`` inside ``Reflect_101``
(``Utils.hpp:217-220``) without shrinking the kernel — which under-reflects
(2-D path) or reads out of range (1-D paths) for extreme sigma on elongated
images. Here each axis independently clamps its kernel width so that
``pad <= dim - 1`` always holds (the constraint ``README.md:33-38`` states as
the intended invariant), and taps are re-normalized at the clamped width.
For all non-degenerate cases (kernel fits in both dims) this is exactly the
reference computation.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np

from blur_algorithms_tpu_torch.ops import kernels, sizes

__all__ = [
    "AxisPlan",
    "BlurPlan",
    "clamped_axis_width",
    "make_plan",
    "make_custom_plan",
]

KernelKind = Literal["gaussian", "box", "box_fast", "custom"]


@dataclasses.dataclass(frozen=True, eq=False)
class AxisPlan:
    """Per-axis geometry and spectra (axis length ``dim``).

    ``eq=False``: plans hash/compare by identity so they can be cache keys
    despite holding ndarrays; the api layer caches and reuses them.
    """

    dim: int
    width: int  # effective odd kernel width on this axis
    pad: int  # one-side reflect pad = (width - 1) // 2 * passes (clamped)
    fft_len: int  # planned transform length
    trailing: int  # zero fill for the tile path: fft_len - (dim + 2*pad)
    border: tuple[int, int]  # 2-D path per-side border (pad + growth split)
    taps: np.ndarray  # spatial taps, float32, length = support (odd)
    spectrum: np.ndarray  # Re(rfft(wrapped taps)), float32, fft_len//2 + 1
    # full complex correlation spectrum, ONLY for asymmetric taps (None for
    # symmetric ones, where Im == 0 and ``spectrum`` is the whole story)
    spectrum_c: np.ndarray | None = None

    @property
    def support_radius(self) -> int:
        return (int(self.taps.shape[0]) - 1) // 2

    @property
    def symmetric(self) -> bool:
        """True when the taps are palindromic (real spectrum suffices)."""
        return self.spectrum_c is None


@dataclasses.dataclass(frozen=True, eq=False)
class BlurPlan:
    """Complete static description of one blur invocation (identity-hashed)."""

    shape: tuple[int, int]  # (H, W)
    kernel: KernelKind
    sigma: float  # nsmooth as passed (sigma for gaussian, n for box)
    passes: int
    size_mode: str
    row: AxisPlan  # axis -1 (width / rows pass)
    col: AxisPlan  # axis -2 (height / columns pass)
    box_passes: int = 1  # for kernel="box_fast": the folded pass count
    # anisotropic gaussian: sigma is the COLUMN (vertical) sigma and
    # sigma_x the ROW (horizontal) one; None = isotropic. Engines that
    # consume a single scalar sigma (deriche, cascade, box) reject plans
    # with sigma_x set — everything taps/spectra-based is per-axis anyway.
    sigma_x: float | None = None

    @property
    def fft_shape(self) -> tuple[int, int]:
        return (self.col.fft_len, self.row.fft_len)


def clamped_axis_width(dim: int, global_width: int) -> int:
    """Kernel width clamped (odd) so the reflect pad fits: pad <= dim - 1.

    The per-axis clamp of the module docstring, shared with callers that
    need an axis's effective taps without building a full plan (e.g. the
    multi-sigma sweep, which wraps each sigma's taps into SHARED transform
    lengths instead of each plan's own)."""
    width = min(global_width, 2 * (dim - 1) + 1) if dim > 1 else 1
    if width % 2 == 0:
        width -= 1
    return max(width, 1)


def _axis_plan(
    dim: int,
    global_width: int,
    taps_fn,
    passes: int,
    size_mode: str,
) -> AxisPlan:
    width = clamped_axis_width(dim, global_width)
    taps = taps_fn(width)
    pad = (int(taps.shape[0]) - 1) // 2 * passes if passes else (width - 1) // 2
    pad = min(pad, dim - 1) if dim > 1 else 0
    min_len = dim + 2 * pad
    fft_len = sizes.plan_fft_size(min_len, size_mode)
    growth = fft_len - min_len
    border = (pad + growth // 2, pad + (growth - growth // 2))
    spectrum = kernels.real_spectrum(taps, fft_len)
    symmetric = bool(np.allclose(taps, taps[::-1]))
    spectrum_c = None if symmetric else kernels.complex_spectrum(taps, fft_len)
    return AxisPlan(
        dim=dim,
        width=width,
        pad=pad,
        fft_len=fft_len,
        trailing=growth,
        border=border,
        taps=taps,
        spectrum=spectrum,
        spectrum_c=spectrum_c,
    )


def make_plan(
    shape: tuple[int, int],
    nsmooth: float | tuple[float, float],
    kernel: KernelKind = "gaussian",
    size_mode: str = "auto",
    box_passes: int = 2,
) -> BlurPlan:
    """Plan a blur of an ``(H, W)`` image.

    ``kernel="gaussian"``: true Gaussian, sigma = ``nsmooth``, one pass;
    width from ``gaussian_window(sigma, max(H, W))`` (``Source.cpp:149``).
    ``nsmooth`` may also be a ``(sigma_y, sigma_x)`` pair for an
    ANISOTROPIC Gaussian (beyond the reference): each axis plans its own
    width/taps/spectrum from its own sigma — the separable machinery is
    per-axis already, so every taps/spectra-driven engine serves the
    plan unchanged.

    ``kernel="box"``: the reference's FFT tent mode (``#define boxblur``,
    ``Source.cpp:152-156``): box length ``k = min(int(n)^2, min(H,W) - 1)``,
    kernel = box convolved with itself (2 passes). The tent's full support
    ``2k - 1`` is used for the pad (the reference's ``(k-1)/2*2`` under-pads
    by one for even ``k``; see plan module docstring).
    """
    h, w = int(shape[0]), int(shape[1])
    if h < 1 or w < 1:
        raise ValueError(f"image shape must be positive, got {shape}")
    if kernel != "gaussian" and isinstance(nsmooth, (tuple, list)):
        raise ValueError(
            "per-axis nsmooth is only supported for kernel='gaussian'"
        )

    sigma_x: float | None = None
    if kernel == "gaussian":
        if isinstance(nsmooth, (tuple, list)):
            if len(nsmooth) != 2:
                raise ValueError(
                    f"anisotropic sigma needs (sigma_y, sigma_x), got {nsmooth}"
                )
            sigma, sigma_x = float(nsmooth[0]), float(nsmooth[1])
            if sigma_x == sigma:
                sigma_x = None  # plain isotropic plan
        else:
            sigma = float(nsmooth)
        if sigma <= 0 or (sigma_x is not None and sigma_x <= 0):
            raise ValueError(f"sigma must be > 0, got {nsmooth}")
        global_width = kernels.gaussian_window(sigma, max(h, w))

        def taps_fn(width: int) -> np.ndarray:
            return kernels.gaussian_kernel(sigma, width)

        if sigma_x is not None:
            sx = sigma_x
            global_width_row = kernels.gaussian_window(sx, max(h, w))

            def taps_fn_row(width: int) -> np.ndarray:
                return kernels.gaussian_kernel(sx, width)

        passes = 1
    elif kernel == "box":
        n = int(nsmooth)
        if n < 1:
            raise ValueError(f"box nsmooth must be >= 1, got {nsmooth}")
        k_len = max(1, min(n * n, min(h, w) - 1)) if min(h, w) > 1 else 1
        global_width = 2 * k_len - 1

        def taps_fn(width: int) -> np.ndarray:
            # Shrinking an axis re-derives the tent from a smaller box.
            k_axis = (width + 1) // 2
            return kernels.box_tent_kernel(k_axis)

        passes = 1  # pad already covers the tent's full support
    elif kernel == "box_fast":
        # FastBoxBlur parity: nsmooth here IS the radius (the api layer passes
        # radius = int(n^2) per the reference call site, Source.cpp:587).
        radius = int(nsmooth)
        if radius < 0:
            raise ValueError(f"box_fast radius must be >= 0, got {nsmooth}")
        n_passes = max(int(box_passes), 1)
        global_width = n_passes * 2 * radius + 1

        def taps_fn(width: int) -> np.ndarray:
            # per-axis clamp re-derives the radius from the clamped support
            r_axis = max((width - 1) // (2 * n_passes), 0)
            return kernels.box_passes_kernel(r_axis, n_passes)

        passes = 1
    else:
        raise ValueError(f"unknown kernel kind {kernel!r}")

    if sigma_x is not None:
        row = _axis_plan(w, global_width_row, taps_fn_row, passes, size_mode)
    else:
        row = _axis_plan(w, global_width, taps_fn, passes, size_mode)
    col = _axis_plan(h, global_width, taps_fn, passes, size_mode)
    return BlurPlan(
        shape=(h, w),
        kernel=kernel,
        sigma=sigma if kernel == "gaussian" else float(nsmooth),
        passes=passes,
        size_mode=size_mode,
        row=row,
        col=col,
        box_passes=max(int(box_passes), 1) if kernel == "box_fast" else 1,
        sigma_x=sigma_x,
    )


def make_custom_plan(
    shape: tuple[int, int],
    taps_row,
    taps_col=None,
    size_mode: str = "auto",
) -> BlurPlan:
    """Plan an arbitrary separable CORRELATION filter (reflect-101 borders).

    Beyond the reference's blur kernels: any odd-length 1-D taps per axis
    (sharpen, difference-of-Gaussians, derivative/edge filters, ...), applied
    with the same engine lattice. Semantics are correlation (the taps are
    dotted against the window as written — ``out[i] = sum_t taps[t] *
    x[i - r + t]``), matching ``oracle.blur_direct`` and ``cv2.filter2D``.

    Taps wider than an axis allows (``pad <= dim - 1``) are centrally
    truncated WITHOUT renormalization (custom taps have caller-defined
    scale). NOTE: ``AxisPlan.spectrum`` (the real spectrum) is the whole
    story only for symmetric taps; asymmetric taps additionally carry the
    full complex correlation spectrum in ``AxisPlan.spectrum_c``, which
    the FFT engines use — every engine handles arbitrary taps.
    """
    h, w = int(shape[0]), int(shape[1])
    if h < 1 or w < 1:
        raise ValueError(f"image shape must be positive, got {shape}")
    taps_col = taps_row if taps_col is None else taps_col

    def prep(taps, name: str):
        t = np.asarray(taps, dtype=np.float32).reshape(-1)
        if t.size < 1 or t.size % 2 == 0:
            raise ValueError(
                f"{name} taps must have odd length >= 1, got {t.size}"
            )
        if not np.all(np.isfinite(t)):
            raise ValueError(f"{name} taps must be finite")

        def taps_fn(width: int) -> np.ndarray:
            cut = (t.size - width) // 2
            return np.ascontiguousarray(t[cut : cut + width])

        return taps_fn, int(t.size)

    row_fn, row_w = prep(taps_row, "row")
    col_fn, col_w = prep(taps_col, "col")
    row = _axis_plan(w, row_w, row_fn, 1, size_mode)
    col = _axis_plan(h, col_w, col_fn, 1, size_mode)
    for name, ax in (("row", row), ("col", col)):
        # width-1 taps hit the engines' radius-0 identity shortcuts, which
        # do NOT apply a scalar tap — only an exact identity is legal there
        if ax.taps.shape[0] == 1 and float(ax.taps[0]) != 1.0:
            raise ValueError(
                f"{name} taps of width 1 must be exactly [1.0] (engines "
                f"treat radius 0 as identity), got {float(ax.taps[0])!r}"
            )
    return BlurPlan(
        shape=(h, w),
        kernel="custom",
        sigma=0.0,
        passes=1,
        size_mode=size_mode,
        row=row,
        col=col,
    )
