"""Host-side blur-kernel factory (NumPy; a copy of the JAX package's
``ops/kernels.py``, which cannot be imported without importing jax).

Replicates the reference's kernel math exactly so outputs are comparable
within float32 tolerance:

* ``gaussian_window``    — reference ``Source.cpp:60-73``
* ``gaussian_kernel``    — reference ``getGaussian``, ``Source.cpp:76-102``
* ``box_tent_kernel``    — reference 1-D ``box_kernel``, ``Source.cpp:129-140``
  (without the harmless ``icol <= kLen + 1`` over-iteration quirk, whose two
  extra taps are clamped to a zero contribution in the reference)
* ``wrap_centered``      — the ``std::rotate`` centering of ``Source.cpp:96-100``
* ``real_spectrum``      — rFFT of the wrapped kernel; a centered symmetric
  kernel has a purely real spectrum, so engines multiply by Re only
  (reference ``Source.cpp:258,362,378,423-425``; ``README.md:134``).

All functions run on the host; their outputs are plan constants that the
kernel wrappers turn into tap vectors.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "gaussian_window",
    "gaussian_kernel",
    "box_tent_kernel",
    "box_passes_kernel",
    "wrap_centered",
    "real_spectrum",
    "complex_spectrum",
]


def gaussian_window(sigma: float, max_width: int = 0) -> int:
    """Odd kernel width needed to contain a Gaussian of stddev ``sigma``.

    ``radius = sigma*sqrt(2*ln(255)) - 1`` (tails below 1/255 are clamped),
    ``width = trunc(2*radius + .5)``, clamped to ``max_width`` if given, then
    forced odd. Matches reference ``Source.cpp:60-73`` including its
    float32 intermediate.
    """
    radius = np.float32(sigma * math.sqrt(2.0 * math.log(255.0)) - 1.0)
    width = int(np.float32(radius * np.float32(2.0) + np.float32(0.5)))
    if max_width:
        width = min(width, int(max_width))
    if width % 2 == 0:
        width += 1
    return max(width, 1)


def gaussian_kernel(sigma: float, width: int) -> np.ndarray:
    """Normalized 1-D Gaussian taps, float32, length ``width`` (odd).

    Sampling and normalization follow reference ``Source.cpp:83-93``:
    sample ``exp(-y^2 / (2 sigma^2)) / (pi * 2 sigma^2)`` at integer offsets
    ``-mid..+mid`` (the prefactor cancels in normalization), store float32,
    then normalize by the float64 sum.
    """
    if width < 1 or width % 2 == 0:
        raise ValueError(f"kernel width must be odd and >= 1, got {width}")
    mid = (width - 1) / 2.0
    s = 2.0 * float(sigma) * float(sigma)
    if s == 0.0:
        taps = np.zeros(width, dtype=np.float32)
        taps[width // 2] = 1.0
        return taps
    y = np.arange(width, dtype=np.float64) - mid
    taps = (np.exp(-(y * y) / s) / (math.pi * s)).astype(np.float32)
    norm = 1.0 / float(np.sum(taps, dtype=np.float64))
    return (taps.astype(np.float64) * norm).astype(np.float32)


def box_tent_kernel(k_len: int) -> np.ndarray:
    """1-D tent taps ``(k - |i|) / k^2`` for ``i in [-(k-1), k-1]``, float32.

    A box kernel of length ``k`` convolved with itself ("2 passes of box
    blur"); sums to 1. Reference 1-D ``box_kernel``, ``Source.cpp:129-140``.
    """
    if k_len < 1:
        raise ValueError(f"box kernel length must be >= 1, got {k_len}")
    i = np.abs(np.arange(-(k_len - 1), k_len, dtype=np.float64))
    return ((k_len - i) / float(k_len) ** 2).astype(np.float32)


def box_passes_kernel(radius: int, passes: int = 2) -> np.ndarray:
    """Effective taps of ``passes`` sequential box blurs of radius ``radius``.

    The n-fold self-convolution of ``ones(2r+1)/(2r+1)``; width
    ``passes*2*radius + 1``. Sequential reflect-101 box passes are *exactly*
    equivalent to one pass with these taps (a symmetric kernel preserves the
    reflect-101 symmetry at the boundary), so the FastBoxBlur call-site
    semantics (radius = nsmooth^2, passes = 2, ``Source.cpp:587``) collapse
    to a single pass through any blur engine.
    """
    if radius < 0:
        raise ValueError(f"radius must be >= 0, got {radius}")
    if radius == 0:
        return np.ones(1, dtype=np.float32)
    box = np.ones(2 * radius + 1, dtype=np.float64) / (2 * radius + 1)
    taps = box
    for _ in range(max(passes, 1) - 1):
        taps = np.convolve(taps, box)
    return taps.astype(np.float32)


def wrap_centered(taps: np.ndarray, fft_length: int) -> np.ndarray:
    """Zero-pad ``taps`` to ``fft_length`` and wrap the center tap to index 0.

    Circular-convolution centering: the kernel's middle element lands at
    index 0 with the left half wrapped to the tail, as in the reference's
    ``std::rotate`` (``Source.cpp:96-100``) and the modular indexing of the
    box kernels (``Source.cpp:120-121,137``). Makes the spectrum purely real.
    """
    width = int(taps.shape[0])
    if width > fft_length:
        raise ValueError(f"kernel width {width} exceeds FFT length {fft_length}")
    padded = np.zeros(fft_length, dtype=np.float32)
    padded[:width] = taps
    return np.roll(padded, -(width // 2))


def real_spectrum(taps: np.ndarray, fft_length: int) -> np.ndarray:
    """Real part of the rFFT of the wrapped/centered kernel, float32.

    Shape ``(fft_length//2 + 1,)``. The imaginary part of a centered
    symmetric kernel is 0 (up to rounding), so the engines use Re only, like
    the reference spectral multiplies (``Source.cpp:258,362,378``).
    Computed with ``np.fft`` (single-precision pocketfft — the same library
    as the reference's flag-2/5 engines).
    """
    wrapped = wrap_centered(taps, fft_length)
    return np.fft.rfft(wrapped).real.astype(np.float32)


def complex_spectrum(taps: np.ndarray, fft_length: int) -> np.ndarray:
    """Full complex rFFT spectrum implementing CORRELATION by the taps.

    Shape ``(fft_length//2 + 1,)`` complex64. The engines compute
    ``irfft(rfft(x) * S)`` — a circular convolution by the wrapped kernel —
    but the plan semantics are correlation (``out[i] = sum_t taps[t] *
    x[i - r + t]``, matching ``oracle.blur_direct`` / ``cv2.filter2D``).
    Correlation is convolution by the REVERSED taps, and the wrapped reverse
    is the circular time-reversal of the wrapped taps, whose DFT is the
    conjugate — so ``S = conj(rfft(wrap_centered(taps)))``. For symmetric
    taps ``Im(S) = 0`` and ``Re(S)`` equals :func:`real_spectrum` exactly
    (the reference's real-spectrum trick, ``Source.cpp:258``, is the
    symmetric special case).
    """
    wrapped = wrap_centered(taps, fft_length)
    return np.conj(np.fft.rfft(wrapped)).astype(np.complex64)
