"""FFT-size planning (host side).

The reference grows every transform axis to the nearest size that is a
multiple of 32 and {2,3,5}-smooth above that (``Utils.hpp:141-157``, a rule
inherited from pffft's real-transform constraints), covering the growth with
trailing zeros (``README.md:58``). A ``pow2`` mode is offered as well; the
math is unchanged (the growth region is provably never read by interior
outputs — the kernel reach from any cropped output pixel stays inside the
reflected pad).

Only the FFT engines read these sizes; the fused engine ignores them.
"""

from __future__ import annotations

__all__ = [
    "is_valid_size",
    "nearest_transform_size",
    "next_pow2",
    "plan_fft_size",
    "SIZE_MODES",
]

_N_MIN = 32

SIZE_MODES = ("auto", "smooth235", "pow2")

# ``auto`` is ``smooth235`` on every device the port runs on. The JAX
# package switches ``auto`` to pow2 on a TPU because XLA's TPU FFT compiles
# slowly at non-pow2 lengths; cuFFT and PocketFFT have fast plans for every
# {2,3,5}-smooth length and compile nothing, so CUDA and CPU keep the
# reference's sizes (and plans equal the JAX package's CPU plans).


def is_valid_size(n: int) -> bool:
    """True iff ``n`` reduces to 32 by dividing out 5s, then 3s, then 2s.

    Reference ``Utils.hpp:141-148`` (pffft's legality check for real
    transforms; also a fast size for pocketfft).
    """
    r = n
    while r >= 5 * _N_MIN and r % 5 == 0:
        r //= 5
    while r >= 3 * _N_MIN and r % 3 == 0:
        r //= 3
    while r >= 2 * _N_MIN and r % 2 == 0:
        r //= 2
    return r == _N_MIN


def nearest_transform_size(n: int) -> int:
    """Smallest valid size >= n, stepping in multiples of 32.

    Reference ``Utils.hpp:150-157``.
    """
    if n < _N_MIN:
        n = _N_MIN
    n = _N_MIN * ((n + _N_MIN - 1) // _N_MIN)
    while not is_valid_size(n):
        n += _N_MIN
    return n


def next_pow2(n: int) -> int:
    """Smallest power of two >= max(n, 32)."""
    n = max(int(n), _N_MIN)
    return 1 << (n - 1).bit_length()


def plan_fft_size(n: int, mode: str = "auto") -> int:
    """Legal transform length >= n for the given planner mode.

    ``smooth235`` (and ``auto``) reproduces the reference's padding policy
    exactly; ``pow2`` trades extra trailing zeros for power-of-two lengths.
    """
    if mode == "auto":
        mode = "smooth235"
    if mode == "smooth235":
        return n if is_valid_size(n) else nearest_transform_size(n)
    if mode == "pow2":
        return next_pow2(n)
    raise ValueError(f"unknown FFT size mode {mode!r}; expected one of {SIZE_MODES}")
