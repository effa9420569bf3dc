"""Four-step FFT convolution: the radius-free engine's host constants, its
per-axis framing and its plain version.

The port of the JAX package's ``ops/fft_mxu.py``. The JAX engine factors a
transform length ``n = n1 * n2`` and runs the length-``n`` DFT as two
batched complex matmuls by ``(n1 x n1)`` / ``(n2 x n2)`` DFT matrices with a
twiddle multiply between them (Bailey's four-step), so its cost per sample
does not grow with the kernel radius. Two real rows ride one complex
transform: the kernel is real in space, so with ``z = a + i*b``,
``IFFT(H . FFT(z)) = (h*a) + i*(h*b)`` by linearity.

Here the same constants (``_factor``, ``_stage_consts``,
``_perm_spectrum_c``, ``transform_length``, ``estimate_bytes``, equal to
the JAX ones value for value) and the same framing (``conv_axis``:
reflect-101 pad, trailing zeros to ``n``, crop) serve two things:

- ``_conv_rows_einsum``, the four-step in full float32 ``torch.einsum``
  (JAX runs it at ``Precision.HIGHEST`` off the TPU): the plain version of
  the CUDA kernels K3 and K3f (``cuda_kernels/fft4step.py``);
- ``blur_fft_mxu``, the whole separable blur through it, on any device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from blur_algorithms_tpu_torch.ops.band_matmul import _full_f32_matmul
from blur_algorithms_tpu_torch.ops.kernels import wrap_centered
from blur_algorithms_tpu_torch.ops.pad import reflect_101
from blur_algorithms_tpu_torch.ops.plan import BlurPlan

__all__ = ["blur_fft_mxu", "conv_axis", "estimate_bytes", "transform_length"]


def _factor(n: int) -> tuple[int, int]:
    """Split ``n`` into DFT stage factors (n1, n2), n = n1 * n2.

    Composite lengths from ``transform_length`` are ``128 * m``: n1 = 128;
    small pow2 lengths (< 4096) split near sqrt(n).
    """
    if n % 128 == 0 and n // 128 >= 32:
        return 128, n // 128
    lg = n.bit_length() - 1
    n1 = 1 << ((lg + 1) // 2)
    return n1, n // n1


@functools.lru_cache(maxsize=64)
def _stage_consts(n: int, factors: tuple[int, int] | None = None):
    """DFT matrices and twiddles for length ``n`` (float64 rounded to
    float32); ``factors`` overrides ``_factor(n)``."""
    n1, n2 = factors or _factor(n)

    def dft(m: int):
        k = np.arange(m)[:, None].astype(np.float64)
        t = np.arange(m)[None, :].astype(np.float64)
        ang = -2.0 * np.pi * k * t / m
        return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)

    f1 = dft(n1)
    f2 = dft(n2)
    k1 = np.arange(n1)[:, None].astype(np.float64)
    t2 = np.arange(n2)[None, :].astype(np.float64)
    ang = -2.0 * np.pi * k1 * t2 / n
    tw = (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))
    return n1, n2, f1, f2, tw


def _mm(mat: torch.Tensor, x: torch.Tensor, side: str) -> torch.Tensor:
    """Real matmul of a (K, B) constant against x, contracting axis ``side``.

    ``sub``:  out[..., k, m] = sum_b mat[k, b] x[..., b, m]
    ``lane``: out[..., c, k] = sum_b mat[k, b] x[..., c, b]
    """
    eq = "kb,...bm->...km" if side == "sub" else "kb,...cb->...ck"
    return torch.einsum(eq, mat, x)


def _cmm(mat_re, mat_im, xre, xim, side: str):
    """Complex matmul via Gauss's 3-multiplication identity."""
    p1 = _mm(mat_re, xre, side)
    p2 = _mm(mat_im, xim, side)
    p3 = _mm(mat_re + mat_im, xre + xim, side)
    return p1 - p2, p3 - p1 - p2


def _fft4step(xre, xim, consts, inverse: bool):
    """Length-N DFT of (..., n1, n2) complex data (row-major n = n1*n2 + n2).

    Forward output bin (k1, k2) holds natural frequency k1 + n1*k2; the
    inverse consumes that same layout. No reordering ever happens.
    """
    n1, n2, (f1re, f1im), (f2re, f2im), (twre, twim) = consts
    if inverse:
        f1im, f2im, twim = -f1im, -f2im, -twim
    if not inverse:
        # stage 1 over n1, twiddle, stage 2 over n2
        are, aim = _cmm(f1re, f1im, xre, xim, "sub")
        are, aim = are * twre - aim * twim, are * twim + aim * twre
        return _cmm(f2re, f2im, are, aim, "lane")
    # inverse: undo stage 2, conjugate twiddle, undo stage 1, scale 1/N
    are, aim = _cmm(f2re, f2im, xre, xim, "lane")
    are, aim = are * twre - aim * twim, are * twim + aim * twre
    yre, yim = _cmm(f1re, f1im, are, aim, "sub")
    s = 1.0 / (n1 * n2)
    return yre * s, yim * s


@functools.lru_cache(maxsize=256)
def _perm_spectrum_c(plan_axis, n: int, factors: tuple[int, int] | None = None):
    """(hre, him) correlation spectrum in (k1, k2) layout; him None when
    the taps are symmetric (purely real spectrum)."""
    n1, n2 = factors or _factor(n)
    # conj: engines implement circular convolution; plan semantics are
    # correlation (kernels.complex_spectrum)
    full = np.conj(np.fft.fft(wrap_centered(plan_axis.taps, n)))
    hre = np.ascontiguousarray(full.real.astype(np.float32).reshape(n2, n1).T)
    if plan_axis.symmetric:
        return hre, None
    him = np.ascontiguousarray(full.imag.astype(np.float32).reshape(n2, n1).T)
    return hre, him


def transform_length(axis_plan) -> int:
    """Planned transform length for one axis.

    ``dim + 2 * pad`` rounds up to the next power of two (at least 256) up
    to 4096 and past 16384; in 4096..16384 to the next ``128 * (multiple
    of 8)``, which bounds the zero-pad waste at ~3% (4902 plans 5120, not
    8192).
    """
    need = axis_plan.dim + 2 * axis_plan.pad
    if need <= 4096 or need > 16384:
        return max(256, 1 << (need - 1).bit_length())
    m = -(-need // 128)
    return 128 * (-(-m // 8) * 8)


def conv_axis(x: torch.Tensor, axis_plan, axis: int, conv_rows) -> torch.Tensor:
    """Per-axis framing shared by every form: reflect-101 pad by the axis
    pad, trailing zeros to the transform length, convolve every row via
    ``conv_rows(rows, n, axis_plan)``, crop ``[pad, pad + dim)``."""
    pad, dim = axis_plan.pad, axis_plan.dim
    if axis_plan.support_radius == 0:
        return x
    x = x.movedim(axis, -1)
    lead = x.shape[:-1]
    n = transform_length(axis_plan)
    tile = reflect_101(x, [(pad, pad)])
    tile = F.pad(tile, (0, n - tile.shape[-1]))
    out = conv_rows(tile.reshape(-1, n), n, axis_plan)
    out = out[:, pad : pad + dim].reshape(*lead, dim)
    return out.movedim(-1, axis)


@functools.lru_cache(maxsize=64)
def _device_consts(n: int, device: torch.device):
    n1, n2, f1, f2, tw = _stage_consts(n)
    return n1, n2, *(
        tuple(torch.from_numpy(a).to(device) for a in pair) for pair in (f1, f2, tw)
    )


def _conv_rows_einsum(rows: torch.Tensor, n: int, axis_plan) -> torch.Tensor:
    """(R, n) real float32 rows -> circularly convolved rows, through
    full-float32 einsums: the plain version of K3."""
    consts = _device_consts(n, rows.device)
    n1, n2 = consts[:2]
    r = rows.shape[0]
    r2 = (r + 1) // 2
    rows = rows.to(torch.float32)
    if r % 2:
        rows = F.pad(rows, (0, 0, 0, 1))
    # two real rows per complex transform
    zre = rows[:r2].reshape(r2, n1, n2)
    zim = rows[r2:].reshape(r2, n1, n2)
    hre, him = _perm_spectrum_c(axis_plan, n)
    hre = torch.from_numpy(hre).to(rows.device)
    with _full_f32_matmul():
        sre, sim = _fft4step(zre, zim, consts, inverse=False)
        if him is None:
            # symmetric taps: purely real spectrum
            sre, sim = sre * hre, sim * hre
        else:
            # asymmetric taps: full complex multiply (the kernel is real in
            # space, so the two packed rows still separate)
            him = torch.from_numpy(him).to(rows.device)
            sre, sim = sre * hre - sim * him, sre * him + sim * hre
        yre, yim = _fft4step(sre, sim, consts, inverse=True)
    return torch.cat([yre.reshape(r2, n), yim.reshape(r2, n)], dim=0)[:r]


def estimate_bytes(plan: BlurPlan, lead_elems: int = 3) -> int:
    """Rough peak device bytes of the whole-frame padded f32 rows;
    ``lead_elems`` is the product of the leading (batch x channel) dims."""
    h, w = plan.shape
    total = 0
    for axis_plan, rows in ((plan.row, lead_elems * h), (plan.col, lead_elems * w)):
        n = transform_length(axis_plan)
        total = max(total, 3 * rows * n * 4)  # in + complex out pair
    return total


def blur_fft_mxu(planar: torch.Tensor, plan: BlurPlan) -> torch.Tensor:
    """Separable four-step FFT convolution of planar ``(..., H, W)`` ->
    float32, in full float32 einsums on the input's device."""
    out = conv_axis(planar.to(torch.float32), plan.row, -1, _conv_rows_einsum)
    return conv_axis(out, plan.col, -2, _conv_rows_einsum)
