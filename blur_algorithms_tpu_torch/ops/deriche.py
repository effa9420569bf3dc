"""Deriche recursive-Gaussian engine (``"deriche"``): cost independent of
sigma.

The port of the JAX package's ``ops/deriche.py``. Deriche's 4th-order
recursive approximation of the Gaussian (R. Deriche, "Recursively
implementing the Gaussian and its derivatives", 1993) writes the kernel as
two complex exponential modes

    g_sigma(k) ~ h(k) = Re[ sum_p gamma_p z_p^|k| ],   z_p = e^{(-b_p + i w_p)/sigma}

and the axis is cut into L-length blocks, so that the operator splits
exactly into

    y = band(x, h[|k| <= 2L-1])                    # 511 taps: K2
      + Re sum_p gamma_p z_p^(o+L+1) s_p[j-2]      # left-tail block states
      + Re sum_p gamma_p z_p^(2L-o)   r_p[j+2]     # right-tail block states
      - V_L x_{j-2} - V_R x_{j+2}                  # band/state overlap

with ``s_p`` / ``r_p`` per-block mode accumulators (a scan over ~N/L
blocks) and fixed (L, L) triangular corrections ``V``. The NumPy constants
(``_MODES``, ``_L``, ``_RB``, ``_SIGMA_MIN``, ``_PAD_SIGMAS``,
``deriche_taps``, ``_consts``, ``deriche_applicable``, ``_band_plans``) are
copied as they are.

Here the two band passes run K2's single-axis form
(``cuda_kernels/fused_blur.blur_fused_axis_f32``, r 255) on a CUDA tensor
and its plain version on a CPU tensor, differentiable through ``_Band``
(backward: the blur's adjoint); the rows band takes uint8 planes as they
are, as the JAX band kernel does. The tails are torch ops on the input's
device: the block scan is a log-depth doubling over the block axis with
powers of the per-block decay (the JAX ``lax.associative_scan``), and its
products (the JAX einsums at ``Precision.HIGHEST``) run in float64, so no
TF32 setting of the process reaches them; the tails return float32.
uint8 rounds once, at the end. AUTO never routes this engine, as in JAX.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from blur_algorithms_tpu_torch.ops.adjoint import blur_adjoint
from blur_algorithms_tpu_torch.ops.layout import round_to_u8
from blur_algorithms_tpu_torch.ops.pad import reflect_101
from blur_algorithms_tpu_torch.ops.plan import BlurPlan, make_custom_plan

__all__ = [
    "blur_deriche",
    "blur_deriche_u8",
    "deriche_applicable",
    "deriche_taps",
]

# Deriche 1993 4th-order constants: (a, s, b, w) per complex pole pair;
# h(x) = sum_pairs (a cos(w x/sigma) + s sin(w x/sigma)) e^{-b x/sigma}
_MODES = (
    (1.6800, 3.7350, 1.7830, 0.6318),
    (-0.6803, -0.2598, 1.7230, 1.9970),
)

_L = 128  # state-block length
_RB = 2 * _L - 1  # band radius: fixed 255 -> 511 taps through K2

# Deriche-vs-truncated-Gaussian L1 bound crosses 1.0/255 near sigma=5 and
# is ~0.62/255 at sigma=10; certified from 16 with margin for the numerics.
_SIGMA_MIN = 16.0
# pad factor: tail mass beyond 4.75*sigma is ~2e-4 of the kernel (~0.02
# uint8 counts adversarially) — the scan-truncation budget
_PAD_SIGMAS = 4.75


def _modes(sigma: float):
    """Normalized mode amplitudes and poles (complex128)."""
    g = np.array([complex(a, -s) for a, s, _, _ in _MODES])
    z = np.array([np.exp(complex(-b, w) / sigma) for _, _, b, w in _MODES])
    scale = np.sum((g * (1 + z) / (1 - z)).real)  # sum_{k in Z} h(|k|)
    return g / scale, z


def _hn(dist: np.ndarray, gn: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Normalized kernel values at integer distances >= 0 (float64)."""
    return np.sum(gn[None, :] * z[None, :] ** dist[:, None], axis=-1).real


def deriche_taps(sigma: float) -> np.ndarray:
    """The 511 band taps h_n[|k| <= 255], float32 (the near-field part)."""
    gn, z = _modes(sigma)
    half = _hn(np.arange(_RB + 1), gn, z)
    return np.concatenate([half[:0:-1], half]).astype(np.float32)


def _scan_pad(sigma: float) -> int:
    """One-side reflect pad for the state scans (tail-truncation budget)."""
    return max(_RB + 1, math.ceil(_PAD_SIGMAS * sigma))


def deriche_applicable(shape: tuple[int, int], sigma: float) -> bool:
    """True when the Deriche engine serves this (shape, sigma).

    Requires sigma >= 16 (kernel-approximation accuracy gate) and both axes
    long enough for the scan reflect pad (``<= dim - 1``), which also covers
    the band pass's 255-pixel pad.
    """
    if sigma < _SIGMA_MIN:
        return False
    return _scan_pad(sigma) <= min(int(shape[0]), int(shape[1])) - 1


@functools.lru_cache(maxsize=32)
def _consts(sigma: float) -> dict:
    """Constant matrices for one sigma (NumPy float32)."""
    gn, z = _modes(sigma)
    o = np.arange(_L)
    wl = gn[None, :] * z[None, :] ** (o[:, None] + _L + 1)  # (L, P) complex
    wr = gn[None, :] * z[None, :] ** (2 * _L - o[:, None])
    pl = z[None, :] ** (_L - 1 - o)[:, None]  # left-state injection (L, P)
    pr = z[None, :] ** o[:, None]  # right-state injection
    hv = _hn(np.arange(3 * _L), gn, z)
    vl = np.zeros((_L, _L), np.float64)  # overlap vs left states (x_{j-2})
    vr = np.zeros((_L, _L), np.float64)  # overlap vs right states (x_{j+2})
    for oo in range(_L):
        for op in range(oo + 1, _L):
            vl[oo, op] = hv[2 * _L + oo - op]
        for op in range(oo):
            vr[oo, op] = hv[2 * _L + op - oo]
    f32 = lambda m: np.ascontiguousarray(m, dtype=np.float32)
    return {
        "decay": (z ** _L).astype(np.complex64),  # per-block state decay
        "wl_re": f32(wl.real), "wl_im": f32(wl.imag),
        "wr_re": f32(wr.real), "wr_im": f32(wr.imag),
        "pl_re": f32(pl.real), "pl_im": f32(pl.imag),
        "pr_re": f32(pr.real), "pr_im": f32(pr.imag),
        "vl": f32(vl), "vr": f32(vr),
    }


@functools.lru_cache(maxsize=32)
def _complex_consts(sigma: float) -> dict:
    """``_consts`` as complex128 / float64 matrices for the tails."""
    c = _consts(float(sigma))
    as_c = lambda re, im: (c[re].astype(np.float64) + 1j * c[im].astype(np.float64))
    return {
        "decay": c["decay"].astype(np.complex128),
        "pl": as_c("pl_re", "pl_im"), "pr": as_c("pr_re", "pr_im"),
        "wl": as_c("wl_re", "wl_im"), "wr": as_c("wr_re", "wr_im"),
        "vl": c["vl"].astype(np.float64), "vr": c["vr"].astype(np.float64),
    }


def _scan_states(inj: torch.Tensor, decay: torch.Tensor, reverse: bool) -> torch.Tensor:
    """Affine scan ``s[b] = z^L s[b-1] + inj[b]`` over the block axis (-2),
    ``inj`` complex ``(..., B, P)``: log-depth doubling, step k adding
    ``decay^k s[b-k]`` (powers that underflow to 0 add nothing)."""
    s = inj.flip(-2) if reverse else inj
    nb = s.shape[-2]
    k, power = 1, decay
    while k < nb:
        shifted = F.pad(torch.view_as_real(s[..., : nb - k, :]), (0, 0, 0, 0, k, 0))
        s = s + power * torch.view_as_complex(shifted)
        k, power = 2 * k, power * power
    return s.flip(-2) if reverse else s


def _shift_blocks(arr: torch.Tensor, offset: int) -> torch.Tensor:
    """``arr`` shifted along the block axis (-2) by ``offset`` (zero-filled)."""
    nb = arr.shape[-2]
    zeros = arr.new_zeros((*arr.shape[:-2], abs(offset), arr.shape[-1]))
    if offset > 0:  # arr[..., b - offset, :]
        return torch.cat([zeros, arr[..., : nb - offset, :]], dim=-2)
    return torch.cat([arr[..., -offset:, :], zeros], dim=-2)


def _tails_last(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Tail contributions (|k| > 255) along the last axis of ``(..., N)``,
    float32.

    The near field (|k| <= 255) is the band pass's job; this adds the
    exponential tails exactly (given the mode model) from per-block
    boundary states over the reflect-extended axis, zero-filled past the
    reflect pad so the interior starts block-aligned with two state blocks
    before it.
    """
    c = _complex_consts(float(sigma))
    dev = x.device
    t = lambda name: torch.from_numpy(c[name]).to(dev)
    n = x.shape[-1]
    pad = _scan_pad(sigma)
    xp = reflect_101(x.to(torch.float64), [(pad, pad)], axes=[-1])
    a = (-pad) % _L
    if (a + pad) // _L < 2:
        a += _L * (2 - (a + pad) // _L)
    j_last = (a + pad + n - 1) // _L
    npad = max(-(-(a + xp.shape[-1]) // _L), j_last + 3) * _L
    xp = F.pad(xp, (a, npad - a - xp.shape[-1]))
    xb = xp.reshape(*xp.shape[:-1], npad // _L, _L)
    start = a + pad  # interior start (block-aligned)

    xc = xb.to(torch.complex128)
    sl = _shift_blocks(_scan_states(xc @ t("pl"), t("decay"), reverse=False), 2)
    sr = _shift_blocks(_scan_states(xc @ t("pr"), t("decay"), reverse=True), -2)
    tail = (sl @ t("wl").T + sr @ t("wr").T).real
    # subtract the band/state overlap
    tail = tail - _shift_blocks(xb, 2) @ t("vl").T - _shift_blocks(xb, -2) @ t("vr").T
    tail = tail.reshape(*tail.shape[:-2], npad)
    return tail[..., start : start + n].to(torch.float32)


@functools.lru_cache(maxsize=32)
def _band_plans(shape: tuple[int, int], sigma: float) -> tuple:
    taps = deriche_taps(sigma)
    ident = np.array([1.0], np.float32)
    return (
        make_custom_plan(shape, taps, ident),  # rows band
        make_custom_plan(shape, ident, taps),  # cols band
    )


class _Band(torch.autograd.Function):
    """One 511-tap band pass on K2's single-axis form; backward the blur's
    adjoint (the band is linear)."""

    @staticmethod
    def forward(ctx, planar: torch.Tensor, plan: BlurPlan) -> torch.Tensor:
        from blur_algorithms_tpu_torch.cuda_kernels.fused_blur import blur_fused_axis_f32

        ctx.plan = plan
        return blur_fused_axis_f32(planar, plan)

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        return blur_adjoint(ct, ctx.plan), None


def _blur_deriche_impl(planar: torch.Tensor, sigma: float, out_u8: bool) -> torch.Tensor:
    h, w = planar.shape[-2], planar.shape[-1]
    plan_r, plan_c = _band_plans((h, w), float(sigma))
    x = planar
    if x.dtype not in (torch.uint8, torch.float64):  # float64 stays, for gradient checks
        x = x.to(torch.float32)
    x = x.contiguous()
    # rows: band pass (uint8 or f32 in) + exponential tails
    y = _Band.apply(x, plan_r) + _tails_last(x, sigma)
    # cols: the same along axis -2
    yc = _Band.apply(y, plan_c)
    tc = _tails_last(y.transpose(-1, -2), sigma).transpose(-1, -2)
    out = yc + tc
    return round_to_u8(out) if out_u8 else out


def _check(shape, sigma: float) -> None:
    if not deriche_applicable(tuple(shape[-2:]), float(sigma)):
        raise ValueError(
            f"deriche engine not applicable: shape {tuple(shape[-2:])}, "
            f"sigma {sigma} (needs sigma >= {_SIGMA_MIN} and "
            f"{_PAD_SIGMAS}*sigma reflect pad <= dim - 1)"
        )


def blur_deriche(planar: torch.Tensor, sigma: float) -> torch.Tensor:
    """Recursive-Gaussian blur of planar ``(..., H, W)`` -> float32, on the
    input's device; differentiable.

    Cost independent of sigma (the band is fixed at 511 taps; the tails
    are O(1) per pixel). Raises ``ValueError`` where ``deriche_applicable``
    is false. Within 1 uint8 count of the truncated-Gaussian oracle.
    """
    _check(planar.shape, sigma)
    return _blur_deriche_impl(planar, float(sigma), False)


def blur_deriche_u8(planar_u8: torch.Tensor, sigma: float) -> torch.Tensor:
    """uint8 planar ``(..., H, W)`` -> uint8 via the Deriche engine."""
    _check(planar_u8.shape, sigma)
    return _blur_deriche_impl(planar_u8, float(sigma), True)
