"""Closed-form Wiener deconvolution through the blur's own spectra.

The port of the JAX package's ``models/deconvolve.py`` (``jnp.fft`` there,
``torch.fft`` here, on the input's device). The blurs are circular
convolutions by a separable kernel with a real spectrum, so the inverse is
one 2-D rFFT, a per-bin Wiener gain

    W(k) = H(k) / (H(k)^2 + balance)

built from the two 1-D kernel spectra (never a 2-D table), and one inverse
transform, with the forward blur's reflect-101 geometry (border bins are
approximate in the usual Wiener sense).
"""

from __future__ import annotations

import functools

import torch

from blur_algorithms_tpu_torch.ops.fft_conv import _mirror_full, rfft2_pipeline
from blur_algorithms_tpu_torch.ops.layout import from_planar, round_to_u8, to_planar
from blur_algorithms_tpu_torch.ops.plan import BlurPlan, make_plan

__all__ = ["wiener_deconvolve"]


@functools.lru_cache(maxsize=64)
def _wiener_plan(h: int, w: int, nsmooth: float, kernel: str, size_mode: str) -> BlurPlan:
    plan = make_plan((h, w), nsmooth, kernel=kernel, size_mode=size_mode)
    if not (plan.col.symmetric and plan.row.symmetric):
        raise ValueError("wiener_deconvolve expects a symmetric blur kernel")
    return plan


def _wiener(planar: torch.Tensor, plan: BlurPlan, balance: float) -> torch.Tensor:
    hc = torch.from_numpy(_mirror_full(plan.col.spectrum, plan.fft_shape[0])).to(planar.device)
    hr = torch.from_numpy(plan.row.spectrum).to(planar.device)

    def gain(spec):
        h2d = hc[:, None] * hr
        return spec * (h2d / (h2d * h2d + balance))

    return rfft2_pipeline(planar.to(torch.float32), plan, gain)


def wiener_deconvolve(img: torch.Tensor, nsmooth: float, balance: float = 1e-3,
                      kernel: str = "gaussian", size_mode: str = "auto") -> torch.Tensor:
    """Invert a blur: uint8 interleaved ``(..., H, W, C)`` -> uint8, or
    float planar ``(..., H, W)`` -> float32.

    ``nsmooth`` / ``kernel`` name the forward blur as ``blur`` does;
    ``balance`` is the Wiener regularizer (noise-to-signal ratio): smaller
    recovers more detail but amplifies noise at bins the blur crushed."""
    is_u8 = img.dtype == torch.uint8
    planar = to_planar(img) if is_u8 else img
    plan = _wiener_plan(planar.shape[-2], planar.shape[-1], float(nsmooth), kernel, size_mode)
    out = _wiener(planar, plan, float(balance))
    return from_planar(round_to_u8(out)) if is_u8 else out
