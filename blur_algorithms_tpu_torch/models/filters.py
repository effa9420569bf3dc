"""Composite filters built on the blur (unsharp masking, high-pass).

The port of the JAX package's ``models/filters.py``. The blur is K2, the
fused separable kernel (``cuda_kernels/fused_blur.blur_fused``, the JAX
``blur_fused(..., precision="bf16x3")``), with a float result; the
pointwise combine follows on the same device, and uint8 rounds once at the
end through ``ops/layout.round_to_u8`` (no double rounding through a uint8
intermediate). Every function runs on its input's device: a CUDA tensor
launches K2 (or, from the card's float split radius, the two passes of
its single-axis form), a CPU tensor runs the plain version.
"""

from __future__ import annotations

import functools

import torch

from blur_algorithms_tpu_torch.cuda_kernels.fused_blur import blur_fused
from blur_algorithms_tpu_torch.ops.layout import round_to_u8
from blur_algorithms_tpu_torch.ops.plan import BlurPlan, make_plan

__all__ = ["unsharp_mask", "high_pass"]


@functools.lru_cache(maxsize=128)
def _plan(h: int, w: int, sigma: float, size_mode: str) -> BlurPlan:
    return make_plan((h, w), sigma, size_mode=size_mode)


def _planar_u8(img: torch.Tensor) -> torch.Tensor:
    if img.ndim < 3:
        raise ValueError(
            f"uint8 input must be interleaved (..., H, W, C), got {tuple(img.shape)}"
        )
    return img.movedim(-1, -3).contiguous()


def _sharpen_planar(x: torch.Tensor, plan: BlurPlan, amount: float,
                    threshold: int) -> torch.Tensor:
    xf = x.to(torch.float32)
    detail = xf - blur_fused(x, plan)
    if threshold:
        # classic threshold: only boost detail above the cutoff
        detail = torch.where(detail.abs() >= threshold, detail, 0.0)
    return xf + amount * detail


def unsharp_mask(
    img: torch.Tensor,
    sigma: float,
    amount: float = 1.0,
    threshold: int = 0,
    size_mode: str = "auto",
) -> torch.Tensor:
    """Unsharp masking: ``out = x + amount * (x - gaussian_blur(x))``.

    uint8 interleaved ``(..., H, W, C)`` in -> uint8 out (one rounding at
    the end); float planar ``(..., H, W)`` in -> float32 out,
    differentiable. ``threshold`` (uint8 counts) suppresses detail below
    the cutoff — the classic noise-safe variant.
    """
    if img.dtype == torch.uint8:
        planar = _planar_u8(img)
        plan = _plan(planar.shape[-2], planar.shape[-1], float(sigma), size_mode)
        out = _sharpen_planar(planar, plan, float(amount), int(threshold))
        return round_to_u8(out).movedim(-3, -1).contiguous()
    plan = _plan(img.shape[-2], img.shape[-1], float(sigma), size_mode)
    return _sharpen_planar(img, plan, float(amount), int(threshold))


def high_pass(img: torch.Tensor, sigma: float, size_mode: str = "auto") -> torch.Tensor:
    """High-pass residual ``x - gaussian_blur(x)`` as float32 planar.

    Accepts uint8 interleaved or float planar; always returns float planar
    ``(..., C, H, W)`` / ``(..., H, W)`` (the residual is signed).
    """
    x = _planar_u8(img) if img.dtype == torch.uint8 else img
    plan = _plan(x.shape[-2], x.shape[-1], float(sigma), size_mode)
    return x.to(torch.float32) - blur_fused(x, plan)
