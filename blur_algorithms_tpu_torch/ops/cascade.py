"""Cascade engine: a huge-sigma Gaussian as k composed fused blurs.

A copy of the JAX package's ``ops/cascade.py``. Gaussian blurs form a
semigroup: blurring with sigma_1 then sigma_2 equals one blur with
sqrt(sigma_1^2 + sigma_2^2). A sigma whose support radius passes the fused
engine's reach decomposes into ``k`` identical steps of ``sigma / sqrt(k)``,
each on the fused engine at f32 precision (K2, or the two-pass split past
support radius 600). The fewest steps that fit win.

This approximates the reference's single truncated kernel (each step clips
its tails at the reference's 1/255 threshold and renormalises), so AUTO
never picks it; it is an explicit engine for extreme sigma.
"""

from __future__ import annotations

import functools
import math

import torch

from blur_algorithms_tpu_torch.ops import kernels
from blur_algorithms_tpu_torch.ops.layout import round_to_u8
from blur_algorithms_tpu_torch.ops.plan import make_plan

__all__ = ["blur_cascade", "blur_cascade_u8", "cascade_sigmas"]

# keep each step's support radius inside the fused engine's reach (the
# two-pass split serves r <= 4096; margin for odd shapes)
_STEP_MAX_RADIUS = 4000


def _radius_for(sigma: float) -> int:
    return (kernels.gaussian_window(sigma) - 1) // 2


def cascade_sigmas(sigma: float) -> list[float]:
    """Split ``sigma`` into the fewest equal steps the fused engine fits."""
    k = 1
    while _radius_for(sigma / math.sqrt(k)) > _STEP_MAX_RADIUS:
        k += 1
        if k > 64:
            raise ValueError(f"sigma {sigma} too large to cascade")
    return [sigma / math.sqrt(k)] * k


@functools.lru_cache(maxsize=64)  # keyed by the step limit too: tests lower it
def _cascade_plans(shape: tuple[int, int], sigma: float, size_mode: str,
                   step_max: int):
    return tuple(
        make_plan(shape, s, kernel="gaussian", size_mode=size_mode)
        for s in cascade_sigmas(sigma)
    )


def blur_cascade(planar: torch.Tensor, sigma: float,
                 size_mode: str = "auto") -> torch.Tensor:
    """Cascaded fused blur of float planar ``(..., H, W)`` (or uint8 in)
    -> float32; float input is differentiable."""
    from blur_algorithms_tpu_torch.cuda_kernels.fused_blur import blur_fused

    h, w = planar.shape[-2], planar.shape[-1]
    out = planar
    for plan in _cascade_plans((h, w), float(sigma), size_mode, _STEP_MAX_RADIUS):
        out = blur_fused(out, plan)
    return out


def blur_cascade_u8(planar_u8: torch.Tensor, sigma: float,
                    size_mode: str = "auto") -> torch.Tensor:
    """uint8 planar in/out: intermediate steps stay float32, one rounding."""
    return round_to_u8(blur_cascade(planar_u8, sigma, size_mode))
