"""Adjoint of the blur operator: the backward pass of the fused kernel.

The counterpart of the JAX package's ``ops/adjoint.py``. The blur is
linear, ``y = Crop . ValidCorr(taps) . ReflectPad101`` per axis, so its
adjoint per axis is ``ReflectPad101^T . ValidCorr(taps)^T``:

* ``ValidCorr^T``: zero-pad the cotangent by ``2r`` per side and run the
  valid correlation with the FLIPPED taps (``band_conv_valid``; flipping
  matters for asymmetric custom taps);
* ``ReflectPad101^T``: fold each reflected pad sample's cotangent back onto
  the interior pixel it mirrored (positions ``1..r`` from the left pad,
  ``n-2..n-r-1`` from the right pad).

The JAX package moves the ``ValidCorr^T`` of radii past 1024 to an FFT; the
port serves radii up to 600, so that branch cannot be reached and raises.
"""

from __future__ import annotations

import numpy as np
import torch

from blur_algorithms_tpu_torch.ops.band_matmul import band_conv_valid
from blur_algorithms_tpu_torch.ops.plan import BlurPlan

__all__ = ["blur_adjoint"]

# above this support radius the JAX adjoint runs its valid correlation
# through the MXU FFT (``_valid_conv_wide`` there)
_ADJOINT_FFT_MIN_RADIUS = 1024


def _adjoint_axis(ct: torch.Tensor, axis_plan, axis: int) -> torch.Tensor:
    r = axis_plan.support_radius
    n = axis_plan.dim
    if r == 0:
        return ct
    if r > _ADJOINT_FFT_MIN_RADIUS:
        raise NotImplementedError(
            f"the adjoint at support radius {r} > {_ADJOINT_FFT_MIN_RADIUS} "
            "runs through the FFT engines (ROADMAP.md Queue 1 item 7)"
        )
    ct = ct.movedim(axis, -1)
    flipped = np.ascontiguousarray(np.asarray(axis_plan.taps)[::-1])
    z = band_conv_valid(
        torch.nn.functional.pad(ct, (2 * r, 2 * r)), flipped, n + 2 * r
    )
    out = z[..., r : r + n].clone()
    eff = min(r, n - 1)  # the forward pad was clamped to dim - 1
    if eff > 0:
        # pad positions r-1..r-eff mirror sources 1..eff
        out[..., 1 : eff + 1] += z[..., r - eff : r].flip(-1)
        # pad positions r+n..r+n+eff-1 mirror sources n-2..n-1-eff
        out[..., n - 1 - eff : n - 1] += z[..., r + n : r + n + eff].flip(-1)
    return out.movedim(-1, axis)


def blur_adjoint(ct: torch.Tensor, plan: BlurPlan) -> torch.Tensor:
    """Apply the adjoint of the planned blur to cotangent ``(..., H, W)``
    (float32; float64 stays float64)."""
    if ct.dtype != torch.float64:
        ct = ct.to(torch.float32)
    out = _adjoint_axis(ct, plan.row, -1)
    return _adjoint_axis(out, plan.col, -2)
