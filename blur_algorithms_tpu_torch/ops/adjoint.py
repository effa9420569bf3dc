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

Past support radius 1024 a symmetric axis runs its ``ValidCorr^T`` as a
circular FFT convolution instead (``_valid_conv_wide``, as the JAX package
does): K3 on a CUDA tensor (its cluster form where the padded rows pass
16384, on 16 CTAs at 262144; its staged form past 262144), its plain
einsum version on a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from blur_algorithms_tpu_torch.ops.band_matmul import band_conv_valid
from blur_algorithms_tpu_torch.ops.plan import BlurPlan

__all__ = ["blur_adjoint"]

# above this support radius a symmetric axis runs its valid correlation
# through the four-step FFT (the JAX package's ``_valid_conv_wide``)
_ADJOINT_FFT_MIN_RADIUS = 1024


def _valid_conv_wide(padded: torch.Tensor, axis_plan, n_out: int) -> torch.Tensor:
    """Valid correlation along the last axis through the circular FFT
    convolution (K3): with enough trailing zeros (each row padded to the
    next power of two of its length) the circular correlation by the
    centered taps equals the valid one at offset r. Runs in float32 and
    returns the input's dtype."""
    from blur_algorithms_tpu_torch.cuda_kernels.fft4step import fft_conv_rows

    r = axis_plan.support_radius
    length = padded.shape[-1]
    n = max(256, 1 << (length - 1).bit_length())
    lead = padded.shape[:-1]
    rows = F.pad(padded.to(torch.float32), (0, n - length)).reshape(-1, n)
    out = fft_conv_rows(rows.contiguous(), n, axis_plan)
    return out[:, r : r + n_out].reshape(*lead, n_out).to(padded.dtype)


def _adjoint_axis(ct: torch.Tensor, axis_plan, axis: int) -> torch.Tensor:
    r = axis_plan.support_radius
    n = axis_plan.dim
    if r == 0:
        return ct
    ct = ct.movedim(axis, -1)
    padded = F.pad(ct, (2 * r, 2 * r))
    if r > _ADJOINT_FFT_MIN_RADIUS and axis_plan.symmetric:
        # the spectrum path holds for symmetric taps (flipped == taps)
        z = _valid_conv_wide(padded, axis_plan, n + 2 * r)
    else:
        flipped = np.ascontiguousarray(np.asarray(axis_plan.taps)[::-1])
        z = band_conv_valid(padded, flipped, n + 2 * r)
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
