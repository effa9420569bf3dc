"""Direct separable convolution engine (``"conv"``, the reference's flag 1).

The port of the JAX package's ``ops/direct_conv.py``: reflect-101 pad per
axis, then a valid 1-D correlation, rows pass then columns pass, every
plane of the batch in one call. The JAX engine is XLA's
``lax.conv_general_dilated`` at ``Precision.HIGHEST`` and no Pallas
kernel, so its faithful counterpart is ``F.conv1d`` (cuDNN on a CUDA
tensor, the CPU convolution on a CPU tensor); no kernel is written for it.
Both correlate (no kernel flip), the convention of every engine here.

cuDNN runs float32 convolutions in TF32 by default on the H100
(``torch.backends.cudnn.allow_tf32``), about 1e-3 relative from HIGHEST;
the call scopes ``torch.backends.cudnn.flags(allow_tf32=False)`` around
itself and leaves the process's flags as they were.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from blur_algorithms_tpu_torch.ops.pad import reflect_101
from blur_algorithms_tpu_torch.ops.plan import BlurPlan

__all__ = ["blur_conv"]


@contextlib.contextmanager
def _full_f32():
    """cuDNN without TF32 for the call; the other flags keep their values."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        yield


def _conv_pass(x: torch.Tensor, axis_plan, axis: int) -> torch.Tensor:
    """1-D valid correlation along ``axis`` of the reflect-101-padded data."""
    radius = axis_plan.support_radius
    x = x.movedim(axis, -1)
    padded = reflect_101(x, [(radius, radius)])
    lead = padded.shape[:-1]
    taps = torch.tensor(np.asarray(axis_plan.taps, np.float32), device=x.device)
    # (batch, channel=1, length): every row of every plane is one batch entry
    out = F.conv1d(padded.reshape(-1, 1, padded.shape[-1]), taps.reshape(1, 1, -1))
    return out.reshape(*lead, axis_plan.dim).movedim(-1, axis)


def blur_conv(planar: torch.Tensor, plan: BlurPlan) -> torch.Tensor:
    """Separable direct-convolution blur of float32 planar ``(..., H, W)``
    on the input's device; differentiable."""
    x = planar.to(torch.float32)
    with _full_f32():
        out = _conv_pass(x, plan.row, -1)
        return _conv_pass(out, plan.col, -2)
