"""DFT_image debug mode: log-magnitude spectrum export.

The port of the JAX package's ``ops/spectrum.py``. Reference ``#define
DFT_image`` (``Source.cpp:13, 240-252``): instead of blurring, export
``20*log10(|Re(spectrum)| + 1e-5)`` of the padded image, fftshifted with
MATLAB's odd/even convention (``:244-247``) and the CCS half-spectrum
mirror-read of ``:247``. The gather indices are computed with NumPy on the
host; the transform is ``torch.fft.rfft2`` on the input's device.
"""

from __future__ import annotations

import numpy as np
import torch

from blur_algorithms_tpu_torch.ops.pad import reflect_101
from blur_algorithms_tpu_torch.ops.plan import BlurPlan

__all__ = ["dft_spectrum_planar"]


def dft_spectrum_planar(planar: torch.Tensor, plan: BlurPlan) -> torch.Tensor:
    """Log-magnitude spectrum of float32 planar ``(..., H, W)``.

    Output shape ``(..., fft_h, fft_w)`` (the padded, FFT-sized grid, as the
    reference writes the spectrum into the padded buffer).
    """
    (bt, bb), (bl, br) = plan.col.border, plan.row.border
    padded = reflect_101(planar.to(torch.float32), [(bt, bb), (bl, br)])
    s0, s1 = plan.fft_shape
    spec = torch.fft.rfft2(padded, dim=(-2, -1))

    rows = np.arange(s0)
    cols = np.arange(s1)
    row_ = (rows + (s0 if s0 % 2 == 0 else s0 + 1) // 2) % s0
    col_ = (cols + (s1 if s1 % 2 == 0 else s1 + 1) // 2) % s1
    half = s1 // 2 + 1
    # the reference's index math exactly; its formula equals the true mirror
    # (s1 - col_) only for even s1, the only case the size planners produce
    cval = np.where(col_ < half, col_, (s1 // 2) - col_ % (s1 // 2))

    ri = torch.from_numpy(row_).to(spec.device)
    ci = torch.from_numpy(cval).to(spec.device)
    re = spec.real.index_select(-2, ri).index_select(-1, ci)
    return 20.0 * torch.log10(re.abs() + 1e-5)
