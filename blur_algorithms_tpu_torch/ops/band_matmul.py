"""Banded-block matmul blur engine (``engine="band"``) and its building blocks.

The counterpart of the JAX package's ``ops/band_matmul.py``. A 1-D
correlation with taps of support ``2r + 1`` is a product with a banded
Toeplitz matrix; the axis is cut into blocks of ``T`` outputs, and each
block is an ``(T + 2r) x T`` dense product of an overlapping input window
with the banded block matrix. The JAX package leaves this product to XLA,
outside any Pallas kernel; here it is ``torch.matmul`` in float32.

Precision: ``torch.matmul`` on a CUDA device may run float32 products in
TF32 (about three decimal digits) when
``torch.backends.cuda.matmul.allow_tf32`` is set. Every product of this
module runs with that flag set to False for its duration (and restored
after), so the engine computes full float32 products on every device: at
least as accurate as the JAX engine's bf16x3 splits.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from blur_algorithms_tpu_torch.ops.pad import reflect_101
from blur_algorithms_tpu_torch.ops.plan import BlurPlan

__all__ = ["band_block_matrix", "band_conv_valid", "blur_band_matmul", "pick_block"]


def band_block_matrix(taps: np.ndarray, block: int) -> np.ndarray:
    """Banded block matrix ``B[(block + 2r) x block]``: ``B[k, j] = taps[k - j]``.

    ``window @ B`` convolves every length-``block + 2r`` input window down to
    ``block`` outputs ("valid" convolution with correlation orientation —
    symmetric taps make conv == corr; taps from the kernel factory are
    symmetric by construction).
    """
    width = int(taps.shape[0])
    r = (width - 1) // 2
    rows = block + 2 * r
    mat = np.zeros((rows, block), dtype=np.float32)
    for j in range(block):
        mat[j : j + width, j] = taps
    return mat


def pick_block(n: int, radius: int) -> int:
    """Output-block size: >= ~4r to bound the band's zero waste, a multiple
    of 128, <= the axis rounded up to 128."""
    t = max(128, 128 * ((4 * radius + 127) // 128))
    n_aligned = 128 * ((n + 127) // 128)
    return min(t, max(n_aligned, 128))


@contextlib.contextmanager
def _full_f32_matmul():
    """Run float32 matmuls in full float32 (no TF32) inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def band_conv_valid(
    padded: torch.Tensor,
    taps: np.ndarray,
    n_out: int,
    block: int | None = None,
) -> torch.Tensor:
    """Valid banded correlation along the last axis via blocked matmuls.

    ``padded`` must already carry ``r = (len(taps)-1)//2`` extra samples on
    each side of the ``n_out`` interior (any border policy). Float64 input
    stays float64; anything else is computed in float32.
    """
    taps = np.asarray(taps, dtype=np.float32)
    r = (int(taps.shape[0]) - 1) // 2
    if r == 0:
        return padded[..., :n_out]
    dtype = torch.float64 if padded.dtype == torch.float64 else torch.float32
    padded = padded.to(dtype)
    t = block or pick_block(n_out, r)
    nblocks = -(-n_out // t)
    total = nblocks * t
    if total + 2 * r > padded.shape[-1]:
        padded = torch.nn.functional.pad(padded, (0, total + 2 * r - padded.shape[-1]))
    windows = padded[..., : total + 2 * r].unfold(-1, t + 2 * r, t)  # (..., nb, t+2r)
    mat = torch.from_numpy(band_block_matrix(taps, t)).to(padded.device, dtype)
    with _full_f32_matmul():
        out = torch.matmul(windows, mat)  # (..., nb, t)
    return out.reshape(out.shape[:-2] + (total,))[..., :n_out]


def _band_pass(x: torch.Tensor, axis_plan, axis: int, block: int | None) -> torch.Tensor:
    r = axis_plan.support_radius
    if r == 0:
        return x
    x = x.movedim(axis, -1)
    padded = reflect_101(x, [(r, r)])
    out = band_conv_valid(padded, axis_plan.taps, axis_plan.dim, block)
    return out.movedim(-1, axis)


def blur_band_matmul(
    planar: torch.Tensor, plan: BlurPlan, block: int | None = None
) -> torch.Tensor:
    """Separable banded-matmul blur of planar ``(..., H, W)`` -> float32
    (float64 stays float64). Differentiable by torch's own autograd."""
    if planar.dtype != torch.float64:
        planar = planar.to(torch.float32)
    out = _band_pass(planar, plan.row, -1, block)
    return _band_pass(out, plan.col, -2, block)
