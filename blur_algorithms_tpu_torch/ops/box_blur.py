"""Fast box blur by cumulative-sum differences — a copy of the JAX
package's ``ops/box_blur.py``.

The reference's FastBoxBlur (``Source.cpp:587``) slides an accumulator
along each row (``out[i+1] = out[i] + in[i+r+1] - in[i-r]``) with reflect
borders, twice. The same O(N) math as a parallel scan: with ``cs`` the
exclusive cumulative sum of the reflect-101-padded axis,
``box[i] = (cs[i + 2r + 1] - cs[i]) / (2r + 1)``. Float32 throughout; the
result stays on the input's device. The hand-written kernel of the same
blur is K4 (``cuda_kernels/box_blur.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from blur_algorithms_tpu_torch.ops.pad import reflect_101

__all__ = ["box_blur_axis", "box_blur_planar"]


def box_blur_axis(x: torch.Tensor, radius: int, axis: int) -> torch.Tensor:
    """One box pass of width ``2*radius + 1`` along ``axis`` (reflect-101)."""
    if radius <= 0:
        return x
    n = x.shape[axis]
    r = min(radius, n - 1)  # clamp like Reflect_101 (Utils.hpp:217-220)
    width = 2 * r + 1
    x = x.movedim(axis, -1)
    padded = reflect_101(x, [(r, r)])
    cs = F.pad(torch.cumsum(padded, dim=-1, dtype=torch.float32), (1, 0))
    out = (cs[..., width : width + n] - cs[..., 0:n]) * (1.0 / width)
    return out.movedim(-1, axis)


def box_blur_planar(planar: torch.Tensor, radius: int, passes: int = 2) -> torch.Tensor:
    """``passes`` x (rows box + cols box) on float32 planar ``(..., H, W)``."""
    out = planar
    for _ in range(max(1, int(passes))):
        out = box_blur_axis(out, radius, -1)
        out = box_blur_axis(out, radius, -2)
    return out
