"""Planar <-> interleaved layout with the reference's exact uint8 rounding.

Reference ``deinterleave_BGR``/``interleave_BGR`` (``Utils.hpp:159-210``)
split interleaved uint8 pixels into planar float arrays and merge them back,
adding ``+0.5`` exactly when converting float -> integral (round-half-up via
C truncation, ``Utils.hpp:163,189``). Values outside [0, 255] are clipped.

Every function keeps its input's device. The layout copies run in the spans
``layout.to_planar`` and ``layout.from_planar`` (``utils/trace.py``): a
uint8 -> uint8 move of CUDA frames with 3 channels, of any strides, launches
the port's kernel (``cuda_kernels/layout.py``), every other input
``movedim(...).contiguous()`` with its conversion. Both give the same bytes.
"""

from __future__ import annotations

import torch

from blur_algorithms_tpu_torch.cuda_kernels import layout as layout_kernels
from blur_algorithms_tpu_torch.utils.trace import span

__all__ = ["to_planar", "from_planar", "round_to_u8"]


def _takes_kernel(x: torch.Tensor, dtype, channel_axis: int) -> bool:
    """Whether the move of ``x`` to ``dtype`` runs the port's kernel: a
    uint8 CUDA tensor of 3 channels (on ``channel_axis``) bound for uint8."""
    return (x.is_cuda and x.dtype == torch.uint8 and dtype == torch.uint8 and x.dim() >= 3
            and x.shape[channel_axis] == 3)


def to_planar(interleaved: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(..., H, W, C) interleaved -> (..., C, H, W) planar, cast to ``dtype``
    (contiguous)."""
    with span("layout.to_planar"):
        if _takes_kernel(interleaved, dtype, -1):
            return layout_kernels.to_planar_u8(interleaved)
        return interleaved.movedim(-1, -3).to(dtype).contiguous()


def round_to_u8(x: torch.Tensor) -> torch.Tensor:
    """float -> uint8 with the reference's +0.5 truncation (round-half-up)."""
    return torch.clamp(torch.floor(x + 0.5), 0.0, 255.0).to(torch.uint8)


def from_planar(planar: torch.Tensor, dtype=torch.uint8) -> torch.Tensor:
    """(..., C, H, W) planar -> (..., H, W, C) interleaved (contiguous).

    A float input bound for uint8 gets the +0.5 round-half-up of
    ``Utils.hpp:189,204-206``; a uint8 input is only moved.
    """
    with span("layout.from_planar"):
        if _takes_kernel(planar, dtype, -3):
            return layout_kernels.from_planar_u8(planar)
        interleaved = planar.movedim(-3, -1)
        if dtype == torch.uint8 and planar.dtype != torch.uint8:
            interleaved = round_to_u8(interleaved)
        return interleaved.to(dtype).contiguous()
