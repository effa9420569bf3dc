"""Reflect-101 border padding as an index gather.

Reference: ``Reflect_101`` (``Utils.hpp:212-243``) pads like OpenCV's
``BORDER_REFLECT_101`` (the edge pixel is not duplicated:
``g f e d c b | A B C D E F G | f e d c b a``, ``README.md:47-53``), with
every pad clamped to ``dim - 1`` to prevent out-of-buffer reads
(``Utils.hpp:217-220``). Any residual request beyond the clamp is filled
with zeros, as in the JAX package's ``ops/pad.py``.

The pad is a precomputed reflect index vector and ``index_select`` per
axis, which works for every dtype (uint8 included) on CPU and CUDA, unlike
``F.pad(mode="reflect")``. The result stays on the input's device.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["reflect_101", "clamp_pad", "reflect_index"]


def clamp_pad(pad: int, dim: int) -> int:
    """Clamp a one-side pad to ``dim - 1`` (reference ``Utils.hpp:217-220``)."""
    return max(0, min(int(pad), int(dim) - 1))


def reflect_index(dim: int, before: int, after: int,
                  device: torch.device | str = "cpu") -> torch.Tensor:
    """Source indices of a reflect-101 pad of ``(before, after)`` along an
    axis of length ``dim``; both pads must already be ``<= dim - 1``."""
    i = torch.arange(-before, dim + after, device=device)
    i = i.abs()
    return torch.where(i > dim - 1, 2 * (dim - 1) - i, i)


def reflect_101(
    x: torch.Tensor,
    pads: Sequence[tuple[int, int]],
    axes: Sequence[int] | None = None,
) -> torch.Tensor:
    """Pad ``x`` with reflect-101 borders, clamped per side to ``dim - 1``.

    ``pads[k] = (before, after)`` applies to ``axes[k]`` (defaults to the
    last ``len(pads)`` axes). Requests exceeding the clamp are completed
    with zeros so the output shape always honors the request.
    """
    if axes is None:
        axes = range(x.ndim - len(pads), x.ndim)
    axes = [a % x.ndim for a in axes]
    if len(axes) != len(pads):
        raise ValueError("pads and axes length mismatch")
    out = x
    for axis, (before, after) in zip(axes, pads):
        dim = out.shape[axis]
        rb, ra = clamp_pad(before, dim), clamp_pad(after, dim)
        out = out.index_select(axis, reflect_index(dim, rb, ra, out.device))
        zb, za = before - rb, after - ra
        if zb or za:
            shape = list(out.shape)
            shape[axis] = zb
            lo = out.new_zeros(shape)
            shape[axis] = za
            hi = out.new_zeros(shape)
            out = torch.cat([lo, out, hi], dim=axis)
    return out
