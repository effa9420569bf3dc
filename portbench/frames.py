"""The benchmark's input frames, made on the device from a seed.

A frozen copy of the formula of ``blur_algorithms_tpu_torch/utils/frames.py``
(``make_frames_on``: sinusoids plus Gaussian noise, a per-frame phase, the
second and third channels rolled copies of the first), written straight into
the interleaved ``(B, H, W, C)`` uint8 layout that ``blur_u8`` takes
(``make_frames``), or, not rounded, into the float32 planes ``(B, C, H, W)``
that ``blur`` takes (``make_planes``). A later change to the port cannot move
it. ``make_cotangent`` draws the cotangents of a backward from a seed.
"""

from __future__ import annotations

import torch

__all__ = ["frame_seed", "make_cotangent", "make_frames", "make_planes"]

_MASK63 = (1 << 63) - 1


def frame_seed(seed: int, index: int) -> int:
    """The generator seed of pool tensor ``index`` of run ``seed``: distinct
    for every pair, and inside the 63 bits ``torch.Generator`` takes."""
    return (int(seed) * 1_000_003 + 7919 * (int(index) + 1)) & _MASK63


def make_frames(device: torch.device | str, batch: int, h: int, w: int, channels: int,
                seed: int) -> torch.Tensor:
    """``batch`` RGB frames ``(batch, h, w, channels)`` uint8 on ``device``."""
    if channels != 3:
        raise ValueError(f"the frame formula makes 3 channels, not {channels}")
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    out = torch.empty((batch, h, w, channels), dtype=torch.uint8, device=device)
    for b in range(batch):
        base = torch.randn((h, w), generator=g, device=device).mul_(18)
        base += 127 + 70 * torch.sin(xx / (11.0 + b) + b) + 50 * torch.cos(yy / (17.0 + 2 * b))
        base.clamp_(0, 255)
        out[b, :, :, 0] = base.to(torch.uint8)
        out[b, :, :, 1] = torch.roll(base, 31, 0).to(torch.uint8)
        out[b, :, :, 2] = torch.roll(base, 17, 1).to(torch.uint8)
        del base
    return out


def make_planes(device: torch.device | str, batch: int, h: int, w: int, channels: int,
                seed: int) -> torch.Tensor:
    """``batch`` RGB frames as float32 planes ``(batch, channels, h, w)`` on
    ``device``: ``make_frames``' formula and values before its rounding to
    uint8 (0..255)."""
    if channels != 3:
        raise ValueError(f"the frame formula makes 3 channels, not {channels}")
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    out = torch.empty((batch, channels, h, w), dtype=torch.float32, device=device)
    for b in range(batch):
        base = torch.randn((h, w), generator=g, device=device).mul_(18)
        base += 127 + 70 * torch.sin(xx / (11.0 + b) + b) + 50 * torch.cos(yy / (17.0 + 2 * b))
        base.clamp_(0, 255)
        out[b, 0] = base
        out[b, 1] = torch.roll(base, 31, 0)
        out[b, 2] = torch.roll(base, 17, 1)
        del base
    return out


def make_cotangent(device: torch.device | str, shape: tuple, seed: int) -> torch.Tensor:
    """A float32 cotangent of ``shape`` on ``device``, standard normal."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randn(shape, generator=g, device=device)
