"""Synthetic test frames.

``make_frames`` is a copy of the repository's ``bench.py`` generator (NumPy,
same seed, same formula, bit for bit), so that the port's chip smoke test
drives the same 4K frames as the JAX benchmark without importing it.
``make_frames_on`` makes frames of the same formula on a device with
torch's generator (other noise values than NumPy's): giant frames (24000 x
14500, the JAX benchmarks' largest) in a fraction of a second where the host
would take tens of seconds.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["make_frames", "make_frames_on"]


def make_frames(batch: int, h: int, w: int) -> np.ndarray:
    """Structured synthetic RGB frames (sinusoids + noise, per-frame phase),
    ``(B, C, H, W)`` planar uint8."""
    rng = np.random.default_rng(42)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = []
    for b in range(batch):
        base = (
            127
            + 70 * np.sin(xx / (11.0 + b) + b)
            + 50 * np.cos(yy / (17.0 + 2 * b))
            + rng.normal(0, 18, (h, w)).astype(np.float32)
        )
        img = np.stack(
            [base, np.roll(base, 31, axis=0), np.roll(base, 17, axis=1)], axis=0
        )
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return np.stack(frames)


def make_frames_on(device: torch.device | str, batch: int, h: int, w: int,
                   seed: int = 42) -> torch.Tensor:
    """``make_frames``'s formula on ``device``: ``(B, C, H, W)`` planar
    uint8, the noise from a torch generator seeded with ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    out = torch.empty((batch, 3, h, w), dtype=torch.uint8, device=device)
    for b in range(batch):
        base = torch.randn((h, w), generator=g, device=device).mul_(18)
        base += 127 + 70 * torch.sin(xx / (11.0 + b) + b) + 50 * torch.cos(yy / (17.0 + 2 * b))
        base.clamp_(0, 255)
        out[b, 0] = base.to(torch.uint8)
        out[b, 1] = torch.roll(base, 31, 0).to(torch.uint8)
        out[b, 2] = torch.roll(base, 17, 1).to(torch.uint8)
        del base
    return out
