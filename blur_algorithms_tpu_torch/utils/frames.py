"""Synthetic test frames (NumPy only).

A copy of ``make_frames`` from the repository's ``bench.py`` (same seed,
same formula, bit for bit), so that the port's chip smoke test drives the
same 4K frames as the JAX benchmark without importing it.
"""

from __future__ import annotations

import numpy as np

__all__ = ["make_frames"]


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
