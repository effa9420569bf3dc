"""Unsharp-mask demo: the blur as a building block of photographic clean-up.

The port of the JAX package's ``examples/sharpen.py``:

    out = x + amount * (x - gaussian_blur(x))        (unsharp masking)

beside the signed high-pass residual, shown around mid-gray, both on K2
(``models/filters.py``).

Usage: python -m blur_algorithms_tpu_torch.examples.sharpen <image>
       [--sigma 2.0] [--amount 1.2] [--out sharpen_demo.ppm] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("image")
    p.add_argument("--sigma", type=float, default=2.0)
    p.add_argument("--amount", type=float, default=1.2)
    p.add_argument("--threshold", type=int, default=0)
    p.add_argument("--out", default="sharpen_demo.ppm")
    p.add_argument("--max-dim", type=int, default=900)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from blur_algorithms_tpu_torch.models import high_pass, unsharp_mask
    from blur_algorithms_tpu_torch.utils import io
    from blur_algorithms_tpu_torch.utils.hw import entry_device

    device = entry_device(args.device)
    img = io.read_image(args.image)
    step = int(np.ceil(max(img.shape[:2]) / args.max_dim))
    if step > 1:
        img = np.ascontiguousarray(img[::step, ::step])

    x = torch.from_numpy(img).to(device)
    sharp = unsharp_mask(x, args.sigma, args.amount, threshold=args.threshold).cpu().numpy()
    hp = high_pass(x, args.sigma).cpu().numpy()  # (C, H, W) float, signed
    hp_vis = np.clip(np.moveaxis(hp, 0, -1) * 2.0 + 128.0, 0, 255).astype(np.uint8)

    io.write_image(args.out, np.concatenate([img, sharp, hp_vis], axis=1))
    print(
        f"wrote {args.out}: original | unsharp(sigma={args.sigma}, "
        f"amount={args.amount}) | high-pass residual (x2, around mid-gray)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
