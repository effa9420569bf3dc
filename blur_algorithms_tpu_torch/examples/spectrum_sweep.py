"""The reference's spectrum-analysis sweep, on the card.

The port of the JAX package's ``examples/spectrum_sweep.py``: blur an
input at a sweep of sigmas (one ``blur_multi_sigma_u8`` call, a shared
forward FFT), export each log-magnitude spectrum (``SpectrumAnalyzer``),
and write a collage strip; ``--noises`` adds the reference's noisy sweep.

Usage: python -m blur_algorithms_tpu_torch.examples.spectrum_sweep <image>
       [--sigmas 0.5 5 20 80] [--noises 0 25 100]
       [--out spectrum_collage.ppm] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("image")
    p.add_argument("--sigmas", nargs="+", type=float, default=[0.5, 5, 20, 80])
    p.add_argument("--noises", nargs="+", type=float, default=[],
                   help="additive Gaussian noise stddevs (the reference's "
                        "'noisy' sweep, radius fixed at --sigmas[0])")
    p.add_argument("--out", default="spectrum_collage.ppm")
    p.add_argument("--max-dim", type=int, default=512,
                   help="downscale long side to keep the collage small")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from blur_algorithms_tpu_torch import blur_multi_sigma_u8, blur_u8
    from blur_algorithms_tpu_torch.models.pipeline import SpectrumAnalyzer
    from blur_algorithms_tpu_torch.utils import io

    analyzer = SpectrumAnalyzer(device=args.device)
    device = analyzer.device
    img = io.read_image(args.image)
    h, w = img.shape[:2]
    scale = max(h, w) / args.max_dim
    if scale > 1:
        ys = np.linspace(0, h - 1, int(h / scale)).astype(int)
        xs = np.linspace(0, w - 1, int(w / scale)).astype(int)
        img = np.ascontiguousarray(img[ys][:, xs])
    rows = []

    def strip(frame: np.ndarray, label: str) -> None:
        spec_vis = analyzer.to_image(analyzer(frame))
        sh, sw = spec_vis.shape[:2]
        ih, iw = frame.shape[:2]
        spec_crop = spec_vis[:ih, :iw] if (sh >= ih and sw >= iw) else np.zeros_like(frame)
        rows.append(np.concatenate([frame, spec_crop], axis=1))
        print(f"{label}: spatial std {frame.std():.1f}, spectrum mean {spec_vis.mean():.1f}")

    x = torch.from_numpy(img).to(device)
    sweep = blur_multi_sigma_u8(x, [max(s, 0.1) for s in args.sigmas]).cpu().numpy()
    for sigma, frame in zip(args.sigmas, sweep):
        strip(frame, f"sigma={sigma}")

    noise_rng = np.random.default_rng(0)
    base = max(args.sigmas[0], 0.1) if args.sigmas else 0.1
    for noise in args.noises:
        noisy = np.clip(img.astype(np.float32) + noise_rng.normal(0, noise, img.shape),
                        0, 255).astype(np.uint8)
        out = blur_u8(torch.from_numpy(noisy).to(device), base).cpu().numpy()
        strip(out, f"noise={noise}")

    collage = np.concatenate(rows, axis=0)
    io.write_image(args.out, collage)
    print(f"wrote {args.out} ({collage.shape[1]}x{collage.shape[0]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
