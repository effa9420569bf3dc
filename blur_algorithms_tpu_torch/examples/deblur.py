"""Gradient-based deconvolution — the blur as a differentiable operator.

The port of the JAX package's ``examples/deblur.py``. The blur is K2
(``cuda_kernels/fused_blur.blur_fused``), a ``torch.autograd.Function``
whose backward pass is the blur's adjoint, so ``torch.autograd`` takes the
place of ``jax.value_and_grad``: gradient descent on
``0.5 || blur(x) - observed ||^2 + tv * TV(x)``.

Usage: python -m blur_algorithms_tpu_torch.examples.deblur <image>
       [--sigma 3] [--steps 150] [--device cuda]
       python -m blur_algorithms_tpu_torch.examples.deblur <image> --wiener
       [--balance 1e-3]

``--wiener`` runs the closed-form solve instead (``models.wiener_deconvolve``).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("image")
    p.add_argument("--sigma", type=float, default=3.0)
    p.add_argument("--steps", type=int, default=150)
    p.add_argument("--lr", type=float, default=1.8)
    p.add_argument("--tv", type=float, default=1e-3)
    p.add_argument("--out", default="deblurred.ppm")
    p.add_argument("--max-dim", type=int, default=768)
    p.add_argument("--wiener", action="store_true",
                   help="closed-form Wiener solve instead of gradient descent")
    p.add_argument("--balance", type=float, default=1e-3,
                   help="Wiener regularizer (with --wiener)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from blur_algorithms_tpu_torch.cuda_kernels.fused_blur import blur_fused
    from blur_algorithms_tpu_torch.ops.plan import make_plan
    from blur_algorithms_tpu_torch.utils import io
    from blur_algorithms_tpu_torch.utils.hw import entry_device

    device = entry_device(args.device)
    img = io.read_image(args.image)
    h, w = img.shape[:2]
    scale = max(h, w) / args.max_dim
    if scale > 1:
        ys = np.linspace(0, h - 1, int(h / scale)).astype(int)
        xs = np.linspace(0, w - 1, int(w / scale)).astype(int)
        img = img[ys][:, xs]
    planar = torch.from_numpy(np.moveaxis(img, -1, 0).astype(np.float32)).to(device)
    plan = make_plan(tuple(planar.shape[-2:]), args.sigma)

    observed = blur_fused(planar, plan)  # simulate the blurry capture

    def loss(x):
        # per-pixel 0.5*||Ax - b||^2: A's top eigenvalue is 1 (the DC gain
        # of a normalized kernel), so plain gradient steps with lr < 2 converge
        data = 0.5 * ((blur_fused(x, plan) - observed) ** 2).sum()
        tv = x.diff(dim=-1).abs().sum() + x.diff(dim=-2).abs().sum()
        return data + args.tv * tv

    if args.wiener:
        from blur_algorithms_tpu_torch.models import wiener_deconvolve

        x = wiener_deconvolve(observed, args.sigma, balance=args.balance)
    else:
        x = observed.detach().clone()
        for i in range(args.steps):
            x.requires_grad_(True)
            val = loss(x)
            (g,) = torch.autograd.grad(val, x)
            x = (x - args.lr * g).detach()
            if i % 25 == 0:
                print(f"step {i}: loss {float(val.detach()):.4f}")

    recovered = np.clip(np.floor(np.moveaxis(x.detach().cpu().numpy(), 0, -1) + 0.5), 0, 255)
    blurred = np.moveaxis(observed.cpu().numpy(), 0, -1)
    io.write_image(args.out, np.concatenate([blurred, recovered], axis=1).astype(np.uint8))
    print(f"wrote {args.out} (left: blurred observation, right: recovered)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
