"""Multi-card demo: a dp x sp mesh, halo exchange, the distributed FFT.

The port of the JAX package's ``examples/multichip.py``, over the port's
``parallel`` package: the fused kernels per shard with reflect-aware halo
exchange (``blur_sharded_u8``), the distributed FFT with one all-to-all
between its two 1-D passes (``blur_fft_sharded_u8``), and AUTO, which
shards a batch itself where more than one card is visible. With one card
(or ``--device cpu``) the mesh repeats that device eight times, as the
JAX example falls back to eight virtual CPU devices.

Usage: python -m blur_algorithms_tpu_torch.examples.multichip [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from blur_algorithms_tpu_torch import blur_u8, make_plan, oracle
    from blur_algorithms_tpu_torch.parallel import (
        blur_fft_sharded_u8,
        blur_sharded_u8,
        make_mesh,
    )
    from blur_algorithms_tpu_torch.parallel.mesh import visible_devices
    from blur_algorithms_tpu_torch.utils.hw import entry_device

    device = entry_device(args.device)
    devices = visible_devices(device)
    if len(devices) < 2:
        devices = [devices[0]] * 8  # one device repeated: virtual shards
    n = len(devices)
    print(f"devices: {n} x {devices[0]}")
    sp = 2 if n % 2 == 0 else 1
    mesh = make_mesh(dp=n // sp, sp=sp, devices=devices)
    print(f"mesh: dp={n // sp} x sp={sp}")

    rng = np.random.default_rng(0)
    h, w, sigma = 256, 384, 8.0
    batch = (rng.random((2 * (n // sp), h, w, 3)) * 255).astype(np.uint8)
    plan = make_plan((h, w), sigma)
    want = oracle.blur_u8(batch[0], sigma)
    x = torch.from_numpy(batch).to(devices[0])

    for name, fn in [
        ("fused + halo exchange", blur_sharded_u8),
        ("distributed FFT (all_to_all)", blur_fft_sharded_u8),
    ]:
        out = fn(x, plan, mesh).cpu().numpy()
        d = np.abs(out[0].astype(int) - want.astype(int)).max()
        print(f"{name:32s} max |err| vs oracle: {d}")

    out = blur_u8(x[: len(visible_devices(device))], sigma).cpu().numpy()
    d = np.abs(out[0].astype(int) - want.astype(int)).max()
    print(f"{'AUTO blur_u8':32s} max |err| vs oracle: {d}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
