"""Chip smoke test of the PyTorch + CUDA port (blur_algorithms_tpu_torch).

Drives the port's main path on one CUDA card and fails loudly on any fault:

1. prints the card (``nvidia-smi`` name and power limit), then builds the
   CUDA kernels from ``blur_algorithms_tpu_torch/csrc`` and prints the time;
2. kernel vs plain version: K1 (the fused int8 blur) against its plain
   PyTorch version on the card, uint8 RGB 1080x1920 frames at
   sigma 1, 3, 10, 50, 150 and 180 (support radius up to 598), an
   anisotropic sigma (5, 11) and a ragged 1001x1777 frame; each must be
   ``torch.equal``;
3. main path: ``blur_u8`` AUTO on a (4, 2160, 3840, 3) uint8 CUDA tensor at
   sigma 10 (``bench.py``'s configuration and frames); K1's launch count
   must rise, the result must equal the plain version bit for bit and
   frame 0 must be within 1 count of the NumPy oracle;
4. times from CUDA events (median of 20 after warm-up): K1 alone, the plain
   version, and the whole ``blur_u8`` with its layout copies.

The line before the last is a JSON object describing each kernel; the last
is ``{"ok": true, "device": {...}}``. Run from the repository root:

    python3 chip_smoke.py

It exits non-zero, printing no result, where no CUDA device is available.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SIGMA = 10.0
BATCH, H, W = 4, 2160, 3840
ITERS = 20


def _case_frames(h: int, w: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    planes = rng.integers(0, 256, size=(3, h, w), dtype=np.uint8)
    return torch.from_numpy(planes).cuda()


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")

    import bench
    from blur_algorithms_tpu_torch import blur_u8, make_plan, oracle
    from blur_algorithms_tpu_torch.cuda_kernels import fused_dma
    from blur_algorithms_tpu_torch.utils import build, timing

    # ---- phase 1: the card, then the kernel build ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    build.load_library()
    ptxas = [ln.strip() for ln in build.last_build["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"phase 1 build: {build.last_build['library']} "
          f"(built now: {build.last_build['built']}) in "
          f"{time.perf_counter() - t0:.2f} s; ptxas: {' | '.join(ptxas)}",
          flush=True)

    # ---- phase 2: K1 against its plain version on the card ----
    cases = [((1080, 1920), s) for s in (1.0, 3.0, 10.0, 50.0, 150.0, 180.0)]
    cases += [((1080, 1920), (5.0, 11.0)), ((1001, 1777), SIGMA)]
    max_err = 0
    for k, ((h, w), sigma) in enumerate(cases):
        plan = make_plan((h, w), sigma)
        x = _case_frames(h, w, seed=k)
        got = fused_dma.blur_fused_u8_dma(x, plan)
        want = fused_dma.blur_fused_u8_dma_ref(x, plan)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        max_err = max(max_err, err)
        equal = torch.equal(got, want)
        print(f"phase 2 K1 vs plain: {h}x{w} RGB sigma={sigma} "
              f"r=({plan.col.support_radius}, {plan.row.support_radius}) "
              f"equal={equal} max_abs_err={err}", flush=True)
        if not equal:
            raise RuntimeError(f"K1 disagrees with its plain version at {(h, w, sigma)}")

    # ---- phase 3: the main path at bench.py's size ----
    frames = bench.make_frames(BATCH, H, W)  # (B, C, H, W) uint8
    img = np.ascontiguousarray(np.moveaxis(frames, 1, -1))
    x = torch.from_numpy(img).cuda()
    plan = make_plan((H, W), SIGMA)
    torch.cuda.synchronize()
    fused_dma.blur_fused_u8_dma.launches = 0
    out = blur_u8(x, SIGMA)
    torch.cuda.synchronize()
    launches = fused_dma.blur_fused_u8_dma.launches
    if launches < 1:
        raise RuntimeError("blur_u8 did not launch K1")
    if out.shape != x.shape or out.dtype != torch.uint8 or out.device != x.device:
        raise RuntimeError(f"blur_u8 returned {out.shape} {out.dtype} {out.device}")
    planar = x.movedim(-1, -3).contiguous()
    ref = fused_dma.blur_fused_u8_dma_ref(planar, plan).movedim(-3, -1)
    torch.cuda.synchronize()
    err = int((out.int() - ref.int()).abs().max())
    max_err = max(max_err, err)
    if not torch.equal(out, ref):
        raise RuntimeError(f"blur_u8 differs from the plain version by {err}")
    want0 = oracle.blur_u8(img[0], SIGMA)
    d = np.abs(out[0].cpu().numpy().astype(int) - want0.astype(int))
    print(f"phase 3 main path: blur_u8 AUTO {tuple(x.shape)} sigma={SIGMA}: "
          f"K1 launches={launches}, equal to plain version=True, "
          f"frame 0 vs oracle max={int(d.max())} exact={float((d == 0).mean())}",
          flush=True)
    if d.max() > 1:
        raise RuntimeError(f"frame 0 is {int(d.max())} counts from the oracle")

    # ---- phase 4: times ----
    mp = BATCH * H * W / 1e6
    k1 = timing.time_cuda(fused_dma.blur_fused_u8_dma, planar, plan,
                          iters=ITERS, name="K1 fused_dma int8", megapixels=mp)
    plain = timing.time_cuda(fused_dma.blur_fused_u8_dma_ref, planar, plan,
                             iters=ITERS, name="plain version", megapixels=mp)
    whole = timing.time_cuda(blur_u8, x, SIGMA, iters=ITERS,
                             name="blur_u8 (with layout copies)", megapixels=mp)
    for res in (k1, plain, whole):
        print(f"phase 4 time: {res}", flush=True)

    print(json.dumps({"kernels": [{
        "name": "fused_dma_int8",
        "route": "cuda",
        "source": "blur_algorithms_tpu_torch/csrc/fused_dma.cu",
        "replaces": "blur_algorithms_tpu/pallas_kernels/fused_dma.py:1023",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k1.median_ms,
        "plain_ms": plain.median_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
