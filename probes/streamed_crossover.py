"""Probe of AUTO's streamed crossover on the card: the fused engine against
strip-streamed FFT_MXU on giant frames, in turns.

Where FFT_MXU's whole-frame intermediates exceed the card's byte budget it
strip-streams (``ops/streamed``), and AUTO compares the support radius with
``DeviceSpec.auto_fused_max_radius_*_streamed`` instead of the whole-frame
crossover (the JAX rule, which reads it only past the whole-frame one).
This probe measures those two values for
``utils/hw._MEASURED_STREAMED_CROSSOVERS``:

- uint8: ``blur_u8`` on 4 RGB 24000x14500 frames (``utils/frames.make_frames_on``),
  ``engine="fused"`` (K1 to support radius 600, the two-pass split past
  it) against ``engine="fft_mxu"`` at support radius 332 to 1920 (the
  card's whole-frame uint8 crossover), where this batch streams at every
  radius;
- float: ``blur`` on 4 RGB frames as float32 planes at r 119 (the card's
  whole-frame float crossover) to 598 (past it the split's peak memory on
  this batch passes the card's budget, and AUTO takes the FFT anyway), and
  on 2 frames at r 997 (where 2 frames start to stream).

Each point in turns (fused, FFT, FFT, fused), each the median of 3
CUDA-event timings after a warm-up call, the mean of the two medians; a
point's FFT side must stream (checked with ``api._fft_mxu_streams``) and
its fused side must serve the frame (``api._fused_refusal``). The crossover
of an input type is the largest swept radius up to which the fused engine
is at least as fast at every swept radius, in radius order over its
batches; AUTO reads it wherever FFT_MXU streams, above or below the
whole-frame crossover. Where the fused engine loses at the smallest swept
radius there is no entry (null): sweep lower. Prints a
JSON line a point, then the entry to paste. Run from the repository root on
a machine with one CUDA card:

    python3 probes/streamed_crossover.py [--out streamed_crossover.json]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from blur_algorithms_tpu_torch import blur, blur_u8, make_plan  # noqa: E402
from blur_algorithms_tpu_torch.api import _fft_mxu_streams, _fused_refusal  # noqa: E402
from blur_algorithms_tpu_torch.utils import build, timing  # noqa: E402
from blur_algorithms_tpu_torch.utils.frames import make_frames_on  # noqa: E402
from blur_algorithms_tpu_torch.utils.hw import device_spec  # noqa: E402

H, W = 24000, 14500
# sigma -> support radius on 24000x14500: 36 -> 119, 50 -> 165, 70 -> 232,
# 85 -> 282, 100 -> 332, 140 -> 465, 180 -> 598, 250 -> 831, 300 -> 997,
# 330 -> 1097, 380 -> 1264, 420 -> 1397, 460 -> 1530, 500 -> 1663,
# 540 -> 1796, 577 -> 1920
SWEEPS = (("u8", 4, (100.0, 180.0, 250.0, 330.0, 380.0, 420.0, 460.0, 500.0, 540.0,
                     577.0)),
          ("f32", 4, (36.0, 50.0, 70.0, 85.0, 100.0, 140.0, 180.0)),
          ("f32", 2, (300.0,)))
ITERS = 3


def _in_turns(label: str, fns: dict) -> dict:
    t = {k: [] for k in fns}
    for k in (*fns, *reversed(fns)):
        t[k].append(timing.time_cuda(fns[k], iters=ITERS, warmup=1,
                                     name=f"{label} {k}").median_ms)
    return {k: float(np.mean(v)) for k, v in t.items()}


def sweep(kind: str, batch: int, sigmas, device) -> list[dict]:
    """One batch's points: the fused engine against streamed FFT_MXU."""
    spec = device_spec(device)
    planar = make_frames_on(device, batch, H, W)
    if kind == "u8":
        x, fn, in_bytes = planar.movedim(1, -1).contiguous(), blur_u8, 1
    else:
        x, fn, in_bytes = planar.float(), blur, 4
    del planar
    lead = batch * 3
    points = []
    for sigma in sigmas:
        plan = make_plan((H, W), sigma)
        r = max(plan.row.support_radius, plan.col.support_radius)
        if not _fft_mxu_streams(plan, lead, spec):
            raise RuntimeError(f"{kind} x {batch} at sigma {sigma} (r {r}) does not stream")
        if (refusal := _fused_refusal(plan, in_bytes, spec, lead)) is not None:
            raise RuntimeError(f"{kind} x {batch} at sigma {sigma}: {refusal}")
        ms = _in_turns(f"{kind} x {batch} r={r}", {
            "fused": lambda s=sigma: fn(x, s, "fused"),
            "fft_mxu_streamed": lambda s=sigma: fn(x, s, "fft_mxu"),
        })
        torch.cuda.empty_cache()
        line = {"kind": kind, "frames": batch, "sigma": sigma, "r": r,
                "fused_ms": ms["fused"], "fft_mxu_streamed_ms": ms["fft_mxu_streamed"]}
        points.append(line)
        print(json.dumps(line), flush=True)
    del x
    torch.cuda.empty_cache()
    return points


def crossover(points: list[dict]) -> int | None:
    """The largest swept radius up to which the fused engine is at least as
    fast at every swept radius; None where it loses at the smallest."""
    best = None
    for p in sorted(points, key=lambda p: p["r"]):
        if p["fused_ms"] > p["fft_mxu_streamed_ms"]:
            break
        best = p["r"]
    return best


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the sweep as JSON here too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("streamed_crossover.py needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    build.load_library()
    device = torch.device("cuda")
    spec = device_spec(device)
    res = {"u8": [], "f32": []}
    for kind, batch, sigmas in SWEEPS:
        res[kind] += sweep(kind, batch, sigmas, device)
    entry = (crossover(res["u8"]), crossover(res["f32"]))
    out = {"card": smi, "points": res, "entry": {torch.cuda.get_device_name(0): entry},
           "whole_frame_crossovers": (spec.auto_fused_max_radius_u8,
                                      spec.auto_fused_max_radius_f32)}
    print("streamed crossovers (uint8, float) for utils/hw._MEASURED_STREAMED_CROSSOVERS: "
          + json.dumps(out["entry"]), flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
