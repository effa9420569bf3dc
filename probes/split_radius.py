"""Probe of the split radius on the card: the two-pass split against the
single fused kernels at small support radii, repeated.

``chip_smoke.py`` phase 13 sets ``utils/hw._MEASURED_SPLIT_MIN`` from one
sweep in turns at r 32..332; this probe repeats the comparison where it is
closest, three rounds in turns (single, split, split, single; the mean of
two medians of 20 CUDA-event timings each) at sigma 3, 5, 7.5, 10 and 15
(r 9, 15, 24, 32 and 49) on 4 RGB frames of 2160x3840
(``utils/frames.make_frames``): uint8, K1 on the rung and in the form AUTO
routes against the int8 split (``_blur_fused_split(..., "int8", True)``),
and float, K2 against the f32 split. Run from the repository root on a
machine with one CUDA card:

    python3 probes/split_radius.py
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from blur_algorithms_tpu_torch import make_plan  # noqa: E402
from blur_algorithms_tpu_torch.api import _u8_dma_precision  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fused_blur, fused_dma  # noqa: E402
from blur_algorithms_tpu_torch.utils import build, timing  # noqa: E402
from blur_algorithms_tpu_torch.utils.frames import make_frames  # noqa: E402
from blur_algorithms_tpu_torch.utils.hw import device_spec  # noqa: E402

SIGMAS = (3.0, 5.0, 7.5, 10.0, 15.0)
ROUNDS = 3
ITERS = 20


def _in_turns(label, fns, x):
    t = {k: [] for k in fns}
    for k in (*fns, *reversed(fns)):
        t[k].append(timing.time_cuda(fns[k], x, iters=ITERS, name=f"{label} {k}").median_ms)
    return {k: float(np.mean(v)) for k, v in t.items()}


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("split_radius.py needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    build.load_library()
    frames = make_frames(4, 2160, 3840)
    x_u8 = torch.from_numpy(frames).cuda()
    x_f32 = torch.from_numpy(frames.astype(np.float32)).cuda()
    spec = device_spec(x_u8.device)
    rows = []
    for sigma in SIGMAS:
        plan = make_plan((2160, 3840), sigma)
        r = plan.row.support_radius
        rung = _u8_dma_precision(plan, spec)
        line = {"r": r, "sigma": sigma, "rung": rung, "rounds": []}
        for k in range(ROUNDS):
            u8 = _in_turns(f"uint8 r={r} round {k}", {
                "single": lambda t: fused_dma.blur_fused_u8_dma(t, plan, precision=rung),
                "split": lambda t: fused_blur._blur_fused_split(t, plan, "int8", True)}, x_u8)
            f32 = _in_turns(f"f32 r={r} round {k}", {
                "single": lambda t: fused_blur.blur_fused_f32(t, plan),
                "split": lambda t: fused_blur._blur_fused_split(t, plan, "bf16x3", False)},
                x_f32)
            line["rounds"].append({"u8": u8, "f32": f32})
            print(f"split_radius r={r} round {k}: uint8 K1 ({rung}) {u8['single']:.4f} vs "
                  f"split {u8['split']:.4f} ms; f32 K2 {f32['single']:.4f} vs split "
                  f"{f32['split']:.4f} ms", flush=True)
        rows.append(line)
    print(json.dumps({"split_radius": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
