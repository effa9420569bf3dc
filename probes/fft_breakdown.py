"""Probe of the FFT_MXU path on the card: where a call's time goes.

Runs the slice-3 calls of ``chip_smoke.py`` phase 9 at its shape (batch 4
RGB 2160x3840, ``utils/frames.make_frames``): ``blur_u8`` at sigma 250,
``blur`` forward at sigma 400, and ``blur`` forward + backward at sigma
400. Each call is timed with CUDA events (median of 10 after warm-up),
then traced with ``torch.profiler`` over 5 calls: device time per call of
every kernel name (K3/K3f, the copies, pads and casts around them), and
the busy share (summed kernel time over the call's event time). Run from
the repository root on a machine with one CUDA card:

    python3 probes/fft_breakdown.py
"""

from __future__ import annotations

import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from blur_algorithms_tpu_torch import blur, blur_u8  # noqa: E402
from blur_algorithms_tpu_torch.utils import build  # noqa: E402
from blur_algorithms_tpu_torch.utils.frames import make_frames  # noqa: E402

BATCH, H, W = 4, 2160, 3840
TRACED = 5


def _event_ms(fn, iters: int = 10) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _breakdown(name: str, fn) -> None:
    ms = _event_ms(fn)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACED):
            fn()
        torch.cuda.synchronize()
    # device-side events only (kernels, copies); the CPU-side ops repeat
    # their kernels' time, and the profiler's own buffer requests are none
    kernels = [(e.key, _device_us(e) / 1e3 / TRACED, e.count / TRACED)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and _device_us(e) > 0
               and "Activity Buffer" not in e.key]
    busy = sum(r[1] for r in kernels)
    print(f"{name}: {ms:.4f} ms per call (CUDA events, median of 10); kernels "
          f"{busy:.4f} ms per call, busy share {busy / ms:.3f}", flush=True)
    for key, dev_ms, count in sorted(kernels, key=lambda r: -r[1])[:12]:
        print(f"  {dev_ms:9.4f} ms  x{count:g}  {key[:110]}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("fft_breakdown.py needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    build.load_library()
    frames = make_frames(BATCH, H, W)
    x_u8 = torch.from_numpy(np.ascontiguousarray(np.moveaxis(frames, 1, -1))).cuda()
    x = torch.from_numpy(frames.astype(np.float32)).cuda()
    gt = torch.ones_like(x)

    def fwd_bwd():
        t = x.detach().requires_grad_()
        blur(t, 400.0).backward(gt)
        return t.grad

    _breakdown("blur_u8 sigma 250 (uint8, AUTO -> FFT_MXU)", lambda: blur_u8(x_u8, 250.0))
    _breakdown("blur forward sigma 400 (f32, AUTO -> FFT_MXU)", lambda: blur(x, 400.0))
    _breakdown("blur forward + backward sigma 400", fwd_bwd)
    return 0


if __name__ == "__main__":
    sys.exit(main())
