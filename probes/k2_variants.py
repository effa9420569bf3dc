"""Probe of K2 (``csrc/fused_blur.cu``) on the card: variants and a radius sweep.

Builds patched copies of the K2 source (other tile shapes, fewer staging
loads in flight, no interior-tile fast path, wider register windows, and
two ablations that run one tap where a pass has many), each into its own library under ``build/probe/``, and times them
with CUDA events at the slice's main shape: 12 f32 planes of 2160x3840
(``utils/frames.make_frames`` as float), sigma 10. The variants run in
turns, forward then backward through the list, median of 20 calls each.
Outputs of the non-ablation variants must equal the shipped kernel's.
Then the shipped kernel is timed across radii at the same shape. Run from
the repository root on a machine with one CUDA card:

    python3 probes/k2_variants.py [--no-sweep]
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from blur_algorithms_tpu_torch import make_plan  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fused_blur  # noqa: E402
from blur_algorithms_tpu_torch.utils import build, timing  # noqa: E402
from blur_algorithms_tpu_torch.utils.frames import make_frames  # noqa: E402

SRC = build._CSRC / "fused_blur.cu"

# name -> [(text in the shipped source, replacement), ...]
VARIANTS = {
    "shipped": [],
    "reflect_everywhere": [("const bool interior = i0", "const bool interior = false && i0")],
    "batch4": [("constexpr int kBatch = 8;", "constexpr int kBatch = 4;")],
    "th256": [("int target = rh <= 100 ? 128", "int target = rh <= 100 ? 256")],
    "th64": [("int target = rh <= 100 ? 128", "int target = rh <= 100 ? 64")],
    "g16": [("  geo.g = 32;\n", "  geo.g = 16;\n")],
    "tw32": [("geo.tw = rw <= 100 ? 64 : 32;", "geo.tw = 32;")],
    "rows_window4": [("constexpr int kR = 8;", "constexpr int kR = 4;"),
                     ("g == 16 ? 18 : 9", "g == 16 ? 20 : 10")],
    "cols_window8": [("constexpr int kRC = 16;", "constexpr int kRC = 8;")],
    # ablations: the output is wrong by design, only the time counts
    "no_rows_taps": [(
        "correlate<kR>(s_x + c0 * s_stride + rr, s_stride, s_wr, nwr, acc);",
        "correlate<kR>(s_x + c0 * s_stride + rr, s_stride, s_wr, 1, acc);")],
    "no_cols_taps": [(
        "correlate<kRC>(s_y + ii * ys + j, ys, s_wc, nwc, acc);",
        "correlate<kRC>(s_y + ii * ys + j, ys, s_wc, 1, acc);")],
}
ABLATIONS = ("no_rows_taps", "no_cols_taps")
ITERS = 20


def _build(name: str, text: str, out_dir: pathlib.Path):
    """The variant beside the other sources, as the package builds them."""
    src = out_dir / f"k2_{name}.cu"
    src.write_text(text)
    lib = out_dir / f"k2_{name}.so"
    others = [str(p) for p in sorted(build._CSRC.glob("*.cu")) if p != SRC]
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib), str(src),
           *others]
    return lib, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)


def _launcher(lib, x, plan):
    taps_row, taps_col = fused_blur._device_taps(plan, x.device)
    out = torch.empty_like(x)
    n, h, w = x.shape
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        rc = lib.blur_fused_f32(x.data_ptr(), out.data_ptr(), taps_row.data_ptr(),
                                taps_col.data_ptr(), 0, 0, n, h, w,
                                plan.col.support_radius, plan.row.support_radius,
                                stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return out

    return run


def _median_ms(run, iters: int = ITERS) -> float:
    return timing.time_cuda(run, iters=iters).median_ms


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("the probe needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    out_dir = build.build_dir() / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    shipped = SRC.read_text()
    jobs = {}
    for name, patches in VARIANTS.items():
        text = shipped
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"variant {name}: patch anchor not found")
            text = text.replace(old, new)
        jobs[name] = _build(name, text, out_dir)
    libs = {}
    for name, (path, cmd, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}: {' '.join(cmd)}\n{err}")
        regs = [ln.split("info    :")[-1].strip() for ln in err.splitlines()
                if "registers" in ln]
        print(f"built {name}: {' | '.join(regs)}", flush=True)
        libs[name] = build._declare(ctypes.CDLL(str(path)))

    frames = make_frames(4, 2160, 3840)
    x = torch.from_numpy(frames.astype(np.float32)).cuda().reshape(12, 2160, 3840)
    plan = make_plan((2160, 3840), 10.0)
    runs = {name: _launcher(lib, x, plan) for name, lib in libs.items()}
    want = runs["shipped"]().clone()
    for name, run in runs.items():
        got = run()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        print(f"{name}: max_abs_err vs shipped {err:.3e}", flush=True)
        if name not in ABLATIONS and err != 0.0:
            raise RuntimeError(f"variant {name} differs from the shipped kernel")
    times = {name: [] for name in runs}
    order = list(runs)
    for turn in (order, order[::-1]):
        for name in turn:
            times[name].append(_median_ms(runs[name]))
    for name in order:
        print(f"variant {name}: " + ", ".join(f"{t:.4f}" for t in times[name])
              + " ms (two turns, median of 20 each)", flush=True)

    if "--no-sweep" in sys.argv:
        return 0
    run_shipped = libs["shipped"]
    for sigma in (1.0, 3.0, 10.0, 25.0, 50.0, 100.0, 150.0, 180.0):
        p = make_plan((2160, 3840), sigma)
        iters = ITERS if sigma <= 50 else 5
        ms = _median_ms(_launcher(run_shipped, x, p), iters)
        print(f"sweep sigma={sigma} r={p.col.support_radius}: {ms:.4f} ms "
              f"(median of {iters})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
