"""Probe of the split's int8 cols pass on the card: the tensor-core kernel of
``csrc/fused_split.cu`` against an earlier version of the same source.

Compiles ``--earlier`` (a ``fused_split.cu``, e.g. the parent commit's,
unpacked with ``git archive`` or ``git show`` into ``build/``) into its own
library under ``build/probe/``, loads the package's library, and times
``fused_split_cols_int8`` (uint8 out) of each, in turns (earlier, current,
current, earlier; the mean of two medians of 20 CUDA-event timings), at the pass's main shapes: 12 planes of
2160x3840 (``utils/frames.make_frames``) at column radius 49, 165 and 831, 3
planes of 1080x1920 at r 831, and the pre-padded pass on one dp 2 x sp 2
shard at r 831 (6 planes of 1080 rows and 831 halo rows each side). The two
must be ``torch.equal`` (the pass is exact), the current one to its plain
version on the HD case. Run from the repository
root on a machine with one CUDA card:

    python3 probes/cols_int8_tc.py --earlier build/parent_fused_split.cu
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from _earlier import in_turns, library  # noqa: E402

from blur_algorithms_tpu_torch import make_plan  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fused_blur  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fused_split as fs  # noqa: E402
from blur_algorithms_tpu_torch.ops.pad import reflect_101  # noqa: E402
from blur_algorithms_tpu_torch.utils import build  # noqa: E402
from blur_algorithms_tpu_torch.utils.frames import make_frames  # noqa: E402


def _print_ptxas(name: str, log: str) -> None:
    report = log.splitlines()
    for i, line in enumerate(report):
        if "split_cols_int8" in line and "Compiling entry" in line:
            print(f"ptxas {name}: {line.strip()} | " + " | ".join(
                ln.strip() for ln in report[i + 1 : i + 3]), flush=True)


def _library(src: pathlib.Path, name: str) -> ctypes.CDLL:
    """``src`` built on its own; prints what ptxas reports for the int8
    cols kernels."""
    lib, log = library(src, name)
    _print_ptxas(name, log)
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fused_split_cols_int8.argtypes = [vp, vp, vp, i, i, i, i, i, i, f, f, f, vp]
    lib.fused_split_cols_int8.restype = i
    return lib


def _cols(lib, e, plan, pre):
    """The int8 cols pass of ``lib`` on int16 ``e`` into a fresh uint8 out."""
    q, constants = fs.cols_operands(plan)
    taps = fs._int8_taps(q, e.device)
    h, w = plan.shape
    out = torch.empty((e.shape[0], h, w), dtype=torch.uint8, device=e.device)

    def run():
        rc = lib.fused_split_cols_int8(e.data_ptr(), out.data_ptr(), taps.data_ptr(),
                                       e.shape[0], h, w, plan.col.support_radius, 1,
                                       int(pre), *map(float, constants),
                                       torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"fused_split_cols_int8 failed: {rc}")
        return out
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--earlier", type=pathlib.Path, required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("cols_int8_tc.py needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    libs = {"earlier": _library(args.earlier, "fused_split_earlier"),
            "current": build.load_library()}
    _print_ptxas("current", build.last_build.get("log", ""))
    frames = torch.from_numpy(make_frames(4, 2160, 3840)).cuda().reshape(12, 2160, 3840)
    cases = [(frames, s, False) for s in (15.0, 50.0, 250.0)]
    cases.append((frames[:3, :1080, :1920].contiguous(), 250.0, False))
    cases.append((frames[:6, :1080], 250.0, True))  # a dp 2 x sp 2 shard
    rows_out = []
    for x, sigma, pre in cases:
        n, h, w = x.shape
        plan = make_plan((h, w), sigma)
        rh = plan.col.support_radius
        _, cols = fused_blur._split_plans(plan)
        if pre:  # the top shard's rows with rh halo rows each side (reflect-101 at the top)
            xp = reflect_101(frames[:6], [(rh, rh)], axes=[-2])[:, :h + 2 * rh].contiguous()
            rows = fused_blur._haloed_rows_plan(plan)
        else:
            xp, rows = x.contiguous(), fused_blur._split_plans(plan)[0]
        at = f"{n}x{h}x{w} r {rh}" + (" pre-padded" if pre else "")
        e = fs.fused_split_rows_int8(xp, rows)
        runs = {k: _cols(lib, e, cols, pre) for k, lib in libs.items()}
        got = {k: f().clone() for k, f in runs.items()}
        torch.cuda.synchronize()
        for k, v in got.items():
            if not torch.equal(v, got["current"]):
                raise RuntimeError(f"{k} differs from the current int8 cols pass at {at}")
        if h * w <= 1080 * 1920 and not pre:
            want = fs.fused_split_cols_int8_ref(e, cols)
            if not torch.equal(got["current"], want):
                raise RuntimeError(f"the int8 cols pass differs from its plain version at {at}")
        line = {"at": at, **in_turns(f"cols int8 {at}", runs)}
        print("cols_int8_tc " + json.dumps(line), flush=True)
        rows_out.append(line)
        del e
    print(json.dumps({"cols_int8_tc": rows_out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
