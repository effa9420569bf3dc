"""Probe of the split's two passes on the card: the tensor-core kernels of
``csrc/fused_split.cu`` against an earlier version of the same source.

Compiles ``--earlier`` (a ``fused_split.cu``, e.g. the parent commit's,
unpacked with ``git archive`` into ``build/``) into its own library under
``build/probe/``, loads the package's library, and times the rows pass
(int16 E out) and the hybrid pass 2 (uint8 out) of each, in turns (earlier,
current, current, earlier; the mean of two medians of 20 CUDA-event
timings), at the split's main shapes: 12 planes of 2160x3840
(``utils/frames.make_frames``) at support radius 49, 165 and 831, 3 planes
of 1080x1920 at r 831, and the pre-padded pass 2 on one dp 2 x sp 2 shard
at r 831 (6 planes of 1080 rows and 831 halo rows each side). The current
rows pass must equal the earlier one, the current pass 2's uint8 store
must be within 1 count of it. Run from the
repository root on a machine with one CUDA card:

    python3 probes/split_tc.py --earlier build/parent/blur_algorithms_tpu_torch/csrc/fused_split.cu
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


def _earlier_library(src: pathlib.Path) -> ctypes.CDLL:
    lib, _ = library(src, "fused_split_earlier")
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name in ("fused_split_rows_int8", "fused_split_cols_hybrid"):
        getattr(lib, name).argtypes = [vp, vp, vp, i, i, i, i, i, i, f, vp]
        getattr(lib, name).restype = i
    return lib


def _rows(lib, x, plan):
    """The rows pass of ``lib`` on ``x`` (n, h, w) into a fresh int16 E."""
    q, _, shift = fs.rows_operands(plan, True)
    taps = fs._int8_taps(q, x.device)
    out = torch.empty(x.shape, dtype=torch.int16, device=x.device)
    n, h, w = x.shape

    def run():
        rc = lib.fused_split_rows_int8(x.data_ptr(), out.data_ptr(), taps.data_ptr(), n, h,
                                       w, plan.row.support_radius, 1, shift, 0.0,
                                       torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"fused_split_rows_int8 failed: {rc}")
        return out
    return run


def _hybrid(lib, e, plan, pre):
    """The hybrid pass 2 of ``lib`` on int16 ``e`` into a fresh uint8 out."""
    taps = fs._device_f32_taps(plan, e.device)
    h, w = plan.shape
    out = torch.empty((e.shape[0], h, w), dtype=torch.uint8, device=e.device)

    def run():
        rc = lib.fused_split_cols_hybrid(e.data_ptr(), out.data_ptr(), taps.data_ptr(),
                                         e.shape[0], h, w, plan.col.support_radius, 1,
                                         int(pre), float(fs._HYBRID_SCALE),
                                         torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"fused_split_cols_hybrid failed: {rc}")
        return out
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--earlier", type=pathlib.Path, required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("split_tc.py needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    libs = {"earlier": _earlier_library(args.earlier), "current": build.load_library()}
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
        line = {"at": at}
        if not pre:
            runs = {k: _rows(lib, xp, rows) for k, lib in libs.items()}
            got = {k: f().clone() for k, f in runs.items()}
            torch.cuda.synchronize()
            if not torch.equal(got["current"], got["earlier"]):
                raise RuntimeError(f"the rows pass changed its output at {at}")
            line.update({f"rows_{k}": v for k, v in in_turns(f"rows {at}", runs).items()})
        e = fs.fused_split_rows_int8(xp, rows)
        runs = {k: _hybrid(lib, e, cols, pre) for k, lib in libs.items()}
        got = {k: f().clone() for k, f in runs.items()}
        torch.cuda.synchronize()
        d = int((got["current"].int() - got["earlier"].int()).abs().max())
        if d > 1:
            raise RuntimeError(f"the hybrid pass 2 moved {d} counts at {at}")
        line.update({f"hybrid_{k}": v for k, v in in_turns(f"hybrid {at}", runs).items()})
        line["hybrid_u8_max_diff"] = d
        print("split_tc " + json.dumps(line), flush=True)
        rows_out.append(line)
        del e
    print(json.dumps({"split_tc": rows_out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
