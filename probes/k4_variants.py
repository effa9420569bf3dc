"""Probe of K4 (``csrc/box_scan.cu``) on the card: the kernel against an
earlier version of the same source.

Compiles ``--earlier`` (a ``box_scan.cu``, e.g. the parent commit's, put
into ``build/`` with ``git show``) into its own library under
``build/probe/``, loads the package's library, and times
``box_blur_scan_axis``'s launch of each, in turns (earlier, current,
current, earlier; the mean of two medians of 20 CUDA-event timings): the
uint8 box of ``box_blur`` nsmooth 20 (support 800: r 400, 2 passes) on 12
planes of 2160x3840 (``utils/frames.make_frames``), rows
uint8 -> f32 and columns f32 -> uint8, the same axes on f32 planes, and the
two uint8-path axes on 3 planes of 1080x1920. Both must agree with
the plain version (1 count on the uint8 store, 1e-3 * max|x| / 255 on f32).
``--tiles parent`` (the default) gives the earlier source the rows tiles of
the kernel before its redesign (a span of at most 8192 values, else the
lines kernel); ``--tiles current`` gives it the current policy, for a
variant of the current source. Run from the repository root on a machine
with one CUDA card:

    python3 probes/k4_variants.py --earlier build/parent_box_scan.cu
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

from blur_algorithms_tpu_torch.cuda_kernels import box_blur as k4  # noqa: E402
from blur_algorithms_tpu_torch.utils import build  # noqa: E402
from blur_algorithms_tpu_torch.utils.frames import make_frames  # noqa: E402
from blur_algorithms_tpu_torch.utils.hw import device_spec  # noqa: E402

RADIUS, PASSES = 400, 2


def _library(src: pathlib.Path, name: str) -> ctypes.CDLL:
    lib, _ = library(src, name)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.box_scan_axis.argtypes = [vp] * 4 + [i] * 10 + [vp]
    lib.box_scan_axis.restype = i
    return lib


def _axis(lib, x, axis, out_u8, policy):
    """One launch of ``lib``'s K4 along ``axis``, with the rows tiles of
    ``policy`` (``"current"`` or ``"parent"``)."""
    h, w = x.shape[-2:]
    xs = x.reshape(-1, h, w)
    out = torch.empty(xs.shape, dtype=torch.uint8 if out_u8 else torch.float32, device=x.device)
    n, pad = (w, h)[axis == -2], PASSES * RADIUS
    tile = 0
    if axis == -1:
        smem = device_spec(x.device).smem_optin_bytes
        if policy == "current":
            tile = k4._rows_tile(n, pad, smem)
        elif n + 2 * pad <= 8192:  # the parent's policy: 12 bytes a value
            tile = n
    scratch_len = n + 2 * pad - 2 * RADIUS
    scratch = [None, None]
    if tile == 0:
        scratch[0] = torch.empty(xs.shape[0] * (w if axis == -2 else h) * scratch_len,
                                 dtype=torch.float32, device=x.device)

    def run():
        rc = lib.box_scan_axis(xs.data_ptr(), out.data_ptr(),
                               *(s.data_ptr() if s is not None else None for s in scratch),
                               int(xs.dtype == torch.uint8), int(out_u8), xs.shape[0], h, w,
                               int(axis == -1), RADIUS, PASSES, tile, scratch_len,
                               torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"box_scan_axis failed: {rc}")
        return out
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--earlier", type=pathlib.Path, required=True)
    ap.add_argument("--tiles", choices=("parent", "current"), default="parent")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("k4_variants.py needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    libs = {"earlier": (_library(args.earlier, "box_scan_earlier"), args.tiles),
            "current": (build.load_library(), "current")}
    planar = torch.from_numpy(make_frames(4, 2160, 3840)).cuda().reshape(12, 2160, 3840)
    x = planar.float()
    hd = planar[:3, :1080, :1920].contiguous()
    rows_f32 = k4.box_blur_scan_axis(planar, RADIUS, PASSES, -1)
    hd_rows = k4.box_blur_scan_axis(hd, RADIUS, PASSES, -1)
    cases = [("12x2160x3840 rows u8->f32", planar, -1, False),
             ("12x2160x3840 cols f32->u8", rows_f32, -2, True),
             ("12x2160x3840 rows f32", x, -1, False),
             ("12x2160x3840 cols f32", x, -2, False),
             ("3x1080x1920 rows u8->f32", hd, -1, False),
             ("3x1080x1920 cols f32->u8", hd_rows, -2, True)]
    out = []
    for at, t, axis, out_u8 in cases:
        runs = {k: _axis(lib, t, axis, out_u8, pol) for k, (lib, pol) in libs.items()}
        want = k4.box_blur_scan_axis_ref(t, RADIUS, PASSES, axis, out_u8)
        limit = 1.0 if out_u8 else 1e-3 * float(t.float().abs().max()) / 255
        errs = {}
        for k, f in runs.items():
            got = f()
            torch.cuda.synchronize()
            errs[k] = float((got.double() - want.double()).abs().max())
            if not errs[k] <= limit:
                raise RuntimeError(f"{k} K4 disagrees with its plain version at {at}: {errs[k]}")
        del want
        line = {"at": at, **in_turns(f"K4 {at}", runs), "max_abs_err": errs}
        print("k4_variants " + json.dumps(line), flush=True)
        out.append(line)
    print(json.dumps({"k4_variants": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
