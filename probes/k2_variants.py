"""Probe of K2 and its single-axis form (``csrc/fused_blur.cu``) on the card.

Builds patched copies of the 3xTF32 source (the register ring's width kNB,
which sets n_tile, the outputs an item of a warp: 32 shipped, 64 with kNB 8;
the window chunk; the single-axis tile shapes and pipeline depth; the
blocks an SM; K2's tallest tile; the single-axis form without its staging
overlap; an ablation that stages windows and stores but issues no product),
each into its own library under ``build/probe/``, and, with ``--earlier
PATH ...``, earlier ``fused_blur.cu`` sources as yardsticks, each named by
its file stem: one that takes the band tables (the current C interface) or
raw f32 taps (the CUDA-core kernel, one ``fmaf`` a tap, before the tables).
At the main path's shapes (12 planes of 2160x3840, ``utils/frames``) it
checks every variant but the ablation against the plain version (``1e-3 *
max|x| / 255``, 1 count for uint8; the wide radii against the first
library) and times them in turns (``probes/_earlier.in_turns``): the f32
split's rows and cols passes at r 32 (sigma 10), K2 at sigma 10 and at r 1,
2, 3, 5 and 7 on f32 planes, K2 uint8 in and out with the signed 5-tap
sharpen of ``convolve_separable`` (r 2), the pre-padded cols pass at r 165
and K2 pre-padded at sigma 5 (r 15, under the H100's float split radius) on
a dp 2 x sp 2 shard (2x3x1080 rows), and both passes at r 1330 (sigma
400). A variant whose shared memory does not fit a case reports its launch
error there. Run from the repository root on a machine with one CUDA card:

    python3 probes/k2_variants.py [--earlier build/parent_fused_blur.cu ...]
        [--variants shipped,nb8,...] [--no-wide]
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from blur_algorithms_tpu_torch import make_custom_plan, make_plan  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fused_blur  # noqa: E402
from blur_algorithms_tpu_torch.utils import build  # noqa: E402
from blur_algorithms_tpu_torch.utils.frames import make_frames  # noqa: E402
import _earlier  # noqa: E402

SRC = build._CSRC / "fused_blur.cu"

# name -> [(text in the shipped source, replacement), ...]; nb8 (n_tile 64)
# takes 32 lines x 256 outputs a single-axis tile so that its 8 warps keep
# one item each
VARIANTS = {
    "shipped": [],
    "nb8": [("constexpr int kNB = 4;", "constexpr int kNB = 8;"),
            ("constexpr int kRowsLines = 16, kRowsOut = 256;",
             "constexpr int kRowsLines = 32, kRowsOut = 256;"),
            ("constexpr int kColsLines = 32, kColsOut = 128;",
             "constexpr int kColsLines = 32, kColsOut = 256;")],
    "chunk16": [("constexpr int kMaxChunk = 32;", "constexpr int kMaxChunk = 16;")],
    "chunk64": [("constexpr int kMaxChunk = 32;", "constexpr int kMaxChunk = 64;")],
    "rows32x128": [("constexpr int kRowsLines = 16, kRowsOut = 256;",
                    "constexpr int kRowsLines = 32, kRowsOut = 128;")],
    "cols16x256": [("constexpr int kColsLines = 32, kColsOut = 128;",
                    "constexpr int kColsLines = 16, kColsOut = 256;")],
    "cols64x64": [("constexpr int kColsLines = 32, kColsOut = 128;",
                   "constexpr int kColsLines = 64, kColsOut = 64;")],
    "blocks1": [("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)")],
    "blocks3": [("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 3)")],
    "th256": [("for (int th : {128, 64, 32})", "for (int th : {256, 128, 64, 32})")],
    # ablation: the output is wrong by design, only the time counts
    "stage_only": [(
        "          mma_tf32(step, st.hi[slot], th0, th1);\n"
        "          mma_tf32(st.low[b], st.hi[slot], tl0, tl1);\n"
        "          if (kLo) mma_tf32(st.low[b], st.lo[slot], th0, th1);\n", "")],
    # the single-axis form without the overlap: each thread waits for the
    # next chunk's copies before the products of this one
    "no_overlap": [(
        "    stage(stile, sc, s_w + ((k + kDepth - 1) % kDepth) * buf);\n",
        "    stage(stile, sc, s_w + ((k + kDepth - 1) % kDepth) * buf);\n"
        "    cp_async_wait_all();\n")],
    "depth3": [("constexpr int kDepth = 2;", "constexpr int kDepth = 3;")],
    "depth4": [("constexpr int kDepth = 2;", "constexpr int kDepth = 4;")],
}
ABLATIONS = ("stage_only",)
ITERS = 20


def _build(name: str, text: str, out_dir: pathlib.Path):
    src = out_dir / f"k2_{name}.cu"
    src.write_text(text)
    lib = out_dir / f"k2_{name}.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)]
    return lib, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True)


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.blur_fused_f32.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, i, i, vp]
    lib.blur_fused_f32.restype = i
    lib.blur_fused_axis_f32.argtypes = [vp, vp, vp, i, i, i, i, i, i, i, i, vp]
    lib.blur_fused_axis_f32.restype = i
    return lib


def _takes_tables(text: str) -> bool:
    """Whether a fused_blur.cu takes band tables (3xTF32) or raw taps."""
    return "table_len(" in text


def _taps(plan, device, tables: bool):
    """The tap operands of one library: band tables, or raw f32 taps."""
    if tables:
        return fused_blur._device_tables(plan, device)
    return tuple(torch.from_numpy(np.asarray(t, np.float32)).to(device)
                 for t in (plan.row.taps, plan.col.taps))


def _k2(lib, tables, x, plan, pre=False):
    taps_row, taps_col = _taps(plan, x.device, tables)
    h, w = plan.shape
    u8 = x.dtype == torch.uint8  # uint8 in, uint8 out
    out = torch.empty((x.shape[0], h, w), device=x.device, dtype=x.dtype)

    def run():
        rc = lib.blur_fused_f32(x.data_ptr(), out.data_ptr(), taps_row.data_ptr(),
                                taps_col.data_ptr(), int(u8), int(u8), int(pre), x.shape[0],
                                h, w, plan.col.support_radius, plan.row.support_radius,
                                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return out

    return run


def _axis(lib, tables, x, plan, pre=False):
    rh, rw = plan.col.support_radius, plan.row.support_radius
    taps = _taps(plan, x.device, tables)[0 if rw else 1]
    h, w = plan.shape
    out = torch.empty((x.shape[0], h, w), device=x.device)

    def run():
        rc = lib.blur_fused_axis_f32(x.data_ptr(), out.data_ptr(), taps.data_ptr(), 0, 0,
                                     int(pre), x.shape[0], h, w, int(rw > 0), max(rh, rw),
                                     torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return out

    return run


SHARPEN5 = [-0.125, -0.25, 1.75, -0.25, -0.125]  # convolve_separable's, r 2


def _cases(x, x8):
    """(label, kind, input, plan, pre_padded_col, check against the plain
    version) at the main path's shapes."""
    plan10 = make_plan((2160, 3840), 10.0)
    rows10, cols10 = fused_blur._split_plans(plan10)
    y10 = fused_blur.blur_fused_axis_f32(x, rows10)
    shard = x[:6, : 1080 + 2 * 165].contiguous()
    _, cols50 = fused_blur._split_plans(make_plan((1080, 3840), 50.0))
    plan5 = make_plan((1080, 3840), 5.0)
    shard5 = x[:6, : 1080 + 2 * plan5.col.support_radius].contiguous()
    cases = [
        ("rows r32", "axis", x, rows10, False, True),
        ("cols r32", "axis", y10, cols10, False, True),
        ("K2 sigma10", "k2", x, plan10, False, True),
    ]
    for sigma in (0.6, 1.0, 1.2, 2.0, 2.5):  # r 1, 2, 3, 5, 7
        plan = make_plan((2160, 3840), sigma)
        cases.append((f"K2 sigma{sigma} (r {plan.row.support_radius})", "k2", x, plan, False,
                      True))
    cases += [
        ("K2 uint8 sharpen (r 2)", "k2", x8, make_custom_plan((2160, 3840), SHARPEN5, SHARPEN5),
         False, True),
        ("cols r165 pre-padded shard", "axis", shard, cols50, True, True),
        (f"K2 sigma5 (r {plan5.col.support_radius}) pre-padded shard", "k2", shard5, plan5, True,
         True),
    ]
    if "--no-wide" not in sys.argv:
        rows400, cols400 = fused_blur._split_plans(make_plan((2160, 3840), 400.0))
        cases += [("rows r1330", "axis", x, rows400, False, False),
                  ("cols r1330", "axis", y10, cols400, False, False)]
    return cases


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--earlier", type=pathlib.Path, nargs="*", default=[])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--no-wide", action="store_true")
    args = ap.parse_args()
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
    for name in args.variants.split(","):
        text = shipped
        for old, new in VARIANTS[name]:
            if old not in text:
                raise RuntimeError(f"variant {name}: patch anchor not found")
            text = text.replace(old, new)
        jobs[name] = _build(name, text, out_dir)
    tables = dict.fromkeys(jobs, True)
    for path in args.earlier:
        text = path.read_text()
        jobs[path.stem] = _build(path.stem, text, out_dir)
        tables[path.stem] = _takes_tables(text)
    libs = {}
    for name, (path, cmd, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}: {' '.join(cmd)}\n{err}")
        regs = [ln.split("info    :")[-1].strip() for ln in err.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"built {name}: {' | '.join(regs)}", flush=True)
        libs[name] = _declare(ctypes.CDLL(str(path)))

    frames = torch.from_numpy(make_frames(4, 2160, 3840)).cuda()
    x8 = frames.reshape(12, 2160, 3840).contiguous()  # planar already
    x = x8.float()
    for label, kind, xin, plan, pre, plain in _cases(x, x8):
        make = _k2 if kind == "k2" else _axis
        runs = {}
        for name, lib in libs.items():
            runs[name] = make(lib, tables[name], xin, plan, pre)
        u8 = xin.dtype == torch.uint8
        if plain:
            want = fused_blur.blur_fused_f32_ref(xin, plan, out_u8=u8, pre_padded_col=pre)
        else:
            want = runs[next(iter(runs))]().clone()
        limit = 1 if u8 else 1e-3 * float(xin.abs().max()) / 255
        ok = {}
        for name, run in runs.items():
            try:
                got = run()
                torch.cuda.synchronize()
            except RuntimeError as e:
                print(f"{label} {name}: {e}", flush=True)
                continue
            err = float((got.double() - want.double()).abs().max())
            print(f"{label} {name}: max_abs_err vs {'plain' if plain else 'first'} "
                  f"{err:.3e} (limit {limit:.3e})", flush=True)
            if name not in ABLATIONS and not err <= limit:
                raise RuntimeError(f"{label}: variant {name} is off by {err}")
            ok[name] = run
        del want
        iters = ITERS if "r1330" not in label else 5
        t = _earlier.in_turns(label, ok, iters=iters)
        print(f"{label} (ms, in turns): " + ", ".join(f"{k} {v:.4f}" for k, v in t.items()),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
