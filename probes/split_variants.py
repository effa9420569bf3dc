"""Probe of the split's tensor-core passes on the card: variants and ablations.

Builds patched copies of ``csrc/fused_split.cu`` (each alone into its own
library under ``build/probe/``, all ``nvcc`` started together) and times
the rows pass (int16 E out) and the hybrid pass 2 (uint8 out) of each in
turns (forward then backward through the list; median of 20 CUDA-event
timings each, the mean of the two) on 12 planes of 2160x3840
(``utils/frames.make_frames``) at support radius 831 and 49. The ablations
drop one part of a kernel (in the main loop the ``ldmatrix`` of B, the
shared-memory loads of A, or the ``mma`` itself, kept live by a cheap use
of its operands; the window loads, the reflect-101 edge segments, the tap
build, pass 2's fetch or its conversion to bf16): their output is wrong by
design, only the time counts; the time an ablation saves is what that part
costs in the shipped kernel. Run
from the repository root on a machine with one CUDA card:

    python3 probes/split_variants.py
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from blur_algorithms_tpu_torch import make_plan  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fused_blur  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fused_split as fs  # noqa: E402
from blur_algorithms_tpu_torch.utils import build, timing  # noqa: E402
from blur_algorithms_tpu_torch.utils.frames import make_frames  # noqa: E402

SRC = build._CSRC / "fused_split.cu"
ITERS = 20

# name -> [(text in the shipped source, replacement), ...]
VARIANTS = {
    "shipped": [],
    # the rows pass
    "rows_no_ldsm": [("        ldsm_x4(xs + p * 16 * kRowsPitch, b);",
                      "        b[0] = xs + p; b[1] = xs ^ p; b[2] = xs + 2 * p; b[3] = xs - p;")],
    "rows_no_a": [(
        "      const unsigned ah[4] = {qh[8 * s], qh[8 * s - 2], qh[8 * s + 4], qh[8 * s + 2]};\n"
        "      const unsigned al[4] = {ql[8 * s], ql[8 * s - 2], ql[8 * s + 4], ql[8 * s + 2]};",
        "      const unsigned ah[4] = {unsigned(s), unsigned(s) + 1u, unsigned(s) + 2u, 3u};\n"
        "      const unsigned al[4] = {unsigned(s) ^ 5u, 6u, unsigned(s) + 7u, 8u};")],
    "rows_no_mma": [(
        "__device__ __forceinline__ void mma_s8u8(int (&d)[4], const unsigned (&a)[4], unsigned b0,\n"
        "                                         unsigned b1) {\n"
        "  asm(",
        "__device__ __forceinline__ void mma_s8u8(int (&d)[4], const unsigned (&a)[4], unsigned b0,\n"
        "                                         unsigned b1) {\n"
        "  d[0] ^= a[0] ^ b0; d[1] ^= a[1] ^ b1; d[2] += a[2]; d[3] += a[3];\n"
        "  if (0) asm(")],
    "rows_no_loads": [("    if (c < nload) {\n      for (int k = tid; k < kRowsTr * (kRowsLoad / 16)",
                       "    if (false && c < nload) {\n      for (int k = tid; k < kRowsTr * (kRowsLoad / 16)")],
    "rows_zero_edges": [("        } else if (vec && gc < 0 && gc >= 16 - w) {",
                         "        } else if (true) {\n"
                         "          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);\n"
                         "        } else if (vec && gc < 0 && gc >= 16 - w) {")],
    "rows_no_taps": [("        tw[d][k] = (wi >= 0 && wi < nqw) ? static_cast<unsigned>(taps[d * nqw + wi]) : 0u;",
                      "        tw[d][k] = static_cast<unsigned>(wi);"),
                     ("  for (int k = lane; k < 2 * nqw; k += 32) {",
                      "  for (int k = lane; k < 0; k += 32) {")],
    # the hybrid pass 2
    "hyb_no_fetch": [("      if (vec && gj + 8 <= w) {\n        cp_async16(smem_u32(dst), src + gj);",
                      "      if (true) {\n")],
    "hyb_no_convert": [("      *reinterpret_cast<uint4*>(s_y + ((c * kHybLoad + rr) % kHybRing) * (2 * kHybPitch) +\n"
                        "                                ((k & 7) << 4)) = y;",
                        "      if (y.x == 12345u) *reinterpret_cast<uint4*>(s_y) = y;")],
    "hyb_no_ldsm": [("        ldsm_x4_t(yr + 32 * q, r);",
                     "        r[0] = yr + q; r[1] = yr ^ q; r[2] = yr + 2 * q; r[3] = yr - q;")],
    "hyb_no_a": [(
        "      const unsigned a[4] = {cs[0], cs[-8 * kHybGroupWords], cs[4], cs[4 - 8 * kHybGroupWords]};",
        "      const unsigned a[4] = {unsigned(s) << 16, unsigned(s + 1) << 16, unsigned(s + 2) << 16,\n"
        "                             unsigned(s + 3) << 16};")],
    "hyb_no_mma": [(
        "__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,\n"
        "                                         unsigned b1) {\n"
        "  asm(",
        "__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,\n"
        "                                         unsigned b1) {\n"
        "  d[0] += __uint_as_float(a[0] ^ b0); d[1] += __uint_as_float(a[1] ^ b1);\n"
        "  d[2] += __uint_as_float(a[2]); d[3] += __uint_as_float(a[3]);\n"
        "  if (0) asm(")],
}
ABLATIONS = {k for k in VARIANTS if "_no_" in k or "_zero_" in k}


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name in ("fused_split_rows_int8", "fused_split_cols_hybrid"):
        getattr(lib, name).argtypes = [vp, vp, vp, i, i, i, i, i, i, f, vp]
        getattr(lib, name).restype = i
    return lib


def _build_all() -> dict:
    out_dir = build.build_dir() / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    shipped = SRC.read_text()
    jobs = {}
    for name, patches in VARIANTS.items():
        text = shipped
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"variant {name}: patch target not in the source")
            text = text.replace(old, new)
        src = out_dir / f"split_{name}.cu"
        src.write_text(text)
        lib = out_dir / f"split_{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)]
        jobs[name] = (lib, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, cmd, proc) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}: {' '.join(cmd)}\n{out}{err}")
        regs = [ln.split(":", 1)[1].strip() for ln in (out + err).splitlines()
                if "registers" in ln and "ptxas info" in ln]
        print(f"split_variants build {name}: {regs}", flush=True)
        libs[name] = _declare(ctypes.CDLL(str(lib)))
    return libs


def _runner(lib, which, x, e, rows, cols):
    stream = torch.cuda.current_stream().cuda_stream
    if which == "rows":
        q, _, shift = fs.rows_operands(rows, True)
        taps = fs._int8_taps(q, x.device)
        out = torch.empty(x.shape, dtype=torch.int16, device=x.device)

        def run():
            rc = lib.fused_split_rows_int8(x.data_ptr(), out.data_ptr(), taps.data_ptr(),
                                           x.shape[0], x.shape[1], x.shape[2],
                                           rows.row.support_radius, 1, shift, 0.0, stream)
            if rc:
                raise RuntimeError(f"rows launch failed: {rc}")
            return out
        return run
    taps = fs._device_f32_taps(cols, e.device)
    out = torch.empty(e.shape, dtype=torch.uint8, device=e.device)

    def run():
        rc = lib.fused_split_cols_hybrid(e.data_ptr(), out.data_ptr(), taps.data_ptr(),
                                         e.shape[0], e.shape[1], e.shape[2],
                                         cols.col.support_radius, 1, 0,
                                         float(fs._HYBRID_SCALE), stream)
        if rc:
            raise RuntimeError(f"hybrid launch failed: {rc}")
        return out
    return run


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("split_variants.py needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    libs = _build_all()
    x = torch.from_numpy(make_frames(4, 2160, 3840)).cuda().reshape(12, 2160, 3840)
    table = []
    for sigma in (250.0, 15.0):
        plan = make_plan((2160, 3840), sigma)
        rows, cols = fused_blur._split_plans(plan)
        e = fs.fused_split_rows_int8(x, rows)
        for which in ("rows", "hybrid"):
            names = [n for n in VARIANTS
                     if n == "shipped" or n.startswith("rows" if which == "rows" else "hyb")]
            runs = {n: _runner(libs[n], which, x, e, rows, cols) for n in names}
            want = runs["shipped"]().clone()
            for n in names:
                if n not in ABLATIONS:
                    got = runs[n]()
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise RuntimeError(f"variant {n} changed the {which} output")
            t = {n: [] for n in names}
            for n in (*names, *reversed(names)):
                t[n].append(timing.time_cuda(runs[n], iters=ITERS,
                                             name=f"{which} {n}").median_ms)
            line = {"pass": which, "r": plan.row.support_radius,
                    **{n: float(np.mean(v)) for n, v in t.items()}}
            print("split_variants " + json.dumps(line), flush=True)
            table.append(line)
    print(json.dumps({"split_variants": table}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
