"""Probe of K3/K3f (``csrc/fft4step.cu``) on the card: design variants.

Builds patched copies of the K3 source, each into its own library under
``build/probe/``, and times them with CUDA events against the shipped
kernel at the main path's four shapes: K3f on both axes of sigma 250 (n
6144 rows, 4096 columns; the framing loader) and K3 on both axes of the
sigma 400 adjoint (n 16384, 8192), batch 4 RGB 2160x3840 as float
(``utils/frames.make_frames``). Variants:

- ``persistent``: a grid of as many blocks as fit on the card at once,
  each walking pairs of rows, that prefetches the next pair's rows into L2
  (``prefetch.global.L2``) while it computes this one;
- ``two_level_r32``: the radix-32 pass over spans of 1024 forms its
  twiddles as the two-level product, like the other passes, in place of
  the per-block 1024-entry table;
- ``k3_through_framing``: K3 runs the framing loader and store (K3f's code
  path with dim = n, pad = 0) in place of its own unframed one.

Each variant's output must equal the shipped kernel's bit for bit (they
compute the same values). At each shape the shipped kernel and the
variants run in turns, forward then backward through the list, median of
20 calls each. Run from the repository root on a machine with one CUDA
card:

    python3 probes/k3_variants.py
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
import torch.nn.functional as F  # noqa: E402

from blur_algorithms_tpu_torch import make_plan  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fft4step  # noqa: E402
from blur_algorithms_tpu_torch.ops.fft_mxu import transform_length  # noqa: E402
from blur_algorithms_tpu_torch.utils import build, timing  # noqa: E402
from blur_algorithms_tpu_torch.utils.frames import make_frames  # noqa: E402

SRC = build._CSRC / "fft4step.cu"

_PERSISTENT_LOOP = (
    "  const int ra = blockIdx.x;\n"
    "  const int rb = blockIdx.x + half;\n"
    "  const bool has_b = rb < rows;\n",
    "  __syncthreads();\n"
    "  for (int ra = blockIdx.x; ra < half; ra += gridDim.x) {\n"
    "  const int rb = ra + half;\n"
    "  const bool has_b = rb < rows;\n"
    "  const int na = ra + gridDim.x, lines = (dim + 31) >> 5;\n"
    "  if (na < half)\n"
    "    for (int l = threadIdx.x; l < 2 * lines; l += T) {\n"
    "      const int r = l < lines ? na : na + half;\n"
    "      if (r < rows)\n"
    "        asm volatile(\"prefetch.global.L2 [%0];\" ::\"l\"(\n"
    "            x + static_cast<size_t>(r) * dim + ((l < lines ? l : l - lines) << 5)));\n"
    "    }\n",
)
# name -> [(text in the shipped source, replacement), ...]
VARIANTS = {
    "shipped": [],
    "persistent": [
        _PERSISTENT_LOOP,
        ("  if constexpr (kQ) fft_pass<Q, true, false, true, kP, 1, N / Q, T, kFramed>(sm, io);\n}",
         "  if constexpr (kQ) fft_pass<Q, true, false, true, kP, 1, N / Q, T, kFramed>(sm, io);\n"
         "  }\n}"),
        ("  const int half = (rows + 1) / 2;\n"
         "  kernel<<<half, Plan<N>::T,",
         "  const int half = (rows + 1) / 2;\n"
         "  int dev = 0, sms = 0, per_sm = 0;\n"
         "  cudaGetDevice(&dev);\n"
         "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);\n"
         "  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, Plan<N>::T,\n"
         "                                                Plan<N>::kSmem);\n"
         "  const int grid = half < sms * per_sm ? half : sms * per_sm;\n"
         "  kernel<<<grid, Plan<N>::T,"),
    ],
    "two_level_r32": [("R == kE ? sm.t1k[q * j] : twiddle(sm, q * j * TW_MUL)",
                       "twiddle(sm, q * j * TW_MUL)")],
    "k3_through_framing": [("return launch(x, out, tw, h, complex_h, rows, n, n, 0, false,",
                            "return launch(x, out, tw, h, complex_h, rows, n, n, 0, true,")],
}
ITERS = 20


def _patched(name: str) -> str:
    text = SRC.read_text()
    for old, new in VARIANTS[name]:
        count = text.count(old)
        if count < 1:
            raise RuntimeError(f"variant {name}: {old[:60]!r} not in {SRC.name}")
        text = text.replace(old, new)
    return text


def _build(name: str, out_dir: pathlib.Path):
    src = out_dir / f"k3_{name}.cu"
    src.write_text(_patched(name))
    lib = out_dir / f"k3_{name}.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)]
    return lib, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)


def _launcher(lib, rows, n, axis_plan, framed):
    tw = fft4step._twiddles(n, rows.device)
    h, complex_h = fft4step._kernel_spectrum(axis_plan, n, rows.device)
    out = torch.empty_like(rows)
    stream = torch.cuda.current_stream().cuda_stream
    args = (rows.data_ptr(), out.data_ptr(), tw.data_ptr(), h.data_ptr(), int(complex_h),
            rows.shape[0], n)

    def run():
        rc = (lib.fft_conv_rows_framed(*args, axis_plan.dim, axis_plan.pad, stream) if framed
              else lib.fft_conv_rows(*args, stream))
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return out

    return run


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("probes/k3_variants.py needs a CUDA device")
    out_dir = build.build_dir() / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {name: _build(name, out_dir) for name in VARIANTS}
    libs = {}
    vp, i = ctypes.c_void_p, ctypes.c_int
    for name, (lib, cmd, proc) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}: {' '.join(cmd)}\n{out}{err}")
        libs[name] = ctypes.CDLL(str(lib))
        libs[name].fft_conv_rows.argtypes = [vp, vp, vp, vp, i, i, i, vp]
        libs[name].fft_conv_rows_framed.argtypes = [vp, vp, vp, vp, i, i, i, i, i, vp]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)

    x = torch.from_numpy(make_frames(4, 2160, 3840).astype(np.float32)).cuda()
    h, w = x.shape[-2:]
    cases = []
    plan = make_plan((h, w), 250.0)
    cases.append(("K3f rows sigma 250", x.reshape(-1, w), plan.row, True))
    cases.append(("K3f cols sigma 250", x.transpose(-1, -2).contiguous().reshape(-1, h),
                  plan.col, True))
    plan = make_plan((h, w), 400.0)
    for axis_plan, t, label in ((plan.row, x, "K3 adjoint rows sigma 400"),
                                (plan.col, x.transpose(-1, -2), "K3 adjoint cols sigma 400")):
        r = axis_plan.support_radius
        n = max(256, 1 << (axis_plan.dim + 4 * r - 1).bit_length())
        padded = F.pad(t.reshape(-1, axis_plan.dim), (2 * r, n - axis_plan.dim - 2 * r))
        cases.append((label, padded.contiguous(), axis_plan, False))
    del x

    order = list(VARIANTS) + list(VARIANTS)[::-1]
    for label, rows, axis_plan, framed in cases:
        n = transform_length(axis_plan) if framed else rows.shape[1]
        runs = {name: _launcher(lib, rows, n, axis_plan, framed) for name, lib in libs.items()}
        want = runs["shipped"]().clone()
        for name, run in runs.items():
            if not torch.equal(run(), want):
                raise RuntimeError(f"{name} differs from the shipped kernel at {label}")
        times = {name: [] for name in runs}
        for name in order:
            times[name].append(timing.time_cuda(runs[name], iters=ITERS, name=name).median_ms)
        line = ", ".join(f"{k} {np.mean(v):.4f} ({' / '.join(f'{t:.4f}' for t in v)})"
                         for k, v in times.items())
        print(f"{label}: {rows.shape[0]} rows, n {n}, ms in turns: {line}", flush=True)
        del rows, runs, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
