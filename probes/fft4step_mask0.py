"""Probe of K3/K3f (``csrc/fft4step.cu``) on the card: the current source,
whose kernels are the ablation body with mask 0, against an earlier version
of the same source.

Compiles ``--earlier`` (an ``fft4step.cu``, e.g. the parent commit's, put
into ``build/`` with ``git show``) and the current ``csrc/fft4step.cu``,
each on its own, into libraries under ``build/probe/`` (the current one
for its ptxas lines: the package's library may be built already), prints
each ``fft_conv_rows_kernel`` instantiation's ptxas registers and spills
for both and whether they are equal, then times ``fft_conv_rows`` (K3) and
``fft_conv_rows_framed`` (K3f) of each in turns (earlier, current, current,
earlier; the mean of two medians of 20 CUDA-event timings) on the rows of
``chip_smoke.py`` phase 10 (both axes of the sigma 400 adjoint, K3; both
axes of sigma 250, K3f; 4 RGB 2160x3840 frames), each output
``torch.equal`` to the other's. Run from the repository root on a machine
with one CUDA card:

    python3 probes/fft4step_mask0.py --earlier build/parent_fft4step.cu
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import sys
import threading

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from _earlier import in_turns, library  # noqa: E402

from blur_algorithms_tpu_torch.benchmarks.fft_mxu_ablation import cells  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fft4step  # noqa: E402
from blur_algorithms_tpu_torch.utils import build  # noqa: E402


def _ptxas(log: str) -> dict:
    """``{template arguments: registers / spills}`` of fft_conv_rows_kernel."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"fft_conv_rows_kernel(ILi\d+ELb\dEE)", ln)
            name = m.group(1) if m else None
        elif name and ("registers" in ln or "spill" in ln):
            out[name] = (out.get(name, "") + " " + ln.replace("ptxas info    :", "").strip()).strip()
    return out


def _earlier_entry(lib: ctypes.CDLL, framed: bool):
    """The earlier library's C entry with the wrapper's operands."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.fft_conv_rows_framed if framed else lib.fft_conv_rows
    fn.argtypes = [vp] * 4 + [i] * (5 if framed else 3) + [vp]
    fn.restype = i

    def run(rows, n, ax):
        out = torch.empty_like(rows)
        tw = fft4step._twiddles(n, rows.device)
        h, complex_h = fft4step._kernel_spectrum(ax, n, rows.device)
        extra = (ax.dim, ax.pad) if framed else ()
        rc = fn(rows.data_ptr(), out.data_ptr(), tw.data_ptr(), h.data_ptr(), int(complex_h),
                rows.shape[0], n, *extra, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"the earlier K3 launch failed: CUDA error {rc}")
        return out

    return run


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--earlier", type=pathlib.Path, required=True)
    args = p.parse_args()
    earlier: dict = {}
    t = threading.Thread(target=lambda: earlier.update(
        zip(("lib", "log"), library(args.earlier, "earlier_fft4step"))))
    t.start()
    _, log_now = library(build._CSRC / "fft4step.cu", "current_fft4step")
    build.load_library()
    t.join()
    if "lib" not in earlier:
        raise RuntimeError("the earlier source did not build")
    now, then = _ptxas(log_now), _ptxas(earlier["log"])
    same = [k for k in then if now.get(k) == then[k]]
    for k in then:
        print(f"ptxas fft_conv_rows_kernel{k}: earlier {then[k]} | current {now.get(k)}",
              flush=True)
    print(f"ptxas: {len(same)} of {len(then)} instantiations equal", flush=True)
    rng = np.random.default_rng(0)
    res = {}
    for label, nrows, n, ax, framed in cells():
        x = torch.from_numpy(rng.standard_normal((nrows, ax.dim if framed else n),
                                                 dtype=np.float32)).cuda()
        cur = fft4step.fft_conv_rows_framed if framed else fft4step.fft_conv_rows
        old = _earlier_entry(earlier["lib"], framed)
        equal = torch.equal(cur(x, n, ax), old(x, n, ax))
        res[label] = {**in_turns(label, {"earlier": lambda: old(x, n, ax),
                                         "current": lambda: cur(x, n, ax)}), "equal": equal}
        print(f"{label}: {json.dumps(res[label])}", flush=True)
        del x
    print(json.dumps({"ptxas_equal": len(same), "ptxas_total": len(then), "times": res}))
    return 0 if len(same) == len(then) and all(r["equal"] for r in res.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
