"""Probe of K1 (``csrc/fused_dma.cu``) on the card: the current source, whose
assembled forms issue their row groups through ``issue_group`` (the loader
B3 times, ``csrc/probes/fetch_rate.cu``), against an earlier version of the
same source.

Compiles ``--earlier`` (a ``fused_dma.cu``, e.g. the parent commit's, put
into ``build/`` with ``git show``) and the current ``csrc/fused_dma.cu``,
each on its own, into libraries under ``build/probe/``, prints each kernel
instantiation's ptxas registers and spills for both and whether they are
equal, then runs ``blur_fused_u8_dma`` on 4 RGB 2160x3840 frames at sigma 10
in the forms and bodies below through each library in turns (earlier,
current, current, earlier; the mean of two medians of 20 CUDA-event
timings), each output ``torch.equal`` to the other's. Run from the
repository root on a machine with one CUDA card:

    python3 probes/fused_dma_loaders.py --earlier build/parent_fused_dma.cu
"""

from __future__ import annotations

import argparse
import contextlib
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

from blur_algorithms_tpu_torch import make_plan  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fused_dma  # noqa: E402
from blur_algorithms_tpu_torch.utils import build  # noqa: E402

# the C entries of fused_dma.cu, which K1's wrappers and A5's call
ENTRIES = ("blur_fused_u8_k1", "assemble_padded_u8", "assemble_padded_prepad_u8",
           "blur_cuda_error_string")
# (label, precision, form keywords of blur_fused_u8_dma)
CASES = (("direct int8", "int8", {"direct": True}),
         ("assembled int8", "int8", {"direct": False}),
         ("pipelined int8", "int8", {"pipelined": True}),
         ("assembled hybrid", "hybrid", {"direct": False}),
         ("assembled bf16", "bf16", {"direct": False}))


def _ptxas(log: str) -> dict:
    """``{mangled kernel name: registers / spills}`` of every entry function,
    the name without its anonymous namespace (which holds the file's name)."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"entry function '(\w+)'", ln)
            name = m.group(1) if m else None
            ns = re.match(r"_ZN(\d+)_GLOBAL__N_", name or "")
            if ns:
                name = name[ns.end(1) + int(ns.group(1)):]
        elif name and ("registers" in ln or "spill" in ln):
            out[name] = (out.get(name, "") + " " + ln.replace("ptxas info    :", "").strip()).strip()
    return out


@contextlib.contextmanager
def _serving(lib):
    """The package's wrappers call ``lib`` (fused_dma.cu's entries alone)."""
    kept = build._lib
    build._lib = lib
    try:
        yield
    finally:
        build._lib = kept


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--earlier", type=pathlib.Path, required=True)
    args = p.parse_args()
    earlier: dict = {}
    t = threading.Thread(target=lambda: earlier.update(
        zip(("lib", "log"), library(args.earlier, "earlier_fused_dma"))))
    t.start()
    cur_lib, log_now = library(build._CSRC / "fused_dma.cu", "current_fused_dma")
    full = build.load_library()
    t.join()
    if "lib" not in earlier:
        raise RuntimeError("the earlier source did not build")
    for lib in (cur_lib, earlier["lib"]):
        for entry in ENTRIES:
            getattr(lib, entry).argtypes = getattr(full, entry).argtypes
            getattr(lib, entry).restype = getattr(full, entry).restype
    now, then = _ptxas(log_now), _ptxas(earlier["log"])
    same = [k for k in then if now.get(k) == then[k]]
    for k in then:
        if now.get(k) != then[k]:
            print(f"ptxas {k}: earlier {then[k]} | current {now.get(k)}", flush=True)
    print(f"ptxas: {len(same)} of {len(then)} entry functions equal "
          f"({len(now)} in the current source)", flush=True)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 256, (12, 2160, 3840), dtype=np.uint8)).cuda()
    plan = make_plan((2160, 3840), 10.0)
    res = {}
    for label, precision, kw in CASES:
        def run(lib, precision=precision, kw=kw):
            with _serving(lib):
                return fused_dma.blur_fused_u8_dma(x, plan, precision=precision, **kw)

        equal = torch.equal(run(cur_lib), run(earlier["lib"]))
        res[label] = {**in_turns(label, {"earlier": lambda run=run: run(earlier["lib"]),
                                         "current": lambda run=run: run(cur_lib)}),
                      "equal": equal}
        print(f"{label}: {json.dumps(res[label])}", flush=True)
    print(json.dumps({"ptxas_equal": len(same), "ptxas_total": len(then),
                      "ptxas_current": len(now), "times": res}))
    ok = len(same) == len(then) == len(now) and all(r["equal"] for r in res.values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
