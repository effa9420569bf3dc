"""Probe of the uint8 layout moves (``csrc/layout.cu``) on the card: the
package's kernels against the variants of their vector body in
``probes/layout_parts.cu`` (the interleaved side's accesses made directly,
not through shared memory), PyTorch's ``movedim(...).contiguous()`` (the
plain version, what the port ran before) and a contiguous ``copy_`` of the
same bytes (a yardstick of the card's copy rate), in turns.

At each shape (4 and 32 RGB 4K frames, the 24000x14500 photo; 3 and 8
ragged 1001x1777 frames and a crop of 4 4K frames, 2080x3640 of each, which
take the kernels' strided path, timed against that path at 4, 8 and 16
pixels a thread, the source taking up to 8 to planar and 4 back) and in
each direction it holds every kernel and variant ``torch.equal`` to the
expression, then times them in turns (forward then backward through the
list, median of 20 calls each; each call allocates its output as the
package's wrapper does) and prints each time beside its bytes bound (what a
move reads and writes once at 3.35 TB/s) and its effective rate. Before
that it prints the card and the ptxas registers and spills of every kernel
of both sources. Run from the repository root on a machine with one CUDA
card (~2 minutes with the builds); one JSON line a shape and move:

    python3 probes/layout_variants.py
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from blur_algorithms_tpu_torch.cuda_kernels import layout  # noqa: E402
from blur_algorithms_tpu_torch.utils import build  # noqa: E402
from _earlier import in_turns, library, ptxas  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
VARIANTS = {"direct": 0, "direct_g2": 1, "direct_g4": 2, "no_hints": 3}
SHAPES = {  # (frames, the crop of each or None)
    "4k_b4": ((4, 2160, 3840, 3), None),
    "4k_b32": ((32, 2160, 3840, 3), None),
    "photo": ((1, 14500, 24000, 3), None),
    "ragged_b3": ((3, 1001, 1777, 3), None),
    "ragged_b8": ((8, 1001, 1777, 3), None),
    "crop_4k": ((4, 2160, 3840, 3), (slice(37, 2117), slice(101, 3741))),
}
STRIDED = {"strided_p4": 4, "strided_p8": 8, "strided_p16": 16}


def _parts() -> ctypes.CDLL:
    src = build.build_dir() / "probe" / "layout_parts_tu.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(f'#include "{build._CSRC / "layout.cu"}"\n'
                   f'#include "{ROOT / "probes" / "layout_parts.cu"}"\n')
    lib, log = library(src, "layout_parts")
    for ln in ptxas(log, "layout_u8") + ptxas(log, "parts_"):
        print("ptxas", ln, flush=True)
    lib.layout_parts.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    lib.layout_parts.restype = ctypes.c_int
    lib.layout_strided_parts.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                         ctypes.c_void_p, ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p]
    lib.layout_strided_parts.restype = ctypes.c_int
    return lib


def _variant(lib, variant: int, to_planar: bool):
    def run(x):
        lead = x.shape[:-3]
        h, w = (x.shape[-3], x.shape[-2]) if to_planar else (x.shape[-2], x.shape[-1])
        out = torch.empty((*lead, 3, h, w) if to_planar else (*lead, h, w, 3),
                          dtype=torch.uint8, device=x.device)
        rc = lib.layout_parts(variant, int(to_planar), x.data_ptr(), out.data_ptr(),
                              x.numel() // (3 * h * w), h * w,
                              torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"layout_parts variant {variant}: CUDA error {rc}")
        return out
    return run


def _strided(lib, pixels_a_thread: int, to_planar: bool):
    def run(x):
        h, w = (x.shape[-3], x.shape[-2]) if to_planar else (x.shape[-2], x.shape[-1])
        out = torch.empty((*x.shape[:-3], 3, h, w) if to_planar else (*x.shape[:-3], h, w, 3),
                          dtype=torch.uint8, device=x.device)
        (i_off, o_off, sizes, strides, *frame), = layout.launches(x, -1 if to_planar else -3)
        dims = (ctypes.c_int64 * (2 * len(sizes) + 5))(*sizes, *strides, *frame)
        rc = lib.layout_strided_parts(pixels_a_thread, int(to_planar), x.data_ptr() + i_off,
                                      out.data_ptr() + o_off, len(sizes), dims,
                                      torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"layout_strided_parts {pixels_a_thread}: CUDA error {rc}")
        return out
    return run


def _copy(x):
    return torch.empty_like(x).copy_(x)


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("the probe needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    build.load_library()
    print("ptxas", " | ".join(ptxas(build.last_build["log"], "layout_u8")), flush=True)
    parts = _parts()
    g = torch.Generator(device="cuda").manual_seed(25)
    for label, (shape, crop) in SHAPES.items():
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=g)
        planar = x.movedim(-1, -3).contiguous()
        if crop is not None:
            x, planar = x[..., crop[0], crop[1], :], planar[..., crop[0], crop[1]]
        for to_planar, src in ((True, x), (False, planar)):
            fns = {"kernel": layout.to_planar_u8 if to_planar else layout.from_planar_u8}
            if crop is None and shape[-3] * shape[-2] % 16 == 0:
                fns.update({k: _variant(parts, v, to_planar) for k, v in VARIANTS.items()})
            else:
                fns.update({k: _strided(parts, v, to_planar) for k, v in STRIDED.items()})
            ref = layout.to_planar_u8_ref if to_planar else layout.from_planar_u8_ref
            want = ref(src)
            for name, fn in fns.items():
                if not torch.equal(fn(src), want):
                    raise RuntimeError(f"{name} differs from the expression at {label}")
            fns["torch_expression"] = ref
            fns["copy"] = _copy
            ms = in_turns(f"{label} {'to' if to_planar else 'from'}",
                          {k: (lambda f=f: f(src)) for k, f in fns.items()})
            nbytes = 2 * src.numel()
            line = {"shape": label, "move": "to_planar" if to_planar else "from_planar",
                    "bytes_each_way": src.numel(), "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
                    "ms": ms, "tb_per_s": {k: nbytes / (v * 1e-3) / 1e12 for k, v in ms.items()},
                    "card": smi}
            print(json.dumps(line), flush=True)
            del want
        del x, planar
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
