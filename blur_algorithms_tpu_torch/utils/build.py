"""Build the package's CUDA sources with ``nvcc`` at first use, load with ctypes.

Every ``csrc/*.cu`` file is compiled into one shared library with a plain C
interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC --fmad=false -Xptxas -v

``--fmad=false`` keeps nvcc from contracting ``a * b + c`` into one fused
multiply-add, which would round differently from the JAX kernel's f32
epilogue (the kernels also spell their epilogues with ``__fmul_rn`` /
``__fadd_rn``). The library goes to ``build/`` at the repository root under
a name keyed by a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

__all__ = ["NVCC_FLAGS", "build_dir", "load_library", "last_build"]

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "--fmad=false", "-Xptxas", "-v",
)

_PKG = pathlib.Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"

# the loaded library, and what building it printed (ptxas register and
# shared-memory counts) and cost; filled by ``load_library``
_lib: ctypes.CDLL | None = None
last_build: dict = {}


def build_dir() -> pathlib.Path:
    """``build/`` at the repository root (beside the package)."""
    return _PKG.parent / "build"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (pathlib.Path(root) / "bin" / "nvcc").exists():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.blur_fused_u8_int8.argtypes = [
        vp, vp, vp,  # x, out, taps
        i, i, i, i, i, i,  # planes, h, w, rh, rw, rows_shift
        f, f, f,  # epilogue constants c1, c2, c3
        vp,  # stream
    ]
    lib.blur_fused_u8_int8.restype = i
    lib.blur_cuda_error_string.argtypes = [i]
    lib.blur_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load_library() -> ctypes.CDLL:
    """Build (if the sources changed) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(_CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {_CSRC}")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    target = out_dir / f"libblur_kernels_{digest.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    log = ""
    built = not target.exists()
    if built:
        # build into a private file, then rename: a concurrent process sees
        # either no library or a whole one
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        try:
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}"
                )
            os.replace(tmp, target)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    last_build.update(
        library=str(target), built=built, seconds=time.perf_counter() - t0,
        log=log,
    )
    _lib = _declare(ctypes.CDLL(str(target)))
    return _lib
