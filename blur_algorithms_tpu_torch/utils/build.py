"""Build the package's CUDA sources with ``nvcc`` at first use, load with ctypes.

Every ``csrc/*.cu`` file is compiled on its own, all of them at once (one
``nvcc`` process per source), and the objects are linked into one shared
library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
         -Xcompiler -fPIC --fmad=false -Xptxas -v   (each source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared   (the link)

``--fmad=false`` keeps nvcc from contracting ``a * b + c`` into one fused
multiply-add where the source does not ask for one: the kernels spell each
epilogue's roundings out (``__fmaf_rn`` where XLA contracts the JAX
kernel's expression, ``__fmul_rn`` / ``__fadd_rn`` elsewhere), so they
round as the JAX kernels do. The library goes to ``build/`` at the repository root under
a name keyed by a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is; nvcc's output (ptxas's
register and spill lines) is kept beside it as ``<library>.log``, so a
process that finds the library built reads the same lines. Nothing here
runs at import time.

The probes (``csrc/probes/*.cu``: B1-B3, the ``benchmarks`` package) build
the same way into a second library, ``load_probe_library``, keyed by their
sources and the two they include, ``csrc/fft4step.cu`` (the ablation probe)
and ``csrc/fused_dma.cu`` (K1's loaders); the kernel library neither holds
nor waits for them.
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

__all__ = ["NVCC_FLAGS", "build_dir", "last_build", "last_probe_build", "load_library",
           "load_probe_library"]

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "--fmad=false", "-Xptxas", "-v",
)
_LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_PKG = pathlib.Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"

# the loaded libraries, and what building each printed (ptxas register and
# shared-memory counts) and cost; filled by ``load_library`` and
# ``load_probe_library``
_lib: ctypes.CDLL | None = None
_probe_lib: ctypes.CDLL | None = None
last_build: dict = {}
last_probe_build: dict = {}


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
    lib.blur_fused_u8_k1.argtypes = [
        i, i, i,  # form, body, out_u8
        vp, vp, vp, vp,  # x, out, taps_i, taps_f
        i, i, i, i, i,  # planes, h, w, rh, rw
        i, i, i, i, i, i,  # th, tw, seg, slots, xh, xw
        i, i,  # smem, rows_shift
        f, f, f, f,  # epilogue constants c1, c2, c3; the hybrid scale
        vp,  # stream
    ]
    lib.blur_fused_u8_k1.restype = i
    lib.assemble_padded_u8.argtypes = [
        vp, vp,  # x, out
        i, i, i, i, i,  # planes, h, w, rh, rw
        i, i, i, i,  # orh, orw, hp, wp
        vp,  # stream
    ]
    lib.assemble_padded_u8.restype = i
    lib.assemble_padded_prepad_u8.argtypes = [
        vp, vp,  # x, out
        i, i, i, i,  # planes, hs, w, rw
        i, i, i,  # orw, hp, wp
        vp,  # stream
    ]
    lib.assemble_padded_prepad_u8.restype = i
    lib.assemble_padded_prepad_rows_u8.argtypes = [
        vp, i, i,  # out, planes, nseg
        ctypes.c_char_p,  # the segments: 5 int64 each (x, plane stride, row stride, rows, reversed)
        i, i, i, i, i,  # w, rw, orw, hp, wp
        i, vp,  # device, stream
    ]
    lib.assemble_padded_prepad_rows_u8.restype = i
    lib.blur_fused_f32.argtypes = [
        vp, vp, vp, vp,  # x, out, taps_row, taps_col
        i, i, i,  # in_u8, out_u8, pre_padded_col
        i, i, i, i, i,  # planes, h, w, rh, rw
        vp,  # stream
    ]
    lib.blur_fused_f32.restype = i
    lib.blur_fused_axis_f32.argtypes = [
        vp, vp, vp,  # x, out, taps
        i, i, i,  # in_u8, out_u8, pre_padded_col
        i, i, i, i, i,  # planes, h, w, axis, r
        vp,  # stream
    ]
    lib.blur_fused_axis_f32.restype = i
    lib.fused_split_rows_int8.argtypes = [
        vp, vp, vp,  # x, out, taps
        i, i, i, i,  # planes, h, w, rw
        i, i, f,  # out_e32, rows_shift, inv_scale
        vp,  # stream
    ]
    lib.fused_split_rows_int8.restype = i
    lib.fused_split_cols_int8.argtypes = [
        vp, vp, vp,  # e, out, taps
        i, i, i, i,  # planes, h, w, rh
        i, i, f, f, f,  # out_u8, pre_padded_col, epilogue constants c1, c2, c3
        vp,  # stream
    ]
    lib.fused_split_cols_int8.restype = i
    lib.fused_split_cols_hybrid.argtypes = [
        vp, vp, vp,  # e, out, taps
        i, i, i, i,  # planes, h, w, rh
        i, i, f,  # out_u8, pre_padded_col, scale
        vp,  # stream
    ]
    lib.fused_split_cols_hybrid.restype = i
    lib.box_scan_axis.argtypes = [
        vp, vp, vp, vp,  # x, out, scratch0, scratch1
        i, i,  # in_u8, out_u8
        i, i, i, i, i, i,  # planes, h, w, axis, r, passes
        i, i,  # tile, scratch_len
        vp,  # stream
    ]
    lib.box_scan_axis.restype = i
    lib.fft_conv_rows.argtypes = [
        vp, vp, vp, vp,  # x, out, twiddle tables, spectrum
        i, i, i,  # complex_h, rows, n
        vp,  # stream
    ]
    lib.fft_conv_rows.restype = i
    lib.fft_conv_rows_framed.argtypes = [
        vp, vp, vp, vp,  # x, out, twiddle tables, spectrum
        i, i, i, i, i,  # complex_h, rows, n, dim, pad
        vp,  # stream
    ]
    lib.fft_conv_rows_framed.restype = i
    lib.fft_conv_rows_staged.argtypes = [
        vp, vp, vp, vp,  # x, out, twiddle tables, spectrum
        i, i, i, i, i, i,  # complex_h, rows, n, dim, pad, framed
        vp, vp,  # scratch, stream
    ]
    lib.fft_conv_rows_staged.restype = i
    lib.fft_conv_rows_cluster_occupancy.argtypes = [i, i, ctypes.POINTER(i)]  # n, framed
    lib.fft_conv_rows_cluster_occupancy.restype = i
    lib.spectral_multiply_2d.argtypes = [
        vp, vp, vp, vp,  # spec, out, col, row
        f, i, i, i,  # scale, planes, h, wf
        i, i,  # grid_x, grid_y
        vp,  # stream
    ]
    lib.spectral_multiply_2d.restype = i
    lib.blur_cuda_error_string.argtypes = [i]
    lib.blur_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _declare_probes(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.mma_rate_clusters.argtypes = [i, i, i, i, i, ctypes.POINTER(i)]
    lib.mma_rate_clusters.restype = i
    lib.mma_rate_maps.argtypes = [vp, vp, i, i, i, vp]  # a, bt, rows, kb, np, maps
    lib.mma_rate_maps.restype = i
    lib.mma_rate_chain.argtypes = [
        i, i, i,  # wgmma, bf16, resident
        vp, vp,  # maps, out
        i, i, i, i, i,  # m, k, kb, np, kk
        i, i, i, i, i,  # panels, inner, steps, cluster, grid
        vp,  # stream
    ]
    lib.mma_rate_chain.restype = i
    lib.fft_conv_rows_ablation.argtypes = [
        i, i,  # mask, framed
        vp, vp, vp, vp,  # x, out, twiddle tables, spectrum
        i, i, i, i, i,  # complex_h, rows, n, dim, pad
        vp,  # stream
    ]
    lib.fft_conv_rows_ablation.restype = i
    lib.fft_cluster_ablation.argtypes = [
        i, i,  # variant, framed
        vp, vp, vp, vp,  # x, out, twiddle tables, spectrum
        i, i, i, i, i,  # complex_h, rows, n, dim, pad
        vp,  # stream
    ]
    lib.fft_cluster_ablation.restype = i
    lib.fft_cluster_current_ablation.argtypes = [
        i, i, vp, vp, vp, vp,  # variant, framed, x, out, twiddle tables, spectrum
        i, i, i, i, i,  # complex_h, rows, n, dim, pad
        vp,  # stream
    ]
    lib.fft_cluster_current_ablation.restype = i
    lib.fft_cluster_other_segment.argtypes = [
        i, vp, vp, vp, vp,  # framed, x, out, twiddle tables, spectrum
        i, i, i, i, i,  # complex_h, rows, n, dim, pad
        vp,  # stream
    ]
    lib.fft_cluster_other_segment.restype = i
    lib.fft_cluster_ablation_occupancy.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.fft_cluster_ablation_occupancy.restype = i  # variant, n, framed, clusters
    lib.fft_staged_yardstick.argtypes = [
        i, vp, vp, vp, vp,  # framed, x, out, twiddle tables, spectrum
        i, i, i, i, i,  # complex_h, rows, n, dim, pad
        vp, vp,  # scratch, stream
    ]
    lib.fft_staged_yardstick.restype = i
    lib.fetch_windows.argtypes = [
        i, vp, vp,  # tma, x, out
        i, i, i, i, i, i, i, i, i,  # planes, hp, pitch, width, stride, nwin, chunk_rows, g, smem
        vp,  # stream
    ]
    lib.fetch_windows.restype = i
    lib.fetch_k1.argtypes = [
        i, vp, vp,  # assembled, x, out
        i, i, i, i, i, i, i,  # planes, h, w, th, tw, rh, rw
        i, i, i, i,  # xh, xw, slots, smem
        vp,  # stream
    ]
    lib.fetch_k1.restype = i
    return lib


def _run(cmd: list[str], proc: subprocess.Popen) -> str:
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}{err}"
        )
    return out + err


def _log_path(target: pathlib.Path) -> pathlib.Path:
    """Where the build of library ``target`` keeps what nvcc printed."""
    return target.with_suffix(".log")


def _compile_and_link(sources: list[pathlib.Path], out_dir: pathlib.Path,
                      target: pathlib.Path) -> str:
    """One nvcc per source, all started together, then one link. Builds in
    a private directory and renames the log (``_log_path``) and then the
    library into place: a concurrent process sees either no library or a
    whole one with its log."""
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        nvcc = _nvcc()
        jobs = []
        for src in sources:
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", f"{tmp}/{src.stem}.o", str(src)]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        try:
            log = "".join(_run(cmd, proc) for cmd, proc in jobs)
        finally:
            for _, proc in jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        lib = f"{tmp}/lib.so"
        cmd = [nvcc, *_LINK_FLAGS, "-o", lib, *(f"{tmp}/{s.stem}.o" for s in sources)]
        log += _run(cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        pathlib.Path(f"{tmp}/lib.log").write_text(log)
        os.replace(f"{tmp}/lib.log", _log_path(target))
        os.replace(lib, target)
    return log


def _build_and_load(sources: list[pathlib.Path], hashed: list[pathlib.Path],
                    stem: str, record: dict) -> ctypes.CDLL:
    """Build ``sources`` into ``build/<stem>_<hash>.so`` unless a library of
    the same flags and ``hashed`` sources is there, record the build in
    ``record`` (its ``log`` the nvcc output kept beside the library, where
    another process built it too) and load it."""
    if not sources:
        raise RuntimeError(f"no CUDA sources for {stem}")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in hashed:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    target = out_dir / f"{stem}_{digest.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    built = not target.exists()
    if built:
        log = _compile_and_link(sources, out_dir, target)
    else:
        log = _log_path(target).read_text() if _log_path(target).exists() else ""
    record.update(
        library=str(target), built=built, seconds=time.perf_counter() - t0,
        log=log,
    )
    return ctypes.CDLL(str(target))


def load_library() -> ctypes.CDLL:
    """Build (if the sources changed) and load the kernel library."""
    global _lib
    if _lib is None:
        sources = sorted(_CSRC.glob("*.cu"))
        _lib = _declare(_build_and_load(sources, sources, "libblur_kernels", last_build))
    return _lib


def load_probe_library() -> ctypes.CDLL:
    """Build (if the sources changed) and load the probes' library."""
    global _probe_lib
    if _probe_lib is None:
        sources = sorted((_CSRC / "probes").glob("*.cu"))
        _probe_lib = _declare_probes(_build_and_load(
            sources, [*sources, _CSRC / "fft4step.cu", _CSRC / "fused_dma.cu"], "libblur_probes",
            last_probe_build))
    return _probe_lib
