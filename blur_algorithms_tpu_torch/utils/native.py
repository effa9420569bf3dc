"""ctypes bindings to the native host runtime (``native/libblurfx.so``).

The port of the JAX package's ``utils/native.py``, over the same library,
which lives at the repository root outside both packages and is built
from ``native/blurfx.cpp`` by ``native/Makefile`` (``make -C native``).
The card owns the device compute; these routines cover the host data path
the reference also kept native (SURVEY.md §2 mapping): threaded
planar<->interleaved conversion with the exact +0.5 rounding, reflect-101
padding (``models.BlurPipeline.stream``'s stager pads each frame with it)
and CRC-32 parity checks. Every entry point has the same NumPy path as in
JAX where the library is absent; that is host code in both packages, not a
substitute for a device kernel.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

__all__ = [
    "available",
    "build",
    "deinterleave",
    "interleave",
    "reflect101_u8",
    "crc32",
]

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
    "libblurfx.so",
)

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    i64, u8p, f32p, u32 = (
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_uint32,
    )
    lib.blurfx_deinterleave_u8_f32.argtypes = [u8p, f32p, i64, i64, i64]
    lib.blurfx_interleave_f32_u8.argtypes = [f32p, u8p, i64, i64, i64]
    lib.blurfx_reflect101_u8.argtypes = [u8p, u8p] + [i64] * 7
    lib.blurfx_crc32.argtypes = [u8p, i64, u32]
    lib.blurfx_crc32.restype = u32
    lib.blurfx_version.restype = ctypes.c_int
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def build() -> bool:
    """Compile the native library in place (requires g++). Returns success."""
    import subprocess

    root = os.path.dirname(_LIB_PATH)
    proc = subprocess.run(["make", "-C", root], capture_output=True, text=True)
    global _lib
    _lib = None
    return proc.returncode == 0 and _load() is not None


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def deinterleave(img_hwc: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 -> (C, H, W) float32 (threaded native, NumPy fallback)."""
    img_hwc = np.ascontiguousarray(img_hwc, dtype=np.uint8)
    h, w, c = img_hwc.shape
    lib = _load()
    if lib is None:
        return np.moveaxis(img_hwc, -1, 0).astype(np.float32)
    out = np.empty((c, h, w), dtype=np.float32)
    lib.blurfx_deinterleave_u8_f32(_u8p(img_hwc), _f32p(out), h, w, c)
    return out


def interleave(planar_chw: np.ndarray) -> np.ndarray:
    """(C, H, W) float32 -> (H, W, C) uint8 with +0.5 rounding."""
    planar_chw = np.ascontiguousarray(planar_chw, dtype=np.float32)
    c, h, w = planar_chw.shape
    lib = _load()
    if lib is None:
        merged = np.moveaxis(planar_chw, 0, -1)
        return np.clip(np.floor(merged + 0.5), 0, 255).astype(np.uint8)
    out = np.empty((h, w, c), dtype=np.uint8)
    lib.blurfx_interleave_f32_u8(_f32p(planar_chw), _u8p(out), h, w, c)
    return out


def reflect101_u8(img_hwc: np.ndarray, pads) -> np.ndarray:
    """Reflect-101 pad (H, W, C) uint8; ``pads = ((top, bottom), (left, right))``."""
    img_hwc = np.ascontiguousarray(img_hwc, dtype=np.uint8)
    h, w, c = img_hwc.shape
    (pt, pb), (pl, pr) = pads
    lib = _load()
    if lib is None:
        from blur_algorithms_tpu_torch.oracle import reflect_101_np

        return reflect_101_np(img_hwc, [(pt, pb), (pl, pr)], axes=[0, 1])
    out = np.empty((h + pt + pb, w + pl + pr, c), dtype=np.uint8)
    lib.blurfx_reflect101_u8(_u8p(img_hwc), _u8p(out), h, w, c, pt, pb, pl, pr)
    return out


def crc32(*buffers: np.ndarray) -> int:
    """CRC-32 (poly 0xEDB88320) over buffers, native or NumPy."""
    lib = _load()
    if lib is None:
        from blur_algorithms_tpu_torch.oracle import crc32c

        return crc32c(*buffers)
    crc = 0
    for buf in buffers:
        flat = np.ascontiguousarray(buf).view(np.uint8).ravel()
        crc = int(lib.blurfx_crc32(_u8p(flat), flat.size, crc))
    return crc
