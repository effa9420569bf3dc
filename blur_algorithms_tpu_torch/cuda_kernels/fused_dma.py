"""Fused separable blur of uint8 planes, exact int8 fixed point (K1).

The port of the JAX package's ``pallas_kernels/fused_dma.py`` int8 route:
``blur_fused_u8_dma`` there runs the Pallas kernel ``_kernel_direct`` with
the ``_rows_int8`` / ``_cols_int8`` tile body; here it launches the CUDA
kernel of ``csrc/fused_dma.cu`` on a CUDA tensor, and runs the plain PyTorch
version ``blur_fused_u8_dma_ref`` on a CPU tensor. Both compute the JAX
kernel's integers exactly and round its f32 epilogue the same way, so all
three agree bit for bit.

The JAX kernel contracts every window with int8 band matrices. Every column
of a quantised band matrix holds the same integer tap vector, shifted, so
the band dots are 1-D correlations with the integer taps
``q = 128 * q_hi + q_lo``: ``int8_operands`` yields those vectors, the
requantisation shift of the rows pass and the cols scale of the epilogue.

Only the int8 rung is ported. The hybrid, bf16 and bf16x3 tile bodies, the
other forms of the JAX kernel (strip, assemble, rows-resident, pipelined)
and the multi-chip haloed entry point are queued in ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from blur_algorithms_tpu_torch.cuda_kernels.fused_blur import (
    _quantize_band_int8,
    int8_applicable,
    pick_int8_scale,
)
from blur_algorithms_tpu_torch.ops.band_matmul import band_block_matrix
from blur_algorithms_tpu_torch.ops.pad import reflect_101
from blur_algorithms_tpu_torch.ops.plan import BlurPlan

__all__ = [
    "Int8Operands",
    "MAX_RADIUS",
    "blur_fused_u8_dma",
    "blur_fused_u8_dma_ref",
    "int8_operands",
]

# Largest support radius the kernel serves: the JAX int8 DMA form's domain
# (``utils/hw.DeviceSpec.dma_max_radius`` there), so every call the port
# routes has a JAX int8 counterpart to be held against.
MAX_RADIUS = 600


@dataclasses.dataclass(frozen=True)
class Int8Operands:
    """Integer operands of the int8 pipeline for one plan."""

    q_row: np.ndarray  # int32 (2rw + 1,): rows taps at scale 2^rows_shift
    q_col: np.ndarray  # int32 (2rh + 1,): cols taps at scale cols_scale
    rows_shift: int  # E = (R + 2^(s-1)) >> s
    cols_scale: int

    def epilogue_constants(self) -> tuple[np.float32, np.float32, np.float32]:
        """``(c1, c2, c3)`` of ``y = p1*c1 + p23*c2 + p4*c3 + 128``: the JAX
        kernel's Python-float products, each rounded once to float32."""
        inv = 1.0 / (127.0 * self.cols_scale)
        return np.float32(16384.0 * inv), np.float32(128.0 * inv), np.float32(inv)


def _axis_taps(taps: np.ndarray, scale: int) -> np.ndarray:
    # one column of the band matrix carries the whole tap vector; the
    # quantiser treats every column alike, so this is each column's taps
    return _quantize_band_int8(band_block_matrix(taps, 1), scale)[:, 0]


@functools.lru_cache(maxsize=64)
def int8_operands(plan: BlurPlan) -> Int8Operands:
    """The int8 branch of the JAX ``_band_operands``, as tap vectors."""
    rows_scale = pick_int8_scale(plan.row.taps, pow2=True)
    cols_scale = pick_int8_scale(plan.col.taps)
    return Int8Operands(
        q_row=_axis_taps(plan.row.taps, rows_scale),
        q_col=_axis_taps(plan.col.taps, cols_scale),
        rows_shift=7 + (rows_scale // (127 * 128)).bit_length() - 1,
        cols_scale=cols_scale,
    )


def check_domain(plan: BlurPlan) -> None:
    """Raise ``NotImplementedError`` for a plan the int8 kernel does not
    serve (each case names the ROADMAP.md item that will port it)."""
    rh, rw = plan.col.support_radius, plan.row.support_radius
    if rh == 0 or rw == 0:
        raise NotImplementedError(
            "a radius-0 axis is served by the JAX blocked kernel (K2), "
            "not ported yet (ROADMAP.md Queue 2, K2)"
        )
    if not int8_applicable(plan, torch.uint8):
        raise NotImplementedError(
            "signed or non-normalised taps need the bf16x3 body "
            "(ROADMAP.md Queue 2, K1 hybrid/bf16x3 bodies)"
        )
    if max(rh, rw) > MAX_RADIUS:
        raise NotImplementedError(
            f"support radius {max(rh, rw)} > {MAX_RADIUS} needs the wide-radius "
            "split form (ROADMAP.md Queue 1 item 6, K2)"
        )


def _check_planar(planar_u8: torch.Tensor, plan: BlurPlan) -> None:
    if planar_u8.dtype != torch.uint8:
        raise TypeError(f"expected uint8 planes, got {planar_u8.dtype}")
    if planar_u8.ndim < 2 or tuple(planar_u8.shape[-2:]) != plan.shape:
        raise ValueError(
            f"planes of shape {tuple(planar_u8.shape)} do not match the "
            f"plan's {plan.shape}"
        )


def blur_fused_u8_dma_ref(planar_u8: torch.Tensor, plan: BlurPlan) -> torch.Tensor:
    """Plain PyTorch version of K1: uint8 ``(..., H, W)`` -> uint8.

    Reflect-101 gather, then the exact integer sums tap by tap, then the
    same digit split and f32 epilogue as separate torch ops (so nothing can
    fuse a multiply into an add). Runs on whatever device the input lies on.
    """
    _check_planar(planar_u8, plan)
    check_domain(plan)
    ops = int8_operands(plan)
    h, w = plan.shape
    rh, rw = plan.col.support_radius, plan.row.support_radius
    x = planar_u8.reshape(-1, h, w)
    n, dev = x.shape[0], x.device
    xc = reflect_101(x, [(rh, rh), (rw, rw)]).to(torch.int32) - 128

    r = torch.zeros((n, h + 2 * rh, w), dtype=torch.int32, device=dev)
    for t, q in enumerate(ops.q_row.tolist()):
        if q:
            r.add_(xc[:, :, t : t + w], alpha=q)
    del xc
    s = ops.rows_shift
    e = (r + (1 << (s - 1))) >> s
    del r
    e1 = (e + 64) >> 7
    e0 = e - e1 * 128
    del e

    p1, p23, p4 = (
        torch.zeros((n, h, w), dtype=torch.int32, device=dev) for _ in range(3)
    )
    for t, q in enumerate(ops.q_col.tolist()):
        b_hi, b_lo = q >> 7, q & 127
        s1, s0 = e1[:, t : t + h], e0[:, t : t + h]
        if b_hi:
            p1.add_(s1, alpha=b_hi)
            p23.add_(s0, alpha=b_hi)
        if b_lo:
            p23.add_(s1, alpha=b_lo)
            p4.add_(s0, alpha=b_lo)

    c1, c2, c3 = (
        torch.tensor(c, dtype=torch.float32, device=dev)
        for c in ops.epilogue_constants()
    )
    y = torch.mul(p1.to(torch.float32), c1)
    y = torch.add(y, torch.mul(p23.to(torch.float32), c2))
    y = torch.add(y, torch.mul(p4.to(torch.float32), c3))
    y = torch.add(y, 128.0)
    y = torch.clamp(torch.add(y, 0.5), 0.0, 255.5)
    return y.to(torch.int32).to(torch.uint8).reshape(planar_u8.shape)


def _pack_int8_words(taps: np.ndarray) -> np.ndarray:
    """int8 taps -> int32 words of four, zero-padded, tap 4k+u in byte u."""
    padded = np.zeros(-(-taps.size // 4) * 4, dtype=np.int8)
    padded[: taps.size] = taps
    return padded.view("<i4").astype(np.int32)


@functools.lru_cache(maxsize=64)
def _device_taps(plan: BlurPlan, device: torch.device) -> torch.Tensor:
    # the kernel's layout: rows hi | rows lo | cols hi | cols lo digits
    ops = int8_operands(plan)
    words = np.concatenate([
        _pack_int8_words(digits.astype(np.int8))
        for q in (ops.q_row, ops.q_col) for digits in (q >> 7, q & 127)
    ])
    return torch.from_numpy(words).to(device)


def blur_fused_u8_dma(planar_u8: torch.Tensor, plan: BlurPlan) -> torch.Tensor:
    """uint8 planar ``(..., H, W)`` -> uint8, fused int8 blur (K1).

    A CUDA tensor launches the kernel of ``csrc/fused_dma.cu``; a CPU tensor
    runs the plain version. Any other device, a non-contiguous tensor or a
    plan outside the kernel's domain raises. ``blur_fused_u8_dma.launches``
    counts kernel launches.
    """
    _check_planar(planar_u8, plan)
    check_domain(plan)
    if planar_u8.device.type == "cpu":
        return blur_fused_u8_dma_ref(planar_u8, plan)
    if planar_u8.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, not {planar_u8.device}")
    if not planar_u8.is_contiguous():
        raise ValueError("K1 needs contiguous planes")
    from blur_algorithms_tpu_torch.utils.build import load_library

    h, w = plan.shape
    x = planar_u8.reshape(-1, h, w)
    if x.shape[0] > 65535:
        raise ValueError(f"K1 takes at most 65535 planes, got {x.shape[0]}")
    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out.reshape(planar_u8.shape)
    ops = int8_operands(plan)
    taps = _device_taps(plan, x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        rc = lib.blur_fused_u8_int8(
            x.data_ptr(), out.data_ptr(), taps.data_ptr(),
            x.shape[0], h, w, plan.col.support_radius, plan.row.support_radius,
            ops.rows_shift, *map(float, ops.epilogue_constants()),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc:
        msg = lib.blur_cuda_error_string(rc).decode()
        raise RuntimeError(f"K1 launch failed: CUDA error {rc} ({msg})")
    blur_fused_u8_dma.launches += 1
    return out.reshape(planar_u8.shape)


blur_fused_u8_dma.launches = 0
