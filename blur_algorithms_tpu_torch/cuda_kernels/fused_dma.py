"""Fused separable blur of uint8 planes (K1): the int8, hybrid and bf16
rungs of the precision ladder.

The port of the JAX package's ``pallas_kernels/fused_dma.py``:
``blur_fused_u8_dma`` there runs the Pallas kernel ``_kernel_direct`` with
one of its tile bodies; here each rung launches a CUDA kernel of
``csrc/fused_dma.cu`` on a CUDA tensor and runs its plain PyTorch version on
a CPU tensor:

- int8 (``_rows_int8`` / ``_cols_int8``): ``blur_fused_u8_dma``, plain
  version ``blur_fused_u8_dma_ref``. Both compute the JAX kernel's integers
  exactly and round its f32 epilogue the same way, so all three agree bit
  for bit.
- hybrid (``_tile_hybrid``): the exact int8 rows sum ``R``, ``y =
  bf16(f32(R))``, one f32 sum of ``bf16(c_t) * y`` per output in ascending
  tap order, and one fused ``fma(acc, 1 / (127 * 2^s), 128)``:
  ``blur_fused_u8_hybrid``, plain version ``blur_fused_u8_hybrid_ref``.
- bf16 (``_tile_bf16``): ``y = bf16(sum bf16(r_t) * x)``, then ``sum
  bf16(c_t) * y``, both f32 sums in ascending tap order, no epilogue:
  ``blur_fused_u8_bf16``, plain version ``blur_fused_u8_bf16_ref``.

A bf16 product is exact in f32, so a sum taken in the same order is the same
number: the kernels equal their plain versions bit for bit, and the plain
versions equal the JAX bodies in interpret mode wherever XLA's CPU dot sums
in ascending order (short contractions; past those, one rounding of the
sum may differ).

The JAX kernel contracts every window with band matrices. Every column of a
band matrix holds the same tap vector, shifted, so the band dots are 1-D
correlations with one tap vector per axis: ``int8_operands``,
``hybrid_operands`` and ``bf16_operands`` yield those vectors.

The bf16x3 tile body has the numerics of the blocked kernel
``fused_blur._kernel`` and runs as K2 (``cuda_kernels/fused_blur.py``). The
other forms of the JAX kernel (strip, assemble, rows-resident, pipelined)
and the multi-chip haloed entry point are queued in ROADMAP.md.
``MAX_RADIUS`` (600, the JAX int8 DMA form's domain) bounds K1 and K2
alike; past it ``blur_fused_u8`` runs the two-pass split, whose int8 forms
(``cuda_kernels/fused_split.py``) share ``int8_rows_ref`` /
``int8_cols_ref`` with K1's plain version here.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from blur_algorithms_tpu_torch.cuda_kernels.fused_blur import (
    MAX_RADIUS,
    _quantize_band_int8,
    int8_applicable,
    pick_int8_scale,
)
from blur_algorithms_tpu_torch.ops.band_matmul import band_block_matrix
from blur_algorithms_tpu_torch.ops.pad import reflect_101
from blur_algorithms_tpu_torch.ops.plan import BlurPlan

__all__ = [
    "Bf16Operands",
    "HybridOperands",
    "Int8Operands",
    "MAX_RADIUS",
    "bf16_operands",
    "blur_fused_u8_bf16",
    "blur_fused_u8_bf16_ref",
    "blur_fused_u8_dma",
    "blur_fused_u8_dma_ref",
    "blur_fused_u8_hybrid",
    "blur_fused_u8_hybrid_ref",
    "dma_form_applicable",
    "hybrid_operands",
    "int8_operands",
]

@dataclasses.dataclass(frozen=True)
class Int8Operands:
    """Integer operands of the int8 pipeline for one plan."""

    q_row: np.ndarray  # int32 (2rw + 1,): rows taps at scale 2^rows_shift
    q_col: np.ndarray  # int32 (2rh + 1,): cols taps at scale cols_scale
    rows_shift: int  # E = (R + 2^(s-1)) >> s
    cols_scale: int

    def epilogue_constants(self) -> tuple[np.float32, np.float32, np.float32]:
        return epilogue_constants(self.cols_scale)


def epilogue_constants(cols_scale: int) -> tuple[np.float32, np.float32, np.float32]:
    """``(c1, c2, c3)`` of ``y = p1*c1 + p23*c2 + p4*c3 + 128``: the JAX
    kernel's Python-float products, each rounded once to float32."""
    inv = 1.0 / (127.0 * cols_scale)
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


@dataclasses.dataclass(frozen=True)
class HybridOperands:
    """Operands of the hybrid rung for one plan."""

    q_row: np.ndarray  # int32 (2rw + 1,): the int8 rows taps, as for int8
    rows_shift: int  # the rows scale is 127 * 2^rows_shift
    c_col: np.ndarray  # float32 (2rh + 1,): bf16-rounded column taps

    @property
    def scale(self) -> np.float32:
        """The epilogue's ``f32(1 / (127 * 2^rows_shift))`` (cols scale 1)."""
        return np.float32(1.0 / (127.0 * float(1 << self.rows_shift)))


@dataclasses.dataclass(frozen=True)
class Bf16Operands:
    """Operands of the bf16 rung: bf16-rounded taps, as float32."""

    c_row: np.ndarray  # (2rw + 1,)
    c_col: np.ndarray  # (2rh + 1,)


def _bf16_taps(taps: np.ndarray) -> np.ndarray:
    """The hi half of the JAX band operand: each f32 tap rounded to bf16
    (to nearest, ties to even), as float32."""
    t = torch.from_numpy(np.ascontiguousarray(taps, dtype=np.float32))
    return t.to(torch.bfloat16).to(torch.float32).numpy()


@functools.lru_cache(maxsize=64)
def hybrid_operands(plan: BlurPlan) -> HybridOperands:
    """The hybrid branch of the JAX ``_band_operands``, as tap vectors."""
    ops = int8_operands(plan)
    return HybridOperands(q_row=ops.q_row, rows_shift=ops.rows_shift,
                          c_col=_bf16_taps(plan.col.taps))


@functools.lru_cache(maxsize=64)
def bf16_operands(plan: BlurPlan) -> Bf16Operands:
    """The bf16 branch of the JAX ``_band_operands`` (its hi halves), as tap
    vectors."""
    return Bf16Operands(c_row=_bf16_taps(plan.row.taps),
                        c_col=_bf16_taps(plan.col.taps))


def dma_form_applicable(dtype: torch.dtype, plan: BlurPlan,
                        precision: str = "int8") -> bool:
    """True where K1's ``precision`` body serves a plan on ``dtype`` planes
    (the JAX ``dma_form_applicable`` without its TPU memory model): uint8,
    both support radii >= 1 and at most ``MAX_RADIUS``; int8 and hybrid
    also need non-negative unit-sum taps (``int8_applicable``)."""
    if precision not in ("int8", "hybrid", "bf16") or dtype != torch.uint8:
        return False
    rh, rw = plan.col.support_radius, plan.row.support_radius
    if min(rh, rw) < 1 or max(rh, rw) > MAX_RADIUS:
        return False
    return precision == "bf16" or int8_applicable(plan, torch.uint8)


def check_domain(plan: BlurPlan) -> None:
    """Raise ``NotImplementedError`` for a plan the int8 kernel does not
    serve (each case names the ROADMAP.md item that will port it)."""
    rh, rw = plan.col.support_radius, plan.row.support_radius
    if rh == 0 or rw == 0:
        raise NotImplementedError(
            "K1 does not serve a radius-0 axis: blur_fused_u8 routes it to "
            "K2 (cuda_kernels/fused_blur.py)"
        )
    if not int8_applicable(plan, torch.uint8):
        raise NotImplementedError(
            "K1 does not serve signed or non-normalised taps: blur_fused_u8 "
            "routes them to K2, the bf16x3 rung (cuda_kernels/fused_blur.py)"
        )
    if max(rh, rw) > MAX_RADIUS:
        raise NotImplementedError(
            f"support radius {max(rh, rw)} > {MAX_RADIUS} is past K1's domain: "
            "blur_fused_u8 routes it to the two-pass split "
            "(cuda_kernels/fused_blur.py, fused_split.py)"
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
    r = int8_rows_ref(reflect_101(x, [(rh, rh), (rw, rw)]), ops.q_row, w)
    s = ops.rows_shift
    e = (r + (1 << (s - 1))) >> s
    del r
    y = int8_cols_ref(e, ops.q_col, ops.epilogue_constants(), h)
    return store_u8_ref(y).reshape(planar_u8.shape)


def _check_rung(planar_u8: torch.Tensor, plan: BlurPlan, precision: str) -> None:
    _check_planar(planar_u8, plan)
    if not dma_form_applicable(torch.uint8, plan, precision):
        rh, rw = plan.col.support_radius, plan.row.support_radius
        raise ValueError(
            f"K1's {precision} body does not serve this plan (support radii "
            f"({rh}, {rw}); it needs both in 1..{MAX_RADIUS}"
            + ("" if precision == "bf16" else " and non-negative unit-sum taps")
            + ")"
        )


def bf16_round_ref(y: torch.Tensor) -> torch.Tensor:
    """float32 -> bf16 (to nearest, ties to even) -> float32."""
    return y.to(torch.bfloat16).to(torch.float32)


def bf16_correlate_ref(y: torch.Tensor, taps: np.ndarray, n: int,
                       axis: int) -> torch.Tensor:
    """``sum_t taps[t] * y[t : t + n]`` along ``axis`` in float32, tap by tap
    in ascending order. The taps and ``y`` hold bf16 values, so every
    product is exact in float32 and each step rounds only its sum, as the
    kernels' ``fmaf``."""
    acc = torch.zeros((*y.shape[:axis % y.ndim], n, *y.shape[axis % y.ndim + 1:]),
                      dtype=torch.float32, device=y.device)
    for t, c in enumerate(taps.tolist()):
        if c:
            acc = torch.add(acc, y.narrow(axis, t, n), alpha=c)
    return acc


def fma_f32_ref(a: torch.Tensor, b: float, c: float) -> torch.Tensor:
    """float32 ``fma(a, b, c)`` rounded once, as the kernels' ``__fmaf_rn``.

    ``a * b`` is exact in float64 (two 24-bit significands); the float64 sum
    with ``c`` is made round-to-odd from its exact error (TwoSum), and a
    round-to-odd float64 rounds to float32 as the exact value would."""
    p = a.to(torch.float64) * float(np.float32(b))
    c = float(np.float32(c))
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    inexact = err != 0
    bits = torch.where(inexact & ((err < 0) != (s < 0)), bits - 1, bits)
    bits = torch.where(inexact, bits | 1, bits)
    return bits.view(torch.float64).to(torch.float32)


def blur_fused_u8_hybrid_ref(planar_u8: torch.Tensor, plan: BlurPlan,
                             out_u8: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K1's hybrid body: uint8 ``(..., H, W)`` ->
    uint8, or the float32 value before the store (``out_u8=False``).

    The exact int8 rows sum ``R`` (as the int8 rung), ``y = bf16(f32(R))``,
    the bf16 column taps summed in ascending order, ``fma(acc, 1 / (127 *
    2^s), 128)``. Runs on whatever device the input lies on."""
    _check_rung(planar_u8, plan, "hybrid")
    ops = hybrid_operands(plan)
    h, w = plan.shape
    rh, rw = plan.col.support_radius, plan.row.support_radius
    x = planar_u8.reshape(-1, h, w)
    r = int8_rows_ref(reflect_101(x, [(rh, rh), (rw, rw)]), ops.q_row, w)
    y = bf16_round_ref(r.to(torch.float32))
    del r
    out = fma_f32_ref(bf16_correlate_ref(y, ops.c_col, h, -2), ops.scale, 128.0)
    return (store_u8_ref(out) if out_u8 else out).reshape(planar_u8.shape)


def blur_fused_u8_bf16_ref(planar_u8: torch.Tensor, plan: BlurPlan,
                           out_u8: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K1's bf16 body: uint8 ``(..., H, W)`` ->
    uint8, or the float32 value before the store (``out_u8=False``).

    ``y = bf16(sum bf16(r_t) * x)`` over the rows, then ``sum bf16(c_t) * y``
    over the columns, both in ascending tap order. Runs on whatever device
    the input lies on."""
    _check_rung(planar_u8, plan, "bf16")
    ops = bf16_operands(plan)
    h, w = plan.shape
    rh, rw = plan.col.support_radius, plan.row.support_radius
    x = reflect_101(planar_u8.reshape(-1, h, w), [(rh, rh), (rw, rw)])
    y = bf16_round_ref(bf16_correlate_ref(x.to(torch.float32), ops.c_row, w, -1))
    out = bf16_correlate_ref(y, ops.c_col, h, -2)
    return (store_u8_ref(out) if out_u8 else out).reshape(planar_u8.shape)


def int8_rows_ref(xp: torch.Tensor, q_row: np.ndarray, w: int) -> torch.Tensor:
    """The exact int8 rows pass on column-padded uint8 ``xp`` (``(n, m, w +
    2rw)``): ``R = sum_t q[t] * (x - 128)`` in int32, tap by tap."""
    xc = xp.to(torch.int32) - 128
    r = torch.zeros((*xc.shape[:-1], w), dtype=torch.int32, device=xc.device)
    for t, q in enumerate(q_row.tolist()):
        if q:
            r.add_(xc[..., t : t + w], alpha=q)
    return r


def store_u8_ref(y: torch.Tensor) -> torch.Tensor:
    """K1's uint8 store: ``clip(y + 0.5, 0, 255.5)``, truncated."""
    y = torch.clamp(torch.add(y, 0.5), 0.0, 255.5)
    return y.to(torch.int32).to(torch.uint8)


def int8_cols_ref(e: torch.Tensor, q_col: np.ndarray, constants, h: int) -> torch.Tensor:
    """The int8 cols pass on the row-padded intermediate ``e`` (int32
    ``(n, h + 2rh, w)``): base-128 digits, the three digit products tap by
    tap, and the f32 epilogue ``p1*c1 + p23*c2 + p4*c3 + 128`` as separate
    torch ops (so nothing can fuse a multiply into an add) -> float32."""
    n, _, w = e.shape
    dev = e.device
    e1 = (e + 64) >> 7
    e0 = e - e1 * 128
    p1, p23, p4 = (
        torch.zeros((n, h, w), dtype=torch.int32, device=dev) for _ in range(3)
    )
    for t, q in enumerate(q_col.tolist()):
        b_hi, b_lo = q >> 7, q & 127
        s1, s0 = e1[:, t : t + h], e0[:, t : t + h]
        if b_hi:
            p1.add_(s1, alpha=b_hi)
            p23.add_(s0, alpha=b_hi)
        if b_lo:
            p23.add_(s1, alpha=b_lo)
            p4.add_(s0, alpha=b_lo)

    c1, c2, c3 = (
        torch.tensor(c, dtype=torch.float32, device=dev) for c in constants
    )
    y = torch.mul(p1.to(torch.float32), c1)
    y = torch.add(y, torch.mul(p23.to(torch.float32), c2))
    y = torch.add(y, torch.mul(p4.to(torch.float32), c3))
    return torch.add(y, 128.0)


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


def _padded_f32(taps: np.ndarray) -> np.ndarray:
    out = np.zeros(-(-taps.size // 4) * 4, dtype=np.float32)
    out[: taps.size] = taps
    return out


@functools.lru_cache(maxsize=64)
def _rung_taps(plan: BlurPlan, precision: str,
               device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(row taps, column taps) in the layout of ``blur_fused_u8_bf16cols``:
    the rows as int8 hi | lo words (hybrid) or float32 (bf16), the columns
    as float32, each zero-padded to a multiple of 4."""
    if precision == "hybrid":
        ops = hybrid_operands(plan)
        rows = np.concatenate([_pack_int8_words(d.astype(np.int8))
                               for d in (ops.q_row >> 7, ops.q_row & 127)])
        cols = ops.c_col
    else:
        ops = bf16_operands(plan)
        rows, cols = _padded_f32(ops.c_row), ops.c_col
    return (torch.from_numpy(rows).to(device),
            torch.from_numpy(_padded_f32(cols)).to(device))


def _launch_rung(fn, planar_u8: torch.Tensor, plan: BlurPlan, precision: str,
                 out_u8: bool) -> torch.Tensor:
    from blur_algorithms_tpu_torch.utils.build import load_library

    name = f"K1 {precision}"
    if planar_u8.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {planar_u8.device}")
    if not planar_u8.is_contiguous():
        raise ValueError(f"{name} needs contiguous planes")
    h, w = plan.shape
    x = planar_u8.reshape(-1, h, w)
    if x.shape[0] > 65535:
        raise ValueError(f"{name} takes at most 65535 planes, got {x.shape[0]}")
    out = torch.empty(x.shape, dtype=torch.uint8 if out_u8 else torch.float32,
                      device=x.device)
    if x.shape[0] == 0:
        return out.reshape(planar_u8.shape)
    rows, cols = _rung_taps(plan, precision, x.device)
    hybrid = precision == "hybrid"
    scale = float(hybrid_operands(plan).scale) if hybrid else 1.0
    lib = load_library()
    with torch.cuda.device(x.device):
        rc = lib.blur_fused_u8_bf16cols(
            x.data_ptr(), out.data_ptr(), rows.data_ptr(), cols.data_ptr(),
            x.shape[0], h, w, plan.col.support_radius, plan.row.support_radius,
            int(not hybrid), int(out_u8), scale,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc:
        msg = lib.blur_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
    fn.launches += 1
    return out.reshape(planar_u8.shape)


def blur_fused_u8_hybrid(planar_u8: torch.Tensor, plan: BlurPlan,
                         out_u8: bool = True) -> torch.Tensor:
    """uint8 planar ``(..., H, W)`` -> uint8 (or float32 with ``out_u8=False``),
    K1's hybrid body: exact int8 rows, one bf16 column dot.

    A CUDA tensor launches ``blur_fused_u8_bf16cols`` of ``csrc/fused_dma.cu``;
    a CPU tensor runs the plain version. A plan outside the body's domain
    (``dma_form_applicable``), any other device or a non-contiguous tensor
    raises. ``blur_fused_u8_hybrid.launches`` counts kernel launches.
    """
    _check_rung(planar_u8, plan, "hybrid")
    if planar_u8.device.type == "cpu":
        return blur_fused_u8_hybrid_ref(planar_u8, plan, out_u8)
    return _launch_rung(blur_fused_u8_hybrid, planar_u8, plan, "hybrid", out_u8)


blur_fused_u8_hybrid.launches = 0


def blur_fused_u8_bf16(planar_u8: torch.Tensor, plan: BlurPlan,
                       out_u8: bool = True) -> torch.Tensor:
    """uint8 planar ``(..., H, W)`` -> uint8 (or float32 with ``out_u8=False``),
    K1's bf16 body: one bf16 dot per axis.

    A CUDA tensor launches ``blur_fused_u8_bf16cols`` of ``csrc/fused_dma.cu``;
    a CPU tensor runs the plain version; otherwise as
    ``blur_fused_u8_hybrid``. ``blur_fused_u8_bf16.launches`` counts kernel
    launches.
    """
    _check_rung(planar_u8, plan, "bf16")
    if planar_u8.device.type == "cpu":
        return blur_fused_u8_bf16_ref(planar_u8, plan, out_u8)
    return _launch_rung(blur_fused_u8_bf16, planar_u8, plan, "bf16", out_u8)


blur_fused_u8_bf16.launches = 0
