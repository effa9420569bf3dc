"""Fused separable blur of uint8 planes (K1): the int8, hybrid and bf16
rungs of the precision ladder, in K1's five staging forms.

The port of the JAX package's ``pallas_kernels/fused_dma.py``:
``_blur_fused_dma_impl`` there runs one of its Pallas kernels with one of
its tile bodies; here ``blur_fused_u8_dma`` does the same with the kernels
of ``csrc/fused_dma.cu`` on a CUDA tensor, and runs the body's plain
PyTorch version on a CPU tensor. The three bodies are band products on
the tensor cores, as the JAX bodies are band matmuls on the MXU
(``tc_layout`` sizes their blocks). The bodies:

- int8 (``_rows_int8`` / ``_cols_int8``), plain version
  ``blur_fused_u8_dma_ref``. Both compute the JAX kernel's integers
  exactly and round its f32 epilogue the same way, so the two agree bit
  for bit, and with the JAX kernel in interpret mode, in the uint8 store
  and in the f32 one (``out_u8=False``, the epilogue's value before
  ``floor(y + 0.5)``, which the sharded path's float output asks for).
  The uint8 store rounds each product and sum of the epilogue on its own,
  as it has since K1's first port; the f32 store contracts two
  multiply-adds, as XLA compiles the JAX expression on an FMA host
  (``int8_cols_ref``).
- hybrid (``_tile_hybrid``): the exact int8 rows sum ``R``, ``y =
  bf16(f32(R))``, an f32 sum of ``bf16(c_t) * y`` per output, and one fused
  ``fma(acc, 1 / (127 * 2^s), 128)``; plain version
  ``blur_fused_u8_hybrid_ref``, which sums tap by tap in ascending order.
  The kernel sums each output's taps on the tensor cores in the aligned
  groups of 16 of its own tap index, in ascending group order, whatever
  the form, tile or shard origin: every form is bit-identical to the
  direct form, K1a on the sharded path's caller rows to the single-card
  call, and all within 2e-2 at 0..255 scale (f32 store) and 1 count
  (uint8 store) of the plain version.
- bf16 (``_tile_bf16``): ``y = bf16(sum bf16(r_t) * x)``, then ``sum
  bf16(c_t) * y``, no epilogue; plain version ``blur_fused_u8_bf16_ref``
  (both f32 sums in ascending tap order). The kernel takes both sums on
  bf16 tensor cores, the rows sum in k-steps of 16 window bytes aligned to
  the image row, the column sum as the hybrid's: its forms are
  bit-identical to each other, and within ``bf16_bound`` of the plain
  version (derived at ``blur_fused_u8_bf16``).

The forms (``k1_geometry`` sizes each; one wrapper and launch count each):

- direct (``_kernel_direct``): one block per output tile stages its
  window (16-byte copies, mirrored edge words, reflect-101 rows);
  ``blur_fused_u8_dma`` (int8), ``blur_fused_u8_hybrid``,
  ``blur_fused_u8_bf16``;
- strip (``_kernel_strip``): one block per row strip walks its windows,
  each input byte read once; ``blur_fused_u8_strip``;
- assembled (``_kernel``): windows are plain rectangles of A5's padded
  frame (``assemble.py``); ``blur_fused_u8_assembled``, and
  ``blur_fused_u8_pipelined`` (``_kernel_pipe``, int8: window j's rows
  pass beside window j-1's cols pass); plain version
  ``blur_fused_u8_padded_ref``;
- resident (``_kernel_resident``): one block per column window walks down
  the frame with the rows output in a ring, each rows value computed once;
  ``blur_fused_u8_resident`` (int8, hybrid).

Every form computes K1's function from the same terms, grouped the same
way, so the forms are bit-identical to the direct form (as in the JAX
package, where each is bit-identical to ``_kernel_direct``), and the int8
body to its plain version. A bf16 product is exact in f32, so a sum taken
in the same order is the same number: the bf16 plain version equals the
JAX body in interpret mode wherever XLA's CPU dot sums in ascending order
(short contractions; past those, one rounding of the sum may differ).

The JAX kernel contracts every window with band matrices. Every column of a
band matrix holds the same tap vector, shifted, so the band dots are 1-D
correlations with one tap vector per axis: ``int8_operands``,
``hybrid_operands`` and ``bf16_operands`` yield those vectors, and the
kernels rebuild the bands from them as tensor-core fragments.

The bf16x3 tile body has the numerics of the blocked kernel
``fused_blur._kernel`` and runs as K2 (``cuda_kernels/fused_blur.py``).
``blur_fused_haloed_dma`` is the sharded path's per-shard step (the JAX
``rows_prepadded`` mode): A4 (``assemble.assemble_padded_prepad``) puts the
caller's halo rows where A5 puts reflected ones, and K1a runs on that frame
unchanged.
``MAX_RADIUS`` (600, the JAX int8 DMA form's domain) bounds K1 and K2
alike; past it ``blur_fused_u8`` runs the two-pass split, whose int8 forms
(``cuda_kernels/fused_split.py``) share ``int8_rows_ref`` /
``int8_cols_ref`` with K1's plain version here.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from blur_algorithms_tpu_torch.cuda_kernels.assemble import HaloedRows, assemble_padded_prepad
from blur_algorithms_tpu_torch.cuda_kernels.fused_blur import (
    MAX_RADIUS,
    _quantize_band_int8,
    int8_applicable,
    pick_int8_scale,
)
from blur_algorithms_tpu_torch.ops.band_matmul import band_block_matrix
from blur_algorithms_tpu_torch.ops.pad import reflect_101
from blur_algorithms_tpu_torch.ops.plan import BlurPlan
from blur_algorithms_tpu_torch.utils.hw import device_spec
from blur_algorithms_tpu_torch.utils import trace

__all__ = [
    "Bf16Operands",
    "HybridOperands",
    "Int8Operands",
    "MAX_RADIUS",
    "bf16_operands",
    "FORMS",
    "K1Geometry",
    "RUNGS",
    "TcLayout",
    "bf16_bound",
    "bf16_bound_padded",
    "bf16_operands",
    "blur_fused_u8_assembled",
    "blur_fused_u8_bf16",
    "blur_fused_u8_bf16_ref",
    "blur_fused_u8_dma",
    "blur_fused_u8_dma_ref",
    "blur_fused_haloed_dma",
    "blur_fused_u8_hybrid",
    "blur_fused_u8_hybrid_ref",
    "blur_fused_u8_padded_ref",
    "blur_fused_u8_pipelined",
    "blur_fused_u8_resident",
    "blur_fused_u8_strip",
    "dma_form_applicable",
    "hybrid_operands",
    "int8_operands",
    "k1_geometry",
    "layout_bytes",
    "stage_rows",
    "tc_layout",
    "tc_tables",
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


def blur_fused_u8_dma_ref(planar_u8: torch.Tensor, plan: BlurPlan,
                          out_u8: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K1: uint8 ``(..., H, W)`` -> uint8, or the
    float32 epilogue value before the store (``out_u8=False``).

    Reflect-101 gather, then the exact integer sums tap by tap, then the
    same digit split and f32 epilogue, each rounding spelled out
    (``int8_cols_ref``). Runs on whatever device the input lies on.
    """
    _check_planar(planar_u8, plan)
    check_domain(plan)
    return _body_ref(_reflect_planes(planar_u8, plan), plan, "int8", out_u8).reshape(
        planar_u8.shape)


def _check_rung(planar_u8: torch.Tensor, plan: BlurPlan, precision: str) -> None:
    _check_planar(planar_u8, plan)
    _check_body(plan, precision, True)


def _reflect_planes(planar_u8: torch.Tensor, plan: BlurPlan) -> torch.Tensor:
    """``(n, H + 2rh, W + 2rw)``: the planes reflect-101 padded by the radii."""
    rh, rw = plan.col.support_radius, plan.row.support_radius
    x = planar_u8.reshape(-1, *plan.shape)
    return reflect_101(x, [(rh, rh), (rw, rw)])


def _body_ref(xp: torch.Tensor, plan: BlurPlan, precision: str,
              out_u8: bool) -> torch.Tensor:
    """One of K1's bodies on padded planes ``xp`` (``(n, H + 2rh, W +
    2rw)`` uint8) -> ``(n, H, W)`` uint8, or the float32 value before the
    store (``out_u8=False``)."""
    h, w = plan.shape
    if precision == "int8":
        ops = int8_operands(plan)
        r = int8_rows_ref(xp, ops.q_row, w)
        s = ops.rows_shift
        e = (r + (1 << (s - 1))) >> s
        del r
        out = int8_cols_ref(e, ops.q_col, ops.epilogue_constants(), h, out_u8)
    elif precision == "hybrid":
        ops = hybrid_operands(plan)
        y = bf16_round_ref(int8_rows_ref(xp, ops.q_row, w).to(torch.float32))
        out = fma_f32_ref(bf16_correlate_ref(y, ops.c_col, h, -2), ops.scale, 128.0)
    else:
        ops = bf16_operands(plan)
        y = bf16_round_ref(bf16_correlate_ref(xp.to(torch.float32), ops.c_row, w, -1))
        out = bf16_correlate_ref(y, ops.c_col, h, -2)
    return store_u8_ref(out) if out_u8 else out


def blur_fused_u8_padded_ref(xp: torch.Tensor, plan: BlurPlan, orh: int, orw: int,
                             precision: str = "int8", out_u8: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K1's assembled form (K1a): the same body on
    windows of an assembled frame. ``xp``: uint8 ``(..., hp, wp)`` holding
    the planes at ``(orh, orw)`` with their reflect-101 borders around them
    (``assemble.assemble_padded``) -> ``(..., H, W)``. Runs on whatever
    device the input lies on."""
    if xp.dtype != torch.uint8:
        raise TypeError(f"expected a uint8 frame, got {xp.dtype}")
    _check_body(plan, precision, out_u8)
    h, w = plan.shape
    rh, rw = plan.col.support_radius, plan.row.support_radius
    if (xp.ndim < 2 or orh < rh or orw < rw or orh + h + rh > xp.shape[-2]
            or orw + w + rw > xp.shape[-1]):
        raise ValueError(f"a frame of shape {tuple(xp.shape)} does not hold the plan's "
                         f"{plan.shape} planes and their borders at {(orh, orw)}")
    x = xp.reshape(-1, *xp.shape[-2:])[:, orh - rh : orh + h + rh, orw - rw : orw + w + rw]
    return _body_ref(x, plan, precision, out_u8).reshape(*xp.shape[:-2], h, w)


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


def fma_f32_ref(a: torch.Tensor, b: float, c: float | torch.Tensor) -> torch.Tensor:
    """float32 ``fma(a, b, c)`` rounded once, as the kernels' ``__fmaf_rn``
    (``c`` a float32 number or tensor).

    ``a * b`` is exact in float64 (two 24-bit significands); the float64 sum
    with ``c`` is made round-to-odd from its exact error (TwoSum), and a
    round-to-odd float64 rounds to float32 as the exact value would."""
    p = a.to(torch.float64) * float(np.float32(b))
    c = (c.to(torch.float32).to(torch.float64) if isinstance(c, torch.Tensor)
         else float(np.float32(c)))
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
    out = _body_ref(_reflect_planes(planar_u8, plan), plan, "hybrid", out_u8)
    return out.reshape(planar_u8.shape)


def blur_fused_u8_bf16_ref(planar_u8: torch.Tensor, plan: BlurPlan,
                           out_u8: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K1's bf16 body: uint8 ``(..., H, W)`` ->
    uint8, or the float32 value before the store (``out_u8=False``).

    ``y = bf16(sum bf16(r_t) * x)`` over the rows, then ``sum bf16(c_t) * y``
    over the columns, both in ascending tap order. Runs on whatever device
    the input lies on."""
    _check_rung(planar_u8, plan, "bf16")
    out = _body_ref(_reflect_planes(planar_u8, plan), plan, "bf16", out_u8)
    return out.reshape(planar_u8.shape)


COLS_TOL = 2e-2  # the tensor cores' grouped column sum against an ascending one, 0..255


def _correlate64(y: torch.Tensor, taps: np.ndarray, n: int, axis: int) -> torch.Tensor:
    """``sum_t taps[t] * y[t : t + n]`` along ``axis`` in float64."""
    acc = torch.zeros((*y.shape[:axis % y.ndim], n, *y.shape[axis % y.ndim + 1:]),
                      dtype=torch.float64, device=y.device)
    for t, c in enumerate(taps.tolist()):
        if c:
            acc.add_(y.narrow(axis, t, n), alpha=c)
    return acc


def _bf16_bound(xp: torch.Tensor, plan: BlurPlan) -> torch.Tensor:
    """``bf16_bound`` on padded planes ``xp`` (``(n, H + 2rh, W + 2rw)``
    uint8) -> ``(n, H, W)``."""
    h, w = plan.shape
    ops = bf16_operands(plan)
    xp = xp.to(torch.float64)
    exact = _correlate64(xp, ops.c_row, w, -1)
    mass = exact if (ops.c_row >= 0).all() else _correlate64(xp, np.abs(ops.c_row), w, -1)
    del xp
    eps = mass * (2.0 ** -21 * ops.c_row.size)
    del mass
    step = (bf16_round_ref((exact + eps).to(torch.float32))
            - bf16_round_ref((exact - eps).to(torch.float32))).to(torch.float64)
    del exact, eps
    return _correlate64(step, np.abs(ops.c_col), h, -2).add_(COLS_TOL)


def bf16_bound(planar_u8: torch.Tensor, plan: BlurPlan) -> torch.Tensor:
    """float64 ``(..., H, W)``: how far K1's bf16 body may lie from its
    plain version ``blur_fused_u8_bf16_ref`` on the f32 store (derived at
    ``blur_fused_u8_bf16``): ``COLS_TOL`` plus, for each output, the sum
    over its column taps of ``|c_t|`` times the bf16 step that the rows
    value it reads can take. That step is ``bf16(E + eps) - bf16(E - eps)``,
    E the exact rows sum (float64: bf16 taps times bytes, exact) and eps =
    2^-21 (2 rw + 1) sum_t |r_t| x[t], a bound on either f32 sum's distance
    from E: 0 unless E lies within eps of a bf16 rounding boundary. Runs
    on whatever device the input lies on."""
    _check_rung(planar_u8, plan, "bf16")
    return _bf16_bound(_reflect_planes(planar_u8, plan), plan).reshape(planar_u8.shape)


def bf16_bound_padded(xp: torch.Tensor, plan: BlurPlan, orh: int, orw: int) -> torch.Tensor:
    """``bf16_bound`` for K1's assembled form on a frame ``xp`` holding the
    planes at ``(orh, orw)`` (as ``blur_fused_u8_padded_ref`` takes it)."""
    h, w = plan.shape
    rh, rw = plan.col.support_radius, plan.row.support_radius
    x = xp.reshape(-1, *xp.shape[-2:])[:, orh - rh : orh + h + rh, orw - rw : orw + w + rw]
    return _bf16_bound(x, plan).reshape(*xp.shape[:-2], h, w)


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


def int8_cols_ref(e: torch.Tensor, q_col: np.ndarray, constants, h: int,
                  out_u8: bool = True) -> torch.Tensor:
    """The int8 cols pass on the row-padded intermediate ``e`` (int32
    ``(n, h + 2rh, w)``): base-128 digits, the three digit products tap by
    tap, and the f32 epilogue ``p1*c1 + p23*c2 + p4*c3 + 128`` -> float32.
    For the uint8 store (``out_u8``) every product and sum is rounded on its
    own, the kernels' form since K1's first port; for the f32 store two of
    the multiply-adds are contracted, ``fma(p4, c3, fma(p23, c2, p1*c1)) +
    128``, as XLA compiles the JAX expression in interpret mode on an FMA
    host, so that store is bit-equal to the JAX kernel there."""
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

    c1, c2, c3 = constants
    y = torch.mul(p1.to(torch.float32), c1)
    if out_u8:
        y = torch.add(y, torch.mul(p23.to(torch.float32), c2))
        y = torch.add(y, torch.mul(p4.to(torch.float32), c3))
    else:
        y = fma_f32_ref(p23.to(torch.float32), c2, y)
        y = fma_f32_ref(p4.to(torch.float32), c3, y)
    return torch.add(y, 128.0)


def _pack_int8_words(taps: np.ndarray) -> np.ndarray:
    """int8 taps -> int32 words of four, zero-padded, tap 4k+u in byte u."""
    padded = np.zeros(-(-taps.size // 4) * 4, dtype=np.int8)
    padded[: taps.size] = taps
    return padded.view("<i4").astype(np.int32)


def _tap_copies(q: np.ndarray, delta: int, words: int) -> np.ndarray:
    """``(2, 4, words)`` uint32: for each base-128 digit of the int8 taps
    ``q`` (``q >> 7``, ``q & 127``) four byte-shifted copies, word i of copy
    c holding the digit taps ``[4i + c - 16 - delta, 4i + c - 13 - delta]``,
    one byte each, zero outside the taps: what a lane's A-fragment register
    reads as one aligned word (``rows_mma``, ``cols_int8_mma``)."""
    out = np.zeros((2, 4, words), np.uint32)
    for d, digits in enumerate((q >> 7, q & 127)):
        t = np.zeros(4 * words + 8, np.uint32)
        t[16 + delta : 16 + delta + digits.size] = digits.astype(np.uint32) & 0xFF
        for c in range(4):
            idx = 4 * np.arange(words)[:, None] + c + np.arange(4)[None, :]
            out[d, c] = (t[idx] << (8 * np.arange(4, dtype=np.uint32))).sum(axis=1)
    return out


def _tap_groups(c: np.ndarray, groups: int) -> np.ndarray:
    """``(groups + 14, 12)`` uint32: the column taps ``c`` (bf16 values) in
    the hybrid cols pass's groups of 16, stored from group -7 to groups + 6
    (zero outside the taps), word q < 8 of a group the bf16 pair of its taps
    2q, 2q + 1 (the low half first), words 8..11 zero (12 words a group put
    a load's 8 lanes on 8 banks)."""
    bits = _bf16_bits(c)
    t = 16 * (np.arange(groups + 14)[:, None] - 7) + 2 * np.arange(8)[None, :]

    def at(i):
        return np.where((i >= 0) & (i < c.size), bits[np.clip(i, 0, c.size - 1)], 0)

    out = np.zeros((groups + 14, 12), np.uint32)
    out[:, :8] = at(t) | (at(t + 1) << 16)
    return out


def _padded_f32(taps: np.ndarray) -> np.ndarray:
    out = np.zeros(-(-taps.size // 4) * 4, dtype=np.float32)
    out[: taps.size] = taps
    return out


def _bf16_bits(c: np.ndarray) -> np.ndarray:
    """bf16 values (as float32) -> their 16-bit patterns, as uint32."""
    bits = torch.from_numpy(np.ascontiguousarray(c, np.float32)).to(torch.bfloat16)
    return bits.view(torch.int16).numpy().astype(np.uint32) & 0xFFFF


def _bf16_pair_copies(c: np.ndarray, delta: int, words: int) -> np.ndarray:
    """``(2, words)`` uint32: the bf16 row taps ``c`` in two copies, word i
    of copy p the bf16 pair of taps ``2i + p - 32 - delta`` (low half) and
    the next (high half), zero outside the taps: what a lane of the bf16
    rows pass (``rows_bf16_mma``) reads as one aligned word for each A
    register."""
    bits = _bf16_bits(c)
    out = np.zeros((2, words), np.uint32)
    for par in range(2):
        t = 2 * np.arange(words) + par - 32 - delta

        def at(i):
            return np.where((i >= 0) & (i < c.size), bits[np.clip(i, 0, c.size - 1)], 0)

        out[par] = at(t) | (at(t + 1) << 16)
    return out


@functools.lru_cache(maxsize=64)
def tc_tables(plan: BlurPlan, precision: str, framed: bool,
              device: torch.device | str = "cpu") -> torch.Tensor:
    """The tap tables of K1's ``precision`` body, int32 words in the order
    ``tc_carve`` of ``csrc/fused_dma.cu`` copies them into shared memory
    (``tc_layout(...).taps`` bytes): ``[qoff, 0, 0, 0]`` (``128 * Q``, Q =
    128 sum q_hi + sum q_lo, the raw-byte rows product's recentring, modulo
    2^32; 0 for bf16), the rows taps' copies (int8 and hybrid:
    ``_tap_copies``, after (-rw) mod 16 leading zeros, none in the ``framed``
    assembled forms; bf16: ``_bf16_pair_copies`` after (-rw) mod 16 in every
    form), then the column taps' copies (int8) or groups (hybrid and bf16,
    ``_tap_groups``). Built once a plan, rung and form family on the host,
    so no block builds them."""
    rh, rw = plan.col.support_radius, plan.row.support_radius
    lay = tc_layout("assembled" if framed else "direct", precision, 16, 64, rh, rw, 2)
    if precision == "bf16":
        ops = bf16_operands(plan)
        head = np.zeros(4, np.uint32)
        rows = _bf16_pair_copies(ops.c_row, lay.delta, lay.rwords)
        cols = _tap_groups(ops.c_col, lay.groups)
    else:
        ops = int8_operands(plan)
        q = ops.q_row.astype(np.int64)
        qoff = (128 * (128 * int((q >> 7).sum()) + int((q & 127).sum()))) % (1 << 32)
        head = np.array([qoff, 0, 0, 0], np.uint32)
        rows = _tap_copies(q, lay.delta, lay.rwords)
        cols = (_tap_copies(ops.q_col.astype(np.int64), 0, lay.cwords) if precision == "int8"
                else _tap_groups(hybrid_operands(plan).c_col, lay.groups))
    words = np.zeros(lay.taps // 4, np.uint32)
    body = np.concatenate([head, rows.ravel(), cols.ravel()])
    words[: body.size] = body
    return torch.from_numpy(words.view(np.int32)).to(device)


def _check_body(plan: BlurPlan, precision: str, out_u8: bool) -> None:
    if precision not in RUNGS:
        raise ValueError(f"K1's bodies are {RUNGS}, not {precision!r}")
    if precision == "int8":
        check_domain(plan)
    elif not dma_form_applicable(torch.uint8, plan, precision):
        rh, rw = plan.col.support_radius, plan.row.support_radius
        raise ValueError(
            f"K1's {precision} body does not serve this plan (support radii "
            f"({rh}, {rw}); it needs both in 1..{MAX_RADIUS}"
            + ("" if precision == "bf16" else " and non-negative unit-sum taps")
            + ")"
        )


# ---------------------------------------------------------------------------
# the forms' geometry: one policy per form serves both its applicability
# check and its launch

RUNGS = ("int8", "hybrid", "bf16")
FORMS = ("direct", "strip", "assembled", "pipelined", "resident")
# The H100's dynamic shared memory per block and its SM count: what the
# forms are sized by where the tensor's device reports neither (the CPU).
HOPPER_SMEM_OPTIN = 232448
HOPPER_SMS = 132
PIPELINE_SEG = 4  # windows per block of the pipelined variant


def _r16(n: int) -> int:
    return (n + 15) & ~15


def _odd16(n: int) -> int:
    """The least odd multiple of 16 bytes >= n (eight rows at that stride
    fall on eight bank groups)."""
    n = _r16(n)
    return n if (n >> 4) & 1 else n + 16


def _copy_words(steps: int) -> int:
    need = 8 * steps + 4
    return need + (8 - need) % 32


def _bf16_words(steps: int) -> int:
    """Words of each of the bf16 rows taps' two copies (``bf16_words``)."""
    need = 8 * steps + 16
    return need + (16 - need) % 32


STAGE_BUDGET = 48 * 1024  # csrc/fused_dma.cu kStageBudget


def stage_rows(tw: int, sp: int) -> int:
    """Rows a staged group of the int8 and hybrid bodies: 4096 / tw, halved
    while two groups of pitch ``sp`` would pass ``STAGE_BUDGET``, down to
    1024 / tw (``stage_rows`` of ``csrc/fused_dma.cu``)."""
    g = 4096 // tw
    while g > 1024 // tw and 2 * g * sp > STAGE_BUDGET:
        g >>= 1
    return g


@dataclasses.dataclass(frozen=True)
class TcLayout:
    """The block of one of K1's bodies in one form (``tc_layout`` of
    ``csrc/fused_dma.cu``): the rows pass's k-steps (of 32 window bytes; of
    16 for bf16) over ``delta`` leading zero taps, the staged window (``sw``
    bytes a row at pitch ``sp``, ``g`` rows a group), the ``rows`` window
    rows the rows pass computes (K1r's ring), the ``pr`` plane rows the cols
    pass reads, and the byte counts."""

    delta: int
    rsteps: int
    csteps: int
    groups: int
    sw: int
    sp: int
    g: int
    rows: int
    pr: int
    cs: int
    plane: int
    nplanes: int
    stage: int
    rwords: int
    cwords: int
    taps: int
    total: int


def tc_layout(form: str, precision: str, th: int, tw: int, rh: int, rw: int,
              slots: int = 0) -> TcLayout:
    """K1's ``precision`` block in ``form`` (see ``TcLayout``). The bf16
    body's rows taps take (-rw) mod 16 leading zeros in every form: its k
    steps group the taps by the image column, so that its f32 rows sums are
    the same in every form."""
    framed = form in ("assembled", "pipelined")
    bf16 = precision == "bf16"
    delta = 0 if framed and not bf16 else (16 - rw % 16) % 16
    rsteps = ((delta + 2 * rw + 1 + 15 + 15) // 16 if bf16
              else (delta + 2 * rw + 1 + 15 + 31) // 32)
    csteps = (2 * rh + 1 + 15 + 31) // 32
    groups = (2 * rh + 1 + 15) // 16
    sw = tw - 16 + (16 if bf16 else 32) * rsteps
    sp = _odd16(sw)
    g = stage_rows(tw, sp)
    rows = _r16(th + 2 * rh)
    if form == "resident":
        pr = rows
    elif precision == "int8":
        pr = max(rows, -(-th // 32) * 32 - 16 + 32 * csteps)
    else:
        pr = max(rows, -(-th // 128) * 128 + 16 * groups)
    if precision == "int8":
        cs = _odd16(pr)
        plane = 2 * tw * cs
    else:
        cs = 2 * tw + 16
        plane = pr * cs
    nplanes = 2 if form == "pipelined" else 1
    stage = rows * sp if form == "strip" else (slots if framed else 2) * g * sp
    rwords = _bf16_words(rsteps) if bf16 else _copy_words(rsteps)
    cwords = _copy_words(csteps) if precision == "int8" else 12 * (groups + 14)
    taps = _r16(16 + 4 * ((2 if bf16 else 8) * rwords
                          + (8 * cwords if precision == "int8" else cwords)))
    return TcLayout(delta, rsteps, csteps, groups, sw, sp, g, rows, pr, cs, plane, nplanes,
                    stage, rwords, cwords, taps, nplanes * plane + stage + taps)


def layout_bytes(form: str, precision: str, th: int, tw: int, rh: int, rw: int,
                 slots: int = 0) -> int:
    """Shared memory of one block of ``form`` with K1's ``precision`` body:
    ``tc_layout`` of ``csrc/fused_dma.cu``, which checks the launch against
    it."""
    return tc_layout(form, precision, th, tw, rh, rw, slots).total


@dataclasses.dataclass(frozen=True)
class K1Geometry:
    """A form's launch: its tile, windows per block (the pipelined variant),
    shared memory, and the assembled forms' cp.async buffers (``slots - 1``
    row groups in flight) and padded frame ``(hp, wp)``, which holds the
    planes at ``(rh, rw)``."""

    form: str
    th: int
    tw: int
    seg: int
    smem: int
    slots: int = 0
    hp: int = 0
    wp: int = 0


def k1_geometry(form: str, precision: str, plan: BlurPlan, planes: int = 1,
                tile: tuple[int, int] | None = None,
                device: torch.device | str = "cpu") -> K1Geometry | None:
    """The launch of K1's ``precision`` body in ``form`` on ``planes``
    planes of the plan's shape, or None where the form does not serve it.

    Tiles as K1's direct policy: columns 64 to rw 100, 128 to 200, 64 to
    400, else 32 (the fastest measured at r 9..598 for the int8 and hybrid
    bodies, which the bf16 body's blocks share; narrower where a 32-row
    block does not fit); 256, 512 or 1024 rows by rh, halved until the block
    fits the device's shared memory, then balanced over the frame (rounded
    up to 16 rows, the fragments being 16 or 8 rows); the strip form halves
    its rows further while the frame has fewer
    than two strips per SM, since it runs one block per strip; the resident
    form steps 64 rows (int8, halved to fit) or 128 (hybrid: one block of
    its cols fragments, rows 16 apart): its rows work does not depend on
    the step. The assembled forms keep two row groups in flight where three
    buffers fit, else one. ``tile=(th, tw)`` pins either (0 = the policy;
    th a multiple of 16 for int8 and hybrid). The resident form serves int8
    and hybrid (its ring holds digit planes or bf16 ``y``), the pipelined
    variant int8 on frames of two windows or more. Sized by ``device``'s
    shared memory (the H100's on the CPU)."""
    if form not in FORMS:
        raise ValueError(f"K1's forms are {FORMS}, not {form!r}")
    return _k1_geometry(form, precision, plan, planes, tuple(tile) if tile else None,
                        device_spec(device))


@functools.lru_cache(maxsize=256)
def _k1_geometry(form: str, precision: str, plan: BlurPlan, planes: int, tile,
                 spec) -> K1Geometry | None:
    """``k1_geometry`` for a device of ``spec``, cached: every launch asks."""
    if ((form == "resident" and precision == "bf16")
            or (form == "pipelined" and precision != "int8")):
        return None
    limit = spec.smem_optin_bytes or HOPPER_SMEM_OPTIN
    sms = spec.sm_count or HOPPER_SMS
    h, w = plan.shape
    rh, rw = plan.col.support_radius, plan.row.support_radius
    gran = 16
    th_pin, tw_pin = tile or (0, 0)
    if (tw_pin and tw_pin not in (32, 64, 128)) or th_pin % gran or th_pin < 0:
        raise ValueError(f"tile {tile}: rows a multiple of {gran}, columns 32, 64 or 128")
    raw = form in ("assembled", "pipelined")
    if tw_pin:
        tw = tw_pin
    else:
        # the fastest measured columns by row radius (probes/k1_tc_ablation.py
        # on an H100: 64 at r 9..99, 128 at r 165, 64 at r 332, 32 at r 598),
        # narrowed where a 32-row block does not fit
        tw = 64 if rw <= 100 else 128 if rw <= 200 else 64 if rw <= 400 else 32
        while tw > 32 and layout_bytes(form, precision, 32, tw, rh, rw,
                                       2 if raw else 0) > limit:
            tw //= 2

    def fits(t: int, slots: int = 2 if raw else 0) -> bool:
        return layout_bytes(form, precision, t, tw, rh, rw, slots) <= limit

    if th_pin:
        th = th_pin
    elif form == "resident":
        th = 128 if precision == "hybrid" else 64
        while th > 16 and precision == "int8" and not fits(th):
            th //= 2
    else:
        target = 256 if rh <= 100 else (512 if rh <= 400 else 1024)
        while target > 32 and not fits(target):
            target >>= 1
        if form == "strip":
            while target > 32 and planes * -(-h // target) < 2 * sms:
                target >>= 1
        tiles = -(-h // target)
        th = -(-(-(-h // tiles)) // gran) * gran
    if not fits(th):
        return None
    nbw = -(-w // tw)
    seg = 1
    if form == "pipelined":
        if nbw < 2:
            return None
        seg = min(PIPELINE_SEG, nbw)
    slots = hp = wp = 0
    if raw:
        slots = 3 if fits(th, 3) else 2
        nbh = -(-h // th)
        lay = tc_layout(form, precision, th, tw, rh, rw, slots)
        hp = (nbh - 1) * th + lay.rows
        wp = _r16((nbw - 1) * tw + lay.sw)
    return K1Geometry(form, th, tw, seg, layout_bytes(form, precision, th, tw, rh, rw, slots),
                      slots, hp, wp)


def _form_geometry(form: str, precision: str, plan: BlurPlan, planes: int,
                   tile, device) -> K1Geometry:
    geo = k1_geometry(form, precision, plan, planes, tile, device)
    if geo is None:
        kw = {"direct": "tile", "assembled": "direct=False"}.get(form, f"{form}=True")
        raise ValueError(
            f"{kw}: K1's {form} form does not serve the {precision} body on "
            f"{plan.shape} planes at support radii ({plan.col.support_radius}, "
            f"{plan.row.support_radius})" + (f", tile {tile}" if tile else "")
            + " (the block does not fit the device's shared memory, or the form "
            "does not take this body)"
        )
    return geo


def _resolve_form(plan: BlurPlan, precision: str, planes: int, tile, device, *,
                  direct, strip, pipelined, resident) -> K1Geometry:
    """The form a call runs: the one its keywords pin, else the form the
    device's measured rule names (``utils/hw.DeviceSpec.k1_form``) where
    its keyword is unset and it fits, else K1 direct."""
    pinned = [f for f, on in (("resident", resident), ("strip", strip),
                              ("pipelined", pipelined)) if on]
    if direct is False and not pipelined:
        pinned.append("assembled")
    if direct is True:
        pinned.append("direct")
    if len(pinned) > 1:
        raise ValueError(f"the forms {pinned} exclude one another")
    if pinned:
        return _form_geometry(pinned[0], precision, plan, planes, tile, device)
    r = max(plan.col.support_radius, plan.row.support_radius)
    form = device_spec(device).k1_form(precision, planes, r)
    declined = {"direct": True, "assembled": direct is not None,
                "resident": resident is not None}
    if not declined[form]:
        geo = k1_geometry(form, precision, plan, planes, tile, device)
        if geo is not None:
            return geo
    return _form_geometry("direct", precision, plan, planes, tile, device)


# ---------------------------------------------------------------------------
# the wrappers: a CUDA tensor launches the form's kernel, a CPU tensor runs
# the plain version, any other device raises


def _check_cuda(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} needs contiguous planes")


def _plain(planar_u8: torch.Tensor, plan: BlurPlan, precision: str,
           out_u8: bool) -> torch.Tensor:
    if precision == "int8":
        return blur_fused_u8_dma_ref(planar_u8, plan, out_u8)
    ref = blur_fused_u8_hybrid_ref if precision == "hybrid" else blur_fused_u8_bf16_ref
    return ref(planar_u8, plan, out_u8)


def _launch(fn, geo: K1Geometry, x: torch.Tensor, plan: BlurPlan, precision: str,
            out_u8: bool) -> torch.Tensor:
    """One launch of ``blur_fused_u8_k1`` on contiguous CUDA planes ``x``
    (``(n, H, W)``, or the padded frames ``(n, hp, wp)`` of the assembled
    forms) -> ``(n, H, W)``, in the span ``launch.blur_fused_u8_k1``;
    counted on ``fn`` (``utils.trace.launched``)."""
    from blur_algorithms_tpu_torch.utils.build import load_library

    name = f"K1 {geo.form} {precision}"
    with trace.span("launch.blur_fused_u8_k1"):
        if x.shape[0] > 65535:
            raise ValueError(f"{name} takes at most 65535 planes, got {x.shape[0]}")
        h, w = plan.shape
        out = torch.empty((x.shape[0], h, w),
                          dtype=torch.uint8 if out_u8 else torch.float32, device=x.device)
        if x.shape[0] == 0:
            return out
        shift, consts, scale = 0, (0.0, 0.0, 0.0), 1.0
        taps_i = tc_tables(plan, precision, geo.form in ("assembled", "pipelined"), x.device)
        if precision == "int8":
            ops = int8_operands(plan)
            shift, consts = ops.rows_shift, ops.epilogue_constants()
        elif precision == "hybrid":
            scale = float(hybrid_operands(plan).scale)
        lib = load_library()
        with torch.cuda.device(x.device):
            rc = lib.blur_fused_u8_k1(
                FORMS.index(geo.form), RUNGS.index(precision), int(out_u8),
                x.data_ptr(), out.data_ptr(), taps_i.data_ptr(), None,
                x.shape[0], h, w, plan.col.support_radius, plan.row.support_radius,
                geo.th, geo.tw, geo.seg, geo.slots, x.shape[1], x.shape[2], geo.smem, shift,
                *map(float, consts), scale, torch.cuda.current_stream(x.device).cuda_stream,
            )
    if rc:
        msg = lib.blur_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
    trace.launched(fn, "blur_fused_u8_k1", trace.nbytes(x, out, taps_i))
    return out


def _run_form(fn, form: str, planar_u8: torch.Tensor, plan: BlurPlan, precision: str,
              out_u8: bool, tile) -> torch.Tensor:
    """K1's ``precision`` body in ``form`` (direct, strip or resident) on
    uint8 ``(..., H, W)``: the kernel on a CUDA tensor, counted on ``fn``;
    the body's plain version on a CPU tensor."""
    _check_planar(planar_u8, plan)
    _check_body(plan, precision, out_u8)
    planes = int(np.prod(planar_u8.shape[:-2], dtype=np.int64))
    geo = _form_geometry(form, precision, plan, planes, tile, planar_u8.device)
    if planar_u8.device.type == "cpu":
        return _plain(planar_u8, plan, precision, out_u8)
    _check_cuda(f"K1 {form}", planar_u8)
    out = _launch(fn, geo, planar_u8.reshape(-1, *plan.shape), plan, precision, out_u8)
    return out.reshape(planar_u8.shape)


def _run_assembled(fn, form: str, frame: torch.Tensor, plan: BlurPlan, precision: str,
                   out_u8: bool, tile) -> torch.Tensor:
    if frame.dtype != torch.uint8:
        raise TypeError(f"expected a uint8 frame, got {frame.dtype}")
    _check_body(plan, precision, out_u8)
    planes = int(np.prod(frame.shape[:-2], dtype=np.int64))
    geo = _form_geometry(form, precision, plan, planes, tile, frame.device)
    if frame.ndim < 2 or tuple(frame.shape[-2:]) != (geo.hp, geo.wp):
        raise ValueError(f"K1 {form} reads a ({geo.hp}, {geo.wp}) frame, got "
                         f"{tuple(frame.shape)}")
    rh, rw = plan.col.support_radius, plan.row.support_radius
    if frame.device.type == "cpu":
        return blur_fused_u8_padded_ref(frame, plan, rh, rw, precision, out_u8)
    _check_cuda(f"K1 {form}", frame)
    if frame.data_ptr() % 16:
        raise ValueError(f"K1 {form} reads its frame with 16-byte copies: it must be "
                         "16-byte aligned")
    out = _launch(fn, geo, frame.reshape(-1, geo.hp, geo.wp), plan, precision, out_u8)
    return out.reshape(*frame.shape[:-2], *plan.shape)


def blur_fused_u8_dma(planar_u8: torch.Tensor, plan: BlurPlan,
                      tile: tuple[int, int] | None = None, precision: str = "int8", *,
                      out_u8: bool = True, direct: bool | None = None,
                      strip: bool | None = None, pipelined: bool = False,
                      resident: bool | None = None) -> torch.Tensor:
    """uint8 planar ``(..., H, W)`` -> uint8 (float32 with ``out_u8=False``),
    K1 with its ``precision`` body in one of its forms: the JAX
    ``_blur_fused_dma_impl``.

    ``resident=True``: the rows-resident form (``blur_fused_u8_resident``);
    ``strip=True``: the strip form (``blur_fused_u8_strip``);
    ``direct=False``: A5 (``assemble.assemble_padded``), then the assembled
    form (``blur_fused_u8_assembled``), or its pipelined variant with
    ``pipelined=True`` (int8); ``direct=True``: the direct form. A pinned form
    that does not serve the call raises ``ValueError``; none runs in its
    place. Unpinned (``None``), the device's measured rule picks the
    assembled or the resident form per rung, plane count and radius
    (``utils/hw.DeviceSpec.k1_form``) where it fits, else the direct form;
    no rule routes the strip form, which lost at every measured point. The JAX
    package also routes its assembled form where its direct form cannot
    splice a window (``_direct_applicable``: one column window, tiny frames,
    prepadded rows): that is a TPU DMA alignment limit, and the card's direct
    loader (16-byte copies inside the frame, mirrored aligned words past its
    edges, reflect-101 bytes elsewhere) has none.

    ``blur_fused_u8_dma.launches`` counts launches of the direct form's int8
    body; ``blur_fused_u8_hybrid`` / ``_bf16`` count the direct form's other
    bodies, and each other form counts on its own wrapper. A CPU tensor runs
    the plain version (through A5's plain version and
    ``blur_fused_u8_padded_ref`` for the assembled forms); any other device,
    a non-contiguous CUDA tensor, or a plan outside the body's domain raises.
    """
    if precision not in RUNGS:
        raise ValueError(f"K1's bodies are {RUNGS}, not {precision!r}")
    _check_planar(planar_u8, plan)
    _check_body(plan, precision, out_u8)
    if planar_u8.device.type == "cuda":
        _check_cuda("K1", planar_u8)
    elif planar_u8.device.type != "cpu":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, not {planar_u8.device}")
    x = planar_u8.reshape(-1, *plan.shape)
    geo = _resolve_form(plan, precision, x.shape[0], tile, x.device, direct=direct,
                        strip=strip, pipelined=pipelined, resident=resident)
    if geo.form == "direct":
        fn = {"int8": blur_fused_u8_dma, "hybrid": blur_fused_u8_hybrid,
              "bf16": blur_fused_u8_bf16}[precision]
        out = _run_form(fn, "direct", x, plan, precision, out_u8, tile)
    elif geo.form == "strip":
        out = blur_fused_u8_strip(x, plan, precision, out_u8, tile)
    elif geo.form == "resident":
        out = blur_fused_u8_resident(x, plan, precision, out_u8, tile)
    else:
        from blur_algorithms_tpu_torch.cuda_kernels.assemble import assemble_padded

        rh, rw = plan.col.support_radius, plan.row.support_radius
        frame = assemble_padded(x, rh, rw, rh, rw, geo.hp, geo.wp)
        if geo.form == "pipelined":
            out = blur_fused_u8_pipelined(frame, plan, out_u8, tile)
        else:
            out = blur_fused_u8_assembled(frame, plan, precision, out_u8, tile)
    return out.reshape(planar_u8.shape)


blur_fused_u8_dma.launches = 0


def blur_fused_u8_hybrid(planar_u8: torch.Tensor, plan: BlurPlan, out_u8: bool = True,
                         tile: tuple[int, int] | None = None) -> torch.Tensor:
    """uint8 planar ``(..., H, W)`` -> uint8 (or float32 with ``out_u8=False``),
    K1's hybrid body in the direct form: exact int8 rows, one bf16 column
    dot. A plan outside the body's domain (``dma_form_applicable``), any
    device but CUDA or the CPU, or a non-contiguous tensor raises.
    ``blur_fused_u8_hybrid.launches`` counts kernel launches."""
    return _run_form(blur_fused_u8_hybrid, "direct", planar_u8, plan, "hybrid", out_u8, tile)


blur_fused_u8_hybrid.launches = 0


def blur_fused_u8_bf16(planar_u8: torch.Tensor, plan: BlurPlan, out_u8: bool = True,
                       tile: tuple[int, int] | None = None) -> torch.Tensor:
    """uint8 planar ``(..., H, W)`` -> uint8 (or float32 with ``out_u8=False``),
    K1's bf16 body in the direct form: one bf16 dot per axis on the tensor
    cores; otherwise as ``blur_fused_u8_hybrid``.
    ``blur_fused_u8_bf16.launches`` counts kernel launches.

    Accuracy against the plain version (``blur_fused_u8_bf16_ref``, which
    sums tap by tap in ascending order with one f32 rounding a tap). Every
    product bf16(r_t) x and bf16(c_t) y is exact in f32; the kernel sums the
    same products in another order and grouping (k-steps of 16 on the
    tensor cores). (1) Rows: each f32 sum lies within eps = 2^-21 (2 rw + 1)
    sum_t |r_t| x[t] of the exact sum E (a k-step's sum and the running sum
    each lose at most 2^-22 of the sum of magnitudes so far, with room for
    truncating adds), so both round to bf16 within [bf16(E - eps), bf16(E +
    eps)]: equal, unless E lies within eps of a rounding boundary, where
    they may take the two neighbours, one bf16 step apart (1.0 for y in
    [128, 256)). (2) Columns: a step d_t in the y that output i reads at tap
    t moves it by |c_t| d_t; the two column sums of the same y agree within
    ``COLS_TOL`` = 2e-2 at 0..255 scale (the hybrid body's contract, the same
    instruction and grouping). So |got - want| <= 2e-2 + sum_t |c_t| d_t
    (``bf16_bound``), which is 2e-2 where no y an output reads is that close
    to a boundary, and 2e-2 + |c_t| where one is (at most 2e-2 + max |c|
    with one such y, the usual case at the card's sizes). On the uint8
    store that is within 1 count. The forms are bit-identical to each other:
    a k-step of the rows sum is 16 bytes aligned to the image row in every
    form, and the column sum is the hybrid's, grouped by each output's own
    tap index."""
    return _run_form(blur_fused_u8_bf16, "direct", planar_u8, plan, "bf16", out_u8, tile)


blur_fused_u8_bf16.launches = 0


def blur_fused_u8_strip(planar_u8: torch.Tensor, plan: BlurPlan, precision: str = "int8",
                        out_u8: bool = True,
                        tile: tuple[int, int] | None = None) -> torch.Tensor:
    """K1s, the strip form (the JAX ``_kernel_strip``): one block per row
    strip walks its column windows and carries the halo columns, so each
    input byte of a strip is read once. Bodies int8, hybrid and bf16; raises
    ``ValueError`` where ``k1_geometry("strip", ...)`` does not fit. A CPU
    tensor runs the body's plain version. ``blur_fused_u8_strip.launches``
    counts kernel launches."""
    return _run_form(blur_fused_u8_strip, "strip", planar_u8, plan, precision, out_u8, tile)


blur_fused_u8_strip.launches = 0


def blur_fused_u8_resident(planar_u8: torch.Tensor, plan: BlurPlan,
                           precision: str = "int8", out_u8: bool = True,
                           tile: tuple[int, int] | None = None) -> torch.Tensor:
    """K1r, the rows-resident form (the JAX ``_kernel_resident``): one block
    per column window walks down the frame with the rows output of the last
    ``th + 2rh`` rows in a ring, so each rows value is computed once. Bodies
    int8 and hybrid; ``ValueError`` for bf16 or where the ring does not fit.
    A CPU tensor runs the body's plain version.
    ``blur_fused_u8_resident.launches`` counts kernel launches."""
    return _run_form(blur_fused_u8_resident, "resident", planar_u8, plan, precision, out_u8,
                     tile)


blur_fused_u8_resident.launches = 0


def blur_fused_u8_assembled(frame: torch.Tensor, plan: BlurPlan, precision: str = "int8",
                            out_u8: bool = True,
                            tile: tuple[int, int] | None = None) -> torch.Tensor:
    """K1a, the assembled form (the JAX ``_kernel``): uint8 ``(..., hp, wp)``
    frames that ``assemble.assemble_padded`` made at
    ``k1_geometry("assembled", ...)``'s ``(hp, wp)`` with the planes at
    ``(rh, rw)`` -> ``(..., H, W)``. Every window is a plain 16-byte aligned
    rectangle of the frame. A CPU frame runs ``blur_fused_u8_padded_ref``.
    ``blur_fused_u8_assembled.launches`` counts kernel launches."""
    return _run_assembled(blur_fused_u8_assembled, "assembled", frame, plan, precision,
                          out_u8, tile)


blur_fused_u8_assembled.launches = 0


def blur_fused_u8_pipelined(frame: torch.Tensor, plan: BlurPlan, out_u8: bool = True,
                            tile: tuple[int, int] | None = None) -> torch.Tensor:
    """K1a's pipelined variant (the JAX ``_kernel_pipe``, int8): as
    ``blur_fused_u8_assembled`` at ``k1_geometry("pipelined", ...)``, with
    each block walking ``PIPELINE_SEG`` windows and running window j's rows
    pass beside window j-1's cols pass. ``blur_fused_u8_pipelined.launches``
    counts kernel launches."""
    return _run_assembled(blur_fused_u8_pipelined, "pipelined", frame, plan, "int8",
                          out_u8, tile)


blur_fused_u8_pipelined.launches = 0


def blur_fused_haloed_dma(planar, plan: BlurPlan, precision: str = "int8",
                          out_u8: bool = False,
                          tile: tuple[int, int] | None = None) -> torch.Tensor:
    """K1a on rows that carry the caller's halo rows (the JAX function of the
    same name, ``_blur_fused_dma_impl``'s ``rows_prepadded`` mode): uint8
    ``(..., H + 2rh, W)``, the extra rows another shard's
    (``parallel/sharded.py``) -> ``(..., H, W)``, float32 (the JAX default)
    or uint8 (``out_u8``), with K1's ``precision`` body. ``planar`` is one
    tensor, as in the JAX package, or an ``assemble.HaloedRows``: the
    shard's block and halo rows where they lie.

    A4 (``assemble.assemble_padded_prepad``) builds the frame that
    ``k1_geometry("assembled", ...)`` sizes, with the caller's rows from its
    top row, where A5 would put reflected rows, and reflect-101 columns; K1a
    (``blur_fused_u8_assembled``) runs on it unchanged. As in the JAX
    package, no other form and no form rule is consulted for such rows.
    ``tile`` pins K1a's ``(th, tw)`` tile; it is kept to match the JAX
    signature, and the sharded path leaves it to ``k1_geometry``. CPU rows
    run A4's plain version and ``blur_fused_u8_padded_ref``; any other
    device, a non-contiguous CUDA tensor, rows A4 cannot read in place, or
    a plan outside the body's domain raises."""
    if precision not in RUNGS:
        raise ValueError(f"K1's bodies are {RUNGS}, not {precision!r}")
    if planar.dtype != torch.uint8:
        raise TypeError(f"expected uint8 planes, got {planar.dtype}")
    _check_body(plan, precision, out_u8)
    h, w = plan.shape
    rh, rw = plan.col.support_radius, plan.row.support_radius
    shape = planar.shape
    if len(shape) < 2 or tuple(shape[-2:]) != (h + 2 * rh, w):
        raise ValueError(f"planes of shape {tuple(shape)} do not carry {rh} halo "
                         f"rows each side of the plan's {plan.shape}")
    if planar.device.type == "cuda":
        if not isinstance(planar, HaloedRows):
            _check_cuda("K1a", planar)
    elif planar.device.type != "cpu":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, not {planar.device}")
    geo = _form_geometry("assembled", precision, plan, math.prod(shape[:-2]), tile,
                         planar.device)
    frame = assemble_padded_prepad(planar, rw, rw, geo.hp, geo.wp)
    return blur_fused_u8_assembled(frame, plan, precision, out_u8, tile)
