"""The fused separable blur of float or uint8 planes (K2), and the int8
path's fixed-point tap quantisation.

The port of the JAX package's ``pallas_kernels/fused_blur.py``:

- ``blur_fused_f32`` launches K2, the CUDA kernel of ``csrc/fused_blur.cu``,
  on a CUDA tensor and runs its plain PyTorch version ``blur_fused_f32_ref``
  on a CPU tensor. K2 replaces the Pallas kernel ``_kernel`` on its bf16x3
  branch (and K1's ``_tile_bf16x3`` body, which has the same numerics): f32
  or uint8 planes in, f32 or uint8 out, any odd taps per axis, support
  radius 0..600 per axis. The TPU runs each pass as a band matrix product
  in hi/lo bfloat16 split dots; K2 runs it as a band product on the H100's
  TF32 tensor cores in hi/lo tf32 halves (3xTF32: ``hi Thi + hi Tlo + lo
  Thi``, two products for uint8 input, which is exact in tf32), about 21
  bits a product. The band tables ``Thi`` / ``Tlo`` are split once on the
  host (``tc_table``, cached per plan by ``_device_tables``), laid out as
  the kernel reads them. The plain version ``blur_fused_f32_ref`` rounds
  tap by tap in ascending order (an exact float64 product and sum, rounded
  to f32 after every tap) and stays the kernels' reference: they agree
  within ``1e-3 * max|x| / 255`` (f32) and 1 count (uint8).
  ``blur_fused_f32_tc_model`` is a plain model of the kernels' 3xTF32
  arithmetic (tf32 rounding by bit arithmetic, the same tables, each
  output's products summed in float64 and rounded once to f32), which the
  CPU tests hold against the reference and the JAX kernel; no route runs it.
- ``blur_fused`` is the differentiable float entry (a
  ``torch.autograd.Function``: forward K2, backward ``ops.adjoint.
  blur_adjoint``), the counterpart of the JAX ``custom_vjp``
  ``_blur_fused_diff``; ``blur_fused_u8`` runs K1 where the exact int8 path
  applies, else K2 with a uint8 store.
- The quantiser, the adaptive scale picker and the int8 applicability rule
  are copied so that K1's operands are integer-identical to the JAX
  kernel's.
- The two-pass wide-radius split (``_blur_fused_split``, copied from
  ``fused_blur.py:723-946``): the plan's rows axis, then its columns axis,
  each as its own pass through memory. On uint8 frames with non-negative
  unit-sum taps both passes run int8 through an int16 intermediate ``E``
  (``cuda_kernels/fused_split.py``); otherwise pass 1 is the int8 rows
  form with an f32 result, or the f32 single-axis form, and pass 2 the f32
  single-axis form (``blur_fused_axis_f32``, K2's wide form in
  ``csrc/fused_blur.cu``, the same 3xTF32 band product with its window
  streamed in chunks). ``blur_fused`` and ``blur_fused_u8`` take the
  split past ``MAX_RADIUS`` and, where the device measured it faster, from
  ``DeviceSpec.fused_split_min_radius`` (``fused_split_min_radius_u8`` on
  K1's uint8 path); it reaches ``SPLIT_MAX_RADIUS``.
  Past that every entry raises ``ValueError``, as the JAX ``_pick_tile``
  does: the FFT engines (``fft_mxu``, ``fft_stream``, strip-streamed past
  their byte budget, ``ops/streamed``) and the cascade serve such radii.
- The haloed entry points (``blur_fused_haloed``, ``_blur_fused_haloed_split``,
  ``haloed_fused_feasible``; ``fused_blur.py:1047-1190``): the sharded
  path's per-shard step on ``(..., H + 2 rh, W)`` rows whose extra rows
  came from the neighbouring shards. K2 and its single-axis form, and the
  split's cols passes, take ``pre_padded_col=True`` for it (the JAX mode of
  that name): those rows are read as they are, only the columns reflect.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from blur_algorithms_tpu_torch.ops.adjoint import blur_adjoint
from blur_algorithms_tpu_torch.ops.pad import reflect_101
from blur_algorithms_tpu_torch.ops.plan import BlurPlan
from blur_algorithms_tpu_torch.utils.hw import device_spec

__all__ = [
    "MAX_RADIUS",
    "SPLIT_MAX_RADIUS",
    "blur_fused",
    "blur_fused_axis_f32",
    "blur_fused_f32",
    "blur_fused_f32_ref",
    "blur_fused_f32_tc_model",
    "blur_fused_haloed",
    "blur_fused_u8",
    "e32_split_applicable",
    "haloed_fused_feasible",
    "int8_applicable",
    "pick_int8_scale",
    "split_feasible",
    "split_hbm_bytes",
    "tc_table",
]

# Largest support radius K2 serves per axis: the JAX single-kernel DMA
# form's domain (as for K1), so every routed call has a JAX counterpart.
MAX_RADIUS = 600
# Largest support radius per axis of the two-pass split and of K2's
# single-axis wide form: the JAX split's reach (measured feasible to 4096)
# and above the cascade engine's step limit of 4000.
SPLIT_MAX_RADIUS = 4096

# past the split's reach: the JAX ``_pick_tile_wide`` refusal, a ValueError
_PAST_SPLIT = "no fused tile serves it; use the fft_mxu, fft_stream or cascade engine"

# Fixed-point scale for the int8 path: taps quantized to q = round(t * S).
# S = 127 * 128 keeps q = 128*q_hi + q_lo with both planes <= 127 (int8) for
# any tap t <= 1, giving 14-bit tap precision and exact column sums after
# renormalization (DC-exact). Both passes scale ADAPTIVELY — bounded by the
# LARGEST tap, not tap count, so wide smooth kernels (tiny taps) get far
# finer precision:
#   * rows: scale restricted to S << m so the 14-bit re-quantized
#     intermediate E = round(R / (128 * 2^m)) is a pure int32 shift
#   * cols: arbitrary adaptive scale; per-part f32 recombine
_INT8_SCALE = 127 * 128
_INT8_MAX_SCALE = 1 << 23  # |rows accumulator| <= 128 * scale must fit int32


def _quantize_band_int8(mat: np.ndarray, scale: int = _INT8_SCALE) -> np.ndarray:
    """Band matrix -> int32 fixed-point, every column summing to ``scale``.

    Column sums of a reflect-valid band matrix are 1 (taps normalized), so
    forcing ``sum(q) == scale`` makes constant inputs exact. The correction
    spreads as +/-1 over the in-band entries with the largest same-direction
    rounding residual — never dumped onto a single tap (which would distort
    it by up to ~0.5 * width q-units on wide kernels).
    """
    if np.any(mat < 0):
        raise ValueError("int8 precision requires non-negative taps")
    t = mat.astype(np.float64) * scale
    q = np.round(t).astype(np.int64)
    res = t - q  # rounding residual, in [-0.5, 0.5]
    err = scale - q.sum(axis=0)
    for j in np.nonzero(err)[0]:
        e = int(err[j])
        s = 1 if e > 0 else -1
        cand = np.nonzero(mat[:, j] > 0)[0]  # in-band entries only
        order = np.argsort(-s * res[cand, j], kind="stable")
        q[cand[order[: abs(e)]], j] += s
    if q.max() >= 1 << 14 or q.min() < 0:
        raise ValueError("int8 tap quantization out of range")
    return q.astype(np.int32)


def pick_int8_scale(taps: np.ndarray, pow2: bool = False) -> int:
    """Adaptive tap scale: largest value keeping the biggest quantized tap
    within the 14-bit two-plane budget.

    ``pow2=True`` restricts the result to ``_INT8_SCALE << m`` (m <= 9) so
    the intermediate re-quantization ``round(R / (128 * 2^m))`` is a pure
    int32 shift in the kernel.
    """
    t_max = float(np.max(taps))
    if t_max <= 0:
        return _INT8_SCALE
    if pow2:
        # leave 1 q-unit of headroom below 2^14: the quantizer's +/-1
        # residual spread may land on the max tap
        m = 0
        while m < 9 and round(t_max * (_INT8_SCALE << (m + 1))) < (1 << 14) - 1:
            m += 1
        return _INT8_SCALE << m
    return max(_INT8_SCALE, min(_INT8_MAX_SCALE, int(_INT8_SCALE / t_max)))


@functools.lru_cache(maxsize=256)
def int8_applicable(plan: BlurPlan, dtype: torch.dtype) -> bool:
    """int8 precision needs a uint8 input, row radius >= 1, and >= 0 taps.

    The taps must also sum to 1: the recentering identity
    ``R = scale * (conv - 128)`` assumes it (blur plans always do; custom
    plans may not be normalized). Cached per plan: every K1 launch asks.
    """
    return (
        dtype == torch.uint8
        and plan.row.support_radius > 0
        and float(np.min(plan.row.taps)) >= 0.0
        and float(np.min(plan.col.taps)) >= 0.0
        and abs(float(np.sum(plan.row.taps)) - 1.0) < 1e-5
        and abs(float(np.sum(plan.col.taps)) - 1.0) < 1e-5
    )


# ---------------------------------------------------------------------------
# K2: the fused separable f32 blur


def _check_planes(planar: torch.Tensor, plan: BlurPlan,
                  pre_padded_col: bool = False) -> None:
    if planar.dtype not in (torch.float32, torch.uint8, torch.float64):
        raise TypeError(f"K2 takes float32 or uint8 planes, got {planar.dtype}")
    rh, rw = plan.col.support_radius, plan.row.support_radius
    h, w = plan.shape
    if planar.ndim < 2 or tuple(planar.shape[-2:]) != ((h + 2 * rh, w) if pre_padded_col
                                                        else (h, w)):
        raise ValueError(
            f"planes of shape {tuple(planar.shape)} do not match the "
            f"plan's {plan.shape}"
            + (f" with {rh} halo rows each side (pre_padded_col)" if pre_padded_col else "")
        )
    if max(rh, rw) > SPLIT_MAX_RADIUS:
        raise ValueError(f"support radius {max(rh, rw)} > {SPLIT_MAX_RADIUS}: {_PAST_SPLIT}")
    if min(rh, rw) > 0 and max(rh, rw) > MAX_RADIUS:
        raise NotImplementedError(
            f"support radius {max(rh, rw)} > {MAX_RADIUS} on two axes is past "
            "K2's domain: blur_fused runs the two-pass split"
        )


def _store_u8(acc: torch.Tensor) -> torch.Tensor:
    """f32 -> uint8 as ``clip(x + 0.5, 0, 255.5)`` and truncation (the JAX
    ``_store_u8``; after the clip truncation is floor)."""
    acc = torch.clamp(torch.add(acc, 0.5), 0.0, 255.5)
    return acc.to(torch.int32).to(torch.uint8)


def _correlate_ref(x: torch.Tensor, taps: np.ndarray, axis: int,
                   dtype: torch.dtype, padded: bool = False) -> torch.Tensor:
    """Reflect-101 correlation along ``axis``, tap by tap in ascending order;
    with ``padded`` the axis already carries its ``r`` border values each
    side (the caller's halo rows) and the correlation is taken as it is
    (``2r`` fewer outputs, nothing reflected).

    In float32 every tap is one fused multiply-add: the product of two
    float32 values is exact in float64, so the float64 sum rounded to
    float32 is one ``fmaf`` (but for a rare double rounding, one ulp). A
    radius-0 axis is skipped (a copy)."""
    r = (int(taps.shape[0]) - 1) // 2
    if r == 0:
        return x.to(dtype)
    axis %= x.ndim
    n = x.shape[axis] - (2 * r if padded else 0)
    xp = (x if padded else reflect_101(x, [(r, r)], axes=[axis])).to(torch.float64)
    acc = torch.zeros((*x.shape[:axis], n, *x.shape[axis + 1:]), dtype=dtype,
                      device=x.device)
    for t, tap in enumerate(taps.tolist()):
        acc = torch.add(acc.to(torch.float64), xp.narrow(axis, t, n), alpha=tap)
        acc = acc.to(dtype)
    return acc


def blur_fused_f32_ref(planar: torch.Tensor, plan: BlurPlan, out_u8: bool = False,
                       pre_padded_col: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K2: ``(..., H, W)`` float32 or uint8 ->
    float32, or uint8 with ``out_u8``.

    Rows pass, then cols pass, each a reflect-101 gather and a tap-by-tap
    accumulation rounded to float32 after every tap (float64 input stays
    float64 throughout, for gradient checks). ``pre_padded_col`` (the JAX
    ``_blur_fused_planar`` mode of that name): the input is ``(..., H +
    2 rh, W)``, its extra rows the caller's halo rows; the rows pass runs
    over all of them and the cols pass reads them as they are. Runs on
    whatever device the input lies on.
    """
    _check_planes(planar, plan, pre_padded_col)
    dtype = torch.float64 if planar.dtype == torch.float64 else torch.float32
    x = planar.reshape(-1, *planar.shape[-2:])
    y = _correlate_ref(x, plan.row.taps, -1, dtype)
    y = _correlate_ref(y, plan.col.taps, -2, dtype, padded=pre_padded_col)
    if out_u8:
        y = _store_u8(y.to(torch.float32))
    return y.reshape(*planar.shape[:-2], *plan.shape)


# ---------------------------------------------------------------------------
# the kernels' 3xTF32 band tables, and a plain model of their arithmetic


def band_steps(r: int) -> int:
    """k-steps of 8 window positions that cover a radius-r band for 8
    consecutive outputs (``csrc/fused_blur.cu:band_steps``)."""
    return (2 * r + 15) // 8


def _tf32_bits(bits):
    """float32 bit patterns (int32) -> those of the nearest tf32 value, ties
    away from zero (``cvt.rna.tf32.f32`` on a finite value): add half of the
    13 dropped mantissa bits' range to the magnitude, then clear them."""
    return (bits + 0x1000) & -0x2000


def _tf32(x: torch.Tensor) -> torch.Tensor:
    return _tf32_bits(x.to(torch.float32).contiguous().view(torch.int32)).view(torch.float32)


def tc_table(taps: np.ndarray) -> np.ndarray:
    """The band table of one axis's ``2r + 1`` taps as the kernels read it:
    ``Thi`` then ``Tlo``, ``8 S + 8`` float32 values each (``S =
    band_steps(r)``), tap ``t`` at ``7 + t`` and zeros elsewhere; ``Thi``
    is the tf32 rounding of the f32 tap, ``Tlo`` that of the remainder
    (``Thi + Tlo`` is the tap to 2^-23 of it). The lane ``(g, tig)`` of a
    warp reads the band entries ``B[tig][g]`` and ``B[tig + 4][g]`` of step
    ``s`` at ``7 + 8 s + tig - g`` and 4 past it."""
    t = np.asarray(taps, np.float32)
    r = (t.shape[0] - 1) // 2
    n = 8 * band_steps(r) + 8
    hi = _tf32_bits(t.view(np.int32)).view(np.float32)
    lo = _tf32_bits((t - hi).view(np.int32)).view(np.float32)
    table = np.zeros(2 * n, np.float32)
    table[7 : 8 + 2 * r] = hi
    table[n + 7 : n + 8 + 2 * r] = lo
    return table


@functools.lru_cache(maxsize=64)
def _device_tables(plan: BlurPlan, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``tc_table`` of the row and column taps on ``device``."""
    return tuple(torch.from_numpy(tc_table(t)).to(device)
                 for t in (plan.row.taps, plan.col.taps))


def _correlate_tc(x: torch.Tensor, taps: np.ndarray, axis: int,
                  padded: bool) -> torch.Tensor:
    """One pass of the kernels' arithmetic: the reflect-101 (or pre-padded)
    window split into tf32 halves, the 3xTF32 products with ``tc_table``'s
    halves summed in float64 and rounded to f32 once; radius 0 a copy."""
    r = (int(taps.shape[0]) - 1) // 2
    if r == 0:
        return x.to(torch.float32)
    axis %= x.ndim
    n = x.shape[axis] - (2 * r if padded else 0)
    xp = (x if padded else reflect_101(x, [(r, r)], axes=[axis])).to(torch.float32)
    hi = _tf32(xp)
    lo = _tf32(xp - hi)
    hi, lo = hi.to(torch.float64), lo.to(torch.float64)
    table = tc_table(taps).astype(np.float64)
    m = table.shape[0] // 2
    acc = torch.zeros((*x.shape[:axis], n, *x.shape[axis + 1:]), dtype=torch.float64,
                      device=x.device)
    for t in range(2 * r + 1):
        th, tl = float(table[7 + t]), float(table[m + 7 + t])
        acc += hi.narrow(axis, t, n) * (th + tl) + lo.narrow(axis, t, n) * th
    return acc.to(torch.float32)


def blur_fused_f32_tc_model(planar: torch.Tensor, plan: BlurPlan, out_u8: bool = False,
                            pre_padded_col: bool = False) -> torch.Tensor:
    """A plain model of the kernels' 3xTF32 arithmetic, for tests: as
    ``blur_fused_f32_ref`` (float32 or uint8 in, float32 or uint8 out,
    ``pre_padded_col``), each pass ``hi Thi + hi Tlo + lo Thi`` over
    ``tc_table``'s halves, summed exactly and rounded to f32 once per
    output. The tensor core's own order and rounding of each k-step's sum
    are not modelled (about one f32 rounding per step)."""
    _check_planes(planar, plan, pre_padded_col)
    x = planar.reshape(-1, *planar.shape[-2:])
    y = _correlate_tc(x, plan.row.taps, -1, False)
    y = _correlate_tc(y, plan.col.taps, -2, pre_padded_col)
    if out_u8:
        y = _store_u8(y)
    return y.reshape(*planar.shape[:-2], *plan.shape)


def blur_fused_f32(planar: torch.Tensor, plan: BlurPlan, out_u8: bool = False,
                   pre_padded_col: bool = False) -> torch.Tensor:
    """``(..., H, W)`` float32 or uint8 -> float32 (or uint8 with
    ``out_u8``), the fused separable blur (K2).

    ``pre_padded_col``: the input is ``(..., H + 2 rh, W)``, whose extra
    rows are the caller's halo rows (another shard's rows,
    ``parallel/sharded.py``); the kernel reads them as they are and reflects
    only the columns (the JAX ``pre_padded_col``). A CUDA tensor launches the
    kernel of ``csrc/fused_blur.cu`` (3xTF32 band products on the tensor
    cores, over ``tc_table``'s tables); a CPU tensor runs the plain version. A
    plan with one radius-0 axis past ``MAX_RADIUS`` runs the single-axis wide
    form (``blur_fused_axis_f32``). Any other device, a non-contiguous or
    float64 CUDA tensor, or two axes past ``MAX_RADIUS`` raises.
    ``blur_fused_f32.launches`` counts kernel launches.
    """
    _check_planes(planar, plan, pre_padded_col)
    if max(plan.col.support_radius, plan.row.support_radius) > MAX_RADIUS:
        return blur_fused_axis_f32(planar, plan, out_u8, pre_padded_col)
    x = _k2_input(planar, "K2")
    if x is None:
        return blur_fused_f32_ref(planar, plan, out_u8, pre_padded_col)
    from blur_algorithms_tpu_torch.utils.build import load_library

    h, w = plan.shape
    out = torch.empty((x.shape[0], h, w), dtype=torch.uint8 if out_u8 else torch.float32,
                      device=x.device)
    if x.shape[0]:
        taps_row, taps_col = _device_tables(plan, x.device)
        lib = load_library()
        with torch.cuda.device(x.device):
            rc = lib.blur_fused_f32(
                x.data_ptr(), out.data_ptr(), taps_row.data_ptr(),
                taps_col.data_ptr(), int(x.dtype == torch.uint8), int(out_u8),
                int(pre_padded_col), x.shape[0], h, w, plan.col.support_radius,
                plan.row.support_radius, torch.cuda.current_stream(x.device).cuda_stream,
            )
        if rc:
            msg = lib.blur_cuda_error_string(rc).decode()
            raise RuntimeError(f"K2 launch failed: CUDA error {rc} ({msg})")
        blur_fused_f32.launches += 1
    return out.reshape(*planar.shape[:-2], h, w)


blur_fused_f32.launches = 0


def _k2_input(planar: torch.Tensor, name: str) -> torch.Tensor | None:
    """The ``(planes, rows, W)`` view a K2 launch takes, or None for a CPU
    tensor (the plain version runs); raises where no launch is possible."""
    if planar.device.type == "cpu":
        return None
    if planar.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {planar.device}")
    if planar.dtype == torch.float64:
        raise TypeError(f"{name} takes float32 or uint8 planes on a CUDA device")
    if not planar.is_contiguous():
        raise ValueError(f"{name} needs contiguous planes")
    x = planar.reshape(-1, *planar.shape[-2:])
    if x.shape[0] > 65535:
        raise ValueError(f"{name} takes at most 65535 planes, got {x.shape[0]}")
    return x


def blur_fused_axis_f32(planar: torch.Tensor, plan: BlurPlan, out_u8: bool = False,
                        pre_padded_col: bool = False) -> torch.Tensor:
    """K2's single-axis wide form: ``(..., H, W)`` float32 or uint8 ->
    float32 (or uint8 with ``out_u8``) for a plan with one radius-0 axis,
    the other up to ``SPLIT_MAX_RADIUS`` (the two-pass split's passes).
    ``pre_padded_col``: a columns pass over ``(..., H + 2 rh, W)`` whose
    extra rows are the caller's halo rows, read as they are (the haloed
    split's pass 2).

    A CUDA tensor launches ``blur_fused_axis_f32`` of ``csrc/fused_blur.cu``
    (a radius-0 plan is a copy, with no launch); a CPU tensor runs the plain
    version ``blur_fused_f32_ref``. ``blur_fused_axis_f32.launches`` counts
    kernel launches.
    """
    _check_planes(planar, plan, pre_padded_col)
    rh, rw = plan.col.support_radius, plan.row.support_radius
    if min(rh, rw) != 0:
        raise ValueError("the single-axis form takes a plan with a radius-0 axis")
    x = _k2_input(planar, "K2's single-axis form")
    if x is None or max(rh, rw) == 0:
        return blur_fused_f32_ref(planar, plan, out_u8, pre_padded_col)
    from blur_algorithms_tpu_torch.utils.build import load_library

    h, w = plan.shape
    out = torch.empty((x.shape[0], h, w), dtype=torch.uint8 if out_u8 else torch.float32,
                      device=x.device)
    if x.shape[0]:
        taps = _device_tables(plan, x.device)[0 if rw else 1]
        lib = load_library()
        with torch.cuda.device(x.device):
            rc = lib.blur_fused_axis_f32(
                x.data_ptr(), out.data_ptr(), taps.data_ptr(),
                int(x.dtype == torch.uint8), int(out_u8), int(pre_padded_col), x.shape[0],
                h, w, int(rw > 0), max(rh, rw),
                torch.cuda.current_stream(x.device).cuda_stream,
            )
        if rc:
            msg = lib.blur_cuda_error_string(rc).decode()
            raise RuntimeError(f"K2's single-axis form failed: CUDA error {rc} ({msg})")
        blur_fused_axis_f32.launches += 1
    return out.reshape(*planar.shape[:-2], h, w)


blur_fused_axis_f32.launches = 0


# ---------------------------------------------------------------------------
# the two-pass wide-radius split


def _axis_identity(ax) -> object:
    """Radius-0 copy of an AxisPlan (taps [1]) for one pass of split mode."""
    return dataclasses.replace(
        ax, width=1, pad=0, taps=np.array([1.0], np.float32),
        spectrum_c=None,  # identity taps are symmetric
    )


@functools.lru_cache(maxsize=256)  # plans hash by identity
def _split_plans(plan: BlurPlan) -> tuple[BlurPlan, BlurPlan]:
    rows_only = dataclasses.replace(plan, col=_axis_identity(plan.col))
    cols_only = dataclasses.replace(plan, row=_axis_identity(plan.row))
    return rows_only, cols_only


def split_feasible(plan: BlurPlan, in_bytes: int = 1) -> bool:
    """True if both single-axis passes of the split serve the plan (the
    JAX test is a VMEM tile search; here each pass stages a bounded slice,
    so only the radius bounds it)."""
    return max(plan.col.support_radius, plan.row.support_radius) <= SPLIT_MAX_RADIUS


def e32_split_applicable(plan: BlurPlan, precision, in_bytes: int) -> bool:
    """True when the split runs int8 end to end via the int16-E
    intermediate (pass 1 rows-only int8, pass 2 cols-only int8)."""
    if precision != "int8" or in_bytes != 1:
        return False
    rows_plan, _ = _split_plans(plan)
    return (
        int8_applicable(rows_plan, torch.uint8)
        and plan.col.support_radius > 0
        and float(np.min(plan.col.taps)) >= 0.0
        # the cols recombine (+128) and quantizer renormalization assume
        # unit-sum taps, same as int8_applicable's check for the full form
        and abs(float(np.sum(plan.col.taps)) - 1.0) < 1e-5
    )


def split_hbm_bytes(plan: BlurPlan, in_bytes: int = 1, precision=None) -> int:
    """Peak-memory estimate of the split on a channel-planar RGB frame, as
    the JAX function of the same name: input + the intermediate (int16 E on
    the int8-e32 path, f32 otherwise) + a reflect-padded copy of it + the
    output."""
    h, w = plan.shape
    rh = plan.col.support_radius
    px = 3 * h * w
    ib = 2 if e32_split_applicable(plan, precision, in_bytes) else 4
    return int(px * (in_bytes + ib + ib * (h + 2 * rh + 2048) / h + in_bytes))


def _split_wins(plan: BlurPlan, in_bytes: int, precision,
                device: torch.device | str) -> bool:
    """Two single-axis passes through memory against one fused kernel.

    Past ``MAX_RADIUS`` the single kernels do not serve, so the split runs.
    Below it the split runs only from the device's measured
    ``fused_split_min_radius`` (the chip_smoke.py phase 13 sweep in turns,
    in place of the JAX package's TPU cost model), on K1's uint8 path
    (``in_bytes`` 1, ``precision`` "int8") from its own
    ``fused_split_min_radius_u8`` where the device has one, and within its
    memory budget."""
    r = max(plan.col.support_radius, plan.row.support_radius)
    if r > MAX_RADIUS:
        return True
    spec = device_spec(device)
    floor = spec.fused_split_min_radius
    if in_bytes == 1 and precision == "int8" and spec.fused_split_min_radius_u8 is not None:
        floor = spec.fused_split_min_radius_u8
    return (floor is not None and r >= floor
            and split_hbm_bytes(plan, in_bytes, precision) <= spec.split_hbm_budget)


def _hybrid_cols_ok(plan: BlurPlan, device: torch.device | str) -> bool:
    """The device-certified gate of the split's hybrid pass 2 (the JAX
    function of the same name): gaussian or box taps, the min-axis radius at
    or past the device's hybrid floor for the tap family and the max-axis
    radius within its split ceiling for that family."""
    spec = device_spec(device)
    floor = spec.hybrid_min_radius_for(plan.kernel)
    ceiling = spec.hybrid_split_cert_max_radius_for(plan.kernel)
    return (
        floor is not None
        and ceiling is not None
        and plan.kernel in ("gaussian", "box_fast")
        and min(plan.col.support_radius, plan.row.support_radius) >= floor
        and max(plan.col.support_radius, plan.row.support_radius) <= ceiling
    )


def _blur_fused_split(planar: torch.Tensor, plan: BlurPlan, precision,
                      out_u8: bool) -> torch.Tensor:
    """The plan's rows axis, then its columns axis, as two passes through
    memory; the JAX ``_blur_fused_split`` pass for pass."""
    if not split_feasible(plan):
        r = max(plan.col.support_radius, plan.row.support_radius)
        raise ValueError(f"support radius {r} > {SPLIT_MAX_RADIUS}: {_PAST_SPLIT}")
    from blur_algorithms_tpu_torch.cuda_kernels import fused_split

    rows_plan, cols_plan = _split_plans(plan)
    is_u8 = planar.dtype == torch.uint8
    if e32_split_applicable(plan, precision, 1 if is_u8 else 4):
        e = fused_split.fused_split_rows_int8(planar, rows_plan, out_e32=True)
        pass2 = (fused_split.fused_split_cols_hybrid
                 if _hybrid_cols_ok(plan, planar.device)
                 else fused_split.fused_split_cols_int8)
        return pass2(e, cols_plan, out_u8=out_u8)
    # pass 1 reads the raw uint8 frame: the int8 rows form applies even
    # where the full int8 path does not (pass 2 reads f32)
    if precision == "int8" and is_u8 and int8_applicable(rows_plan, torch.uint8):
        y = fused_split.fused_split_rows_int8(planar, rows_plan, out_e32=False)
    else:
        y = blur_fused_axis_f32(planar, rows_plan)
    return blur_fused_axis_f32(y, cols_plan, out_u8=out_u8)


class _BlurFusedSplit(torch.autograd.Function):
    """Forward the f32 split, backward the blur's adjoint (the JAX
    ``_blur_fused_split_diff``)."""

    @staticmethod
    def forward(ctx, planar: torch.Tensor, plan: BlurPlan) -> torch.Tensor:
        ctx.plan = plan
        return _blur_fused_split(planar, plan, "bf16x3", out_u8=False)

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        return blur_adjoint(ct, ctx.plan), None


class _BlurFused(torch.autograd.Function):
    """Forward K2, backward the blur's adjoint (it is linear, so the VJP
    needs no saved tensors): the counterpart of the JAX ``custom_vjp``."""

    @staticmethod
    def forward(ctx, planar: torch.Tensor, plan: BlurPlan) -> torch.Tensor:
        ctx.plan = plan
        return blur_fused_f32(planar, plan)

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        return blur_adjoint(ct, ctx.plan), None


def blur_fused(planar: torch.Tensor, plan: BlurPlan) -> torch.Tensor:
    """Fused separable blur of planar ``(..., H, W)`` -> float32.

    Float input is differentiable (backward: ``blur_adjoint``); float16 and
    bfloat16 are widened to float32 first. uint8 input runs K2 directly.
    Where ``_split_wins`` (past ``MAX_RADIUS``, or from the device's
    measured split radius) the f32 two-pass split runs instead of K2.
    """
    is_u8 = planar.dtype == torch.uint8
    split = _split_wins(plan, 1 if is_u8 else 4, "bf16x3", planar.device)
    if is_u8:
        if split:
            return _blur_fused_split(planar, plan, "bf16x3", out_u8=False)
        return blur_fused_f32(planar, plan)
    if planar.dtype not in (torch.float32, torch.float64):
        planar = planar.to(torch.float32)
    return (_BlurFusedSplit if split else _BlurFused).apply(planar, plan)


def blur_fused_u8(planar_u8: torch.Tensor, plan: BlurPlan,
                  precision: str = "int8") -> torch.Tensor:
    """uint8 planar ``(..., H, W)`` -> uint8, rounded in the kernel.

    ``"int8"`` runs the exact fixed-point kernel K1 where it applies
    (non-negative unit-sum taps, both support radii >= 1) and falls back to
    ``"bf16x3"`` elsewhere, as the JAX package does; ``"hybrid"`` and
    ``"bf16"`` run K1's body of that name where it applies
    (``fused_dma.dma_form_applicable``) and ``"int8"`` elsewhere, as the JAX
    blocked form does; ``"bf16x3"`` runs K2. K1 runs in the staging form
    the device's rule picks (``fused_dma.blur_fused_u8_dma``). Where
    ``_split_wins`` the two-pass split runs, int8 end to end where
    ``e32_split_applicable``
    (``"hybrid"`` and ``"bf16"`` run it as ``"int8"``), its pass 2 hybrid
    where ``_hybrid_cols_ok``.
    """
    if precision not in ("int8", "hybrid", "bf16", "bf16x3"):
        raise ValueError("precision must be 'int8', 'hybrid', 'bf16' or "
                         f"'bf16x3', got {precision!r}")
    from blur_algorithms_tpu_torch.cuda_kernels import fused_dma

    blocked = "bf16x3" if precision == "bf16x3" else "int8"
    if _split_wins(plan, 1, blocked, planar_u8.device):
        if planar_u8.dtype != torch.uint8:
            raise TypeError(f"expected uint8 planes, got {planar_u8.dtype}")
        return _blur_fused_split(planar_u8, plan, blocked, out_u8=True)
    if (precision in ("hybrid", "bf16")
            and fused_dma.dma_form_applicable(planar_u8.dtype, plan, precision)):
        return fused_dma.blur_fused_u8_dma(planar_u8, plan, precision=precision)
    if (precision != "bf16x3" and int8_applicable(plan, torch.uint8)
            and plan.col.support_radius > 0):
        return fused_dma.blur_fused_u8_dma(planar_u8, plan)
    if planar_u8.dtype != torch.uint8:
        raise TypeError(f"expected uint8 planes, got {planar_u8.dtype}")
    return blur_fused_f32(planar_u8, plan, out_u8=True)


# ---------------------------------------------------------------------------
# the haloed entry points: the sharded path's per-shard step
# (``parallel/sharded.py``), on rows that carry the caller's halo rows


@functools.lru_cache(maxsize=256)  # plans hash by identity
def _haloed_rows_plan(plan: BlurPlan) -> BlurPlan:
    """Rows-only split plan sized to the haloed height ``H + 2 rh`` (the JAX
    function of the same name): the haloed split's pass 1 row-convolves
    every halo row too, since pass 2 reads them as its column context."""
    rows_plan, _ = _split_plans(plan)
    hp = plan.shape[0] + 2 * plan.col.support_radius
    return dataclasses.replace(rows_plan, shape=(hp, plan.shape[1]),
                               col=dataclasses.replace(rows_plan.col, dim=hp))


def _blur_fused_haloed_split(planar: torch.Tensor, plan: BlurPlan, precision,
                             out_u8: bool) -> torch.Tensor:
    """The two-pass split over rows that carry the caller's halo rows (the
    JAX ``_blur_fused_haloed_split``): pass 1 row-convolves all ``H + 2 rh``
    rows, pass 2 reads them as its column context (``pre_padded_col``), with
    ``_blur_fused_split``'s precision rule."""
    if not split_feasible(plan):
        r = max(plan.col.support_radius, plan.row.support_radius)
        raise ValueError(f"support radius {r} > {SPLIT_MAX_RADIUS}: {_PAST_SPLIT}")
    from blur_algorithms_tpu_torch.cuda_kernels import fused_split

    rows_plan_h = _haloed_rows_plan(plan)
    _, cols_plan = _split_plans(plan)
    is_u8 = planar.dtype == torch.uint8
    if e32_split_applicable(plan, precision, 1 if is_u8 else 4):
        e = fused_split.fused_split_rows_int8(planar, rows_plan_h, out_e32=True)
        pass2 = (fused_split.fused_split_cols_hybrid
                 if _hybrid_cols_ok(plan, planar.device)
                 else fused_split.fused_split_cols_int8)
        return pass2(e, cols_plan, out_u8=out_u8, pre_padded_col=True)
    if precision == "int8" and is_u8 and int8_applicable(rows_plan_h, torch.uint8):
        y = fused_split.fused_split_rows_int8(planar, rows_plan_h, out_e32=False)
    else:
        y = blur_fused_axis_f32(planar, rows_plan_h)
    return blur_fused_axis_f32(y, cols_plan, out_u8=out_u8, pre_padded_col=True)


def haloed_fused_feasible(plan: BlurPlan, in_bytes: int = 1, precision=None,
                          device: torch.device | str = "cpu") -> bool:
    """Can ``blur_fused_haloed`` serve this per-shard plan (the JAX function
    of the same name)? The single kernels serve support radii up to
    ``MAX_RADIUS``; past it the haloed split, up to ``SPLIT_MAX_RADIUS`` and
    within the device's ``split_hbm_budget``. The sharded router
    (``parallel/sharded.py``) takes the distributed FFT where this is
    False."""
    if precision == "int8" and (in_bytes != 1 or not int8_applicable(plan, torch.uint8)):
        precision = "bf16x3"
    if max(plan.col.support_radius, plan.row.support_radius) <= MAX_RADIUS:
        return True
    return (split_feasible(plan, in_bytes)
            and split_hbm_bytes(plan, in_bytes, precision)
            <= device_spec(device).split_hbm_budget)


def blur_fused_haloed(planar, plan: BlurPlan, precision="bf16x3",
                      out_u8: bool = False) -> torch.Tensor:
    """Fused blur of ``(..., H + 2 rh, W)`` whose extra rows are the
    caller's halo rows (another shard's, ``parallel/sharded.py``) ->
    ``(..., H, W)``; the columns still reflect. uint8 (``out_u8``) or
    float32. ``planar`` is one tensor, or an ``assemble.HaloedRows``, the
    block and its halo rows where they lie.

    The JAX function of the same name, which takes one tensor and
    ``"int8"`` or ``"bf16x3"``; here ``precision`` is any of
    ``blur_fused_u8``'s rungs and routes as it does, so a shard runs what
    one device would run on its frame: ``"int8"`` needs ``int8_applicable``
    (else ``"bf16x3"``); the haloed split where ``_split_wins`` (int8 end to
    end where ``e32_split_applicable``, ``"hybrid"`` and ``"bf16"`` running
    it as ``"int8"``); else K1's body of that rung on A4's frame
    (``fused_dma.blur_fused_haloed_dma``, which reads a ``HaloedRows`` in
    place) where ``dma_form_applicable`` holds and K1a's block fits, then
    K1's int8 body under the same test (the port's single int8 kernel, as in
    ``blur_fused_u8``); else K2 with ``pre_padded_col``. The split and K2
    take a ``HaloedRows`` as its ``cat()``, one copy."""
    if precision not in ("int8", "hybrid", "bf16", "bf16x3"):
        raise ValueError("precision must be 'int8', 'hybrid', 'bf16' or "
                         f"'bf16x3', got {precision!r}")
    if precision != "bf16x3" and not int8_applicable(plan, planar.dtype):
        precision = "bf16x3"
    is_u8 = planar.dtype == torch.uint8
    blocked = "bf16x3" if precision == "bf16x3" else "int8"
    if _split_wins(plan, 1 if is_u8 else 4, blocked, planar.device):
        return _blur_fused_haloed_split(_one_tensor(planar), plan, blocked, out_u8)
    if precision != "bf16x3":
        from blur_algorithms_tpu_torch.cuda_kernels import fused_dma

        planes = math.prod(planar.shape[:-2])
        for rung in dict.fromkeys((precision, "int8")):
            if (fused_dma.dma_form_applicable(planar.dtype, plan, rung)
                    and fused_dma.k1_geometry("assembled", rung, plan, planes,
                                              device=planar.device) is not None):
                return fused_dma.blur_fused_haloed_dma(planar, plan, rung, out_u8=out_u8)
    return blur_fused_f32(_one_tensor(planar), plan, out_u8=out_u8, pre_padded_col=True)


def _one_tensor(planar) -> torch.Tensor:
    """A ``HaloedRows``' rows as one tensor (its ``cat()``); a tensor as it is."""
    return planar if isinstance(planar, torch.Tensor) else planar.cat()
