"""The fused separable blur of float or uint8 planes (K2), and the int8
path's fixed-point tap quantisation.

The port of the JAX package's ``pallas_kernels/fused_blur.py``:

- ``blur_fused_f32`` launches K2, the CUDA kernel of ``csrc/fused_blur.cu``,
  on a CUDA tensor and runs its plain PyTorch version ``blur_fused_f32_ref``
  on a CPU tensor. K2 replaces the Pallas kernel ``_kernel`` on its bf16x3
  branch (and K1's ``_tile_bf16x3`` body, which has the same numerics): f32
  or uint8 planes in, f32 or uint8 out, any odd taps per axis, support
  radius 0..600 per axis. The TPU emulates f32 with hi/lo bfloat16 split
  dots; K2 accumulates in plain f32 with one fused multiply-add per tap,
  and the plain version reproduces that rounding (an exact float64 product
  and sum, rounded to f32 after every tap).
- ``blur_fused`` is the differentiable float entry (a
  ``torch.autograd.Function``: forward K2, backward ``ops.adjoint.
  blur_adjoint``), the counterpart of the JAX ``custom_vjp``
  ``_blur_fused_diff``; ``blur_fused_u8`` runs K1 where the exact int8 path
  applies, else K2 with a uint8 store.
- The quantiser, the adaptive scale picker and the int8 applicability rule
  are copied so that K1's operands are integer-identical to the JAX
  kernel's.

The two-pass wide-radius split (``_split_wins``, ``_kernel_int8``'s e32
forms) is not ported: past ``MAX_RADIUS`` every entry raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from blur_algorithms_tpu_torch.ops.adjoint import blur_adjoint
from blur_algorithms_tpu_torch.ops.pad import reflect_101
from blur_algorithms_tpu_torch.ops.plan import BlurPlan

__all__ = [
    "MAX_RADIUS",
    "blur_fused",
    "blur_fused_f32",
    "blur_fused_f32_ref",
    "blur_fused_u8",
    "int8_applicable",
    "pick_int8_scale",
]

# Largest support radius K2 serves per axis: the JAX single-kernel DMA
# form's domain (as for K1), so every routed call has a JAX counterpart.
MAX_RADIUS = 600

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


def int8_applicable(plan: BlurPlan, dtype: torch.dtype) -> bool:
    """int8 precision needs a uint8 input, row radius >= 1, and >= 0 taps.

    The taps must also sum to 1: the recentering identity
    ``R = scale * (conv - 128)`` assumes it (blur plans always do; custom
    plans may not be normalized).
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


def _check_planes(planar: torch.Tensor, plan: BlurPlan) -> None:
    if planar.dtype not in (torch.float32, torch.uint8, torch.float64):
        raise TypeError(f"K2 takes float32 or uint8 planes, got {planar.dtype}")
    if planar.ndim < 2 or tuple(planar.shape[-2:]) != plan.shape:
        raise ValueError(
            f"planes of shape {tuple(planar.shape)} do not match the "
            f"plan's {plan.shape}"
        )
    r = max(plan.col.support_radius, plan.row.support_radius)
    if r > MAX_RADIUS:
        raise NotImplementedError(
            f"support radius {r} > {MAX_RADIUS} needs the two-pass wide-radius "
            "split (ROADMAP.md Queue 1 item 6)"
        )


def _store_u8(acc: torch.Tensor) -> torch.Tensor:
    """f32 -> uint8 as ``clip(x + 0.5, 0, 255.5)`` and truncation (the JAX
    ``_store_u8``; after the clip truncation is floor)."""
    acc = torch.clamp(torch.add(acc, 0.5), 0.0, 255.5)
    return acc.to(torch.int32).to(torch.uint8)


def _correlate_ref(x: torch.Tensor, taps: np.ndarray, axis: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """Reflect-101 correlation along ``axis``, tap by tap in ascending order.

    In float32 every tap is one fused multiply-add: the product of two
    float32 values is exact in float64, so the float64 sum rounded to
    float32 is K2's ``fmaf`` (but for a rare double rounding, one ulp). A
    radius-0 axis is skipped (a copy)."""
    r = (int(taps.shape[0]) - 1) // 2
    if r == 0:
        return x.to(dtype)
    n = x.shape[axis]
    xp = reflect_101(x, [(r, r)], axes=[axis]).to(torch.float64)
    acc = torch.zeros(x.shape, dtype=dtype, device=x.device)
    for t, tap in enumerate(taps.tolist()):
        acc = torch.add(acc.to(torch.float64), xp.narrow(axis, t, n), alpha=tap)
        acc = acc.to(dtype)
    return acc


def blur_fused_f32_ref(planar: torch.Tensor, plan: BlurPlan,
                       out_u8: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K2: ``(..., H, W)`` float32 or uint8 ->
    float32, or uint8 with ``out_u8``.

    Rows pass, then cols pass, each a reflect-101 gather and a tap-by-tap
    accumulation rounded to float32 after every tap (float64 input stays
    float64 throughout, for gradient checks). Runs on whatever device the
    input lies on.
    """
    _check_planes(planar, plan)
    h, w = plan.shape
    dtype = torch.float64 if planar.dtype == torch.float64 else torch.float32
    x = planar.reshape(-1, h, w)
    y = _correlate_ref(x, plan.row.taps, -1, dtype)
    y = _correlate_ref(y, plan.col.taps, -2, dtype)
    if out_u8:
        y = _store_u8(y.to(torch.float32))
    return y.reshape(planar.shape)


@functools.lru_cache(maxsize=64)
def _device_taps(plan: BlurPlan, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    return tuple(
        torch.from_numpy(np.array(t, dtype=np.float32)).to(device)
        for t in (plan.row.taps, plan.col.taps)
    )


def blur_fused_f32(planar: torch.Tensor, plan: BlurPlan,
                   out_u8: bool = False) -> torch.Tensor:
    """``(..., H, W)`` float32 or uint8 -> float32 (or uint8 with
    ``out_u8``), the fused separable blur (K2).

    A CUDA tensor launches the kernel of ``csrc/fused_blur.cu``; a CPU tensor
    runs the plain version. Any other device, a non-contiguous or float64
    CUDA tensor, or a radius past ``MAX_RADIUS`` raises.
    ``blur_fused_f32.launches`` counts kernel launches.
    """
    _check_planes(planar, plan)
    if planar.device.type == "cpu":
        return blur_fused_f32_ref(planar, plan, out_u8)
    if planar.device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA or CPU tensors, not {planar.device}")
    if planar.dtype == torch.float64:
        raise TypeError("K2 takes float32 or uint8 planes on a CUDA device")
    if not planar.is_contiguous():
        raise ValueError("K2 needs contiguous planes")
    from blur_algorithms_tpu_torch.utils.build import load_library

    h, w = plan.shape
    x = planar.reshape(-1, h, w)
    if x.shape[0] > 65535:
        raise ValueError(f"K2 takes at most 65535 planes, got {x.shape[0]}")
    out = torch.empty(x.shape, dtype=torch.uint8 if out_u8 else torch.float32,
                      device=x.device)
    if x.shape[0] == 0:
        return out.reshape(planar.shape)
    taps_row, taps_col = _device_taps(plan, x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        rc = lib.blur_fused_f32(
            x.data_ptr(), out.data_ptr(), taps_row.data_ptr(),
            taps_col.data_ptr(), int(x.dtype == torch.uint8), int(out_u8),
            x.shape[0], h, w, plan.col.support_radius, plan.row.support_radius,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc:
        msg = lib.blur_cuda_error_string(rc).decode()
        raise RuntimeError(f"K2 launch failed: CUDA error {rc} ({msg})")
    blur_fused_f32.launches += 1
    return out.reshape(planar.shape)


blur_fused_f32.launches = 0


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
    """
    if planar.dtype == torch.uint8:
        return blur_fused_f32(planar, plan)
    if planar.dtype not in (torch.float32, torch.float64):
        planar = planar.to(torch.float32)
    return _BlurFused.apply(planar, plan)


def blur_fused_u8(planar_u8: torch.Tensor, plan: BlurPlan,
                  precision: str = "int8") -> torch.Tensor:
    """uint8 planar ``(..., H, W)`` -> uint8, rounded in the kernel.

    ``"int8"`` runs the exact fixed-point kernel K1 where it applies
    (non-negative unit-sum taps, both support radii >= 1) and falls back to
    ``"bf16x3"`` elsewhere, as the JAX package does; ``"bf16x3"`` runs K2.
    """
    if precision not in ("int8", "bf16x3"):
        raise ValueError(f"precision must be 'int8' or 'bf16x3', got {precision!r}")
    if (precision == "int8" and int8_applicable(plan, torch.uint8)
            and plan.col.support_radius > 0):
        from blur_algorithms_tpu_torch.cuda_kernels.fused_dma import (
            blur_fused_u8_dma,
        )

        return blur_fused_u8_dma(planar_u8, plan)
    if planar_u8.dtype != torch.uint8:
        raise TypeError(f"expected uint8 planes, got {planar_u8.dtype}")
    return blur_fused_f32(planar_u8, plan, out_u8=True)
