"""Fixed-point tap quantisation of the fused blur's int8 path (NumPy).

Copied from the JAX package's ``pallas_kernels/fused_blur.py`` (the
quantiser, the adaptive scale picker and the int8 applicability rule), so
that the port's operands are integer-identical to the JAX kernel's. The
blocked fused kernel of that module (K2 in ROADMAP.md) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from blur_algorithms_tpu_torch.ops.plan import BlurPlan

__all__ = ["int8_applicable", "pick_int8_scale"]

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
