"""The plain reference that decides ``correct``: the upstream Gaussian blur of
uint8 ``(B, H, W, C)`` frames and of float32 planes ``(B, C, H, W)``, and the
blur's adjoint (its backward), worked out again from the upstream formulas.

- Taps: ``Source.cpp:60-102`` (``gaussian_window``: width from
  ``sigma * sqrt(2 ln 255) - 1`` in float32, clamped to the larger frame side
  and forced odd; ``getGaussian``: samples stored in float32, normalised by
  their float64 sum).
- Borders: reflect-101 (``Utils.hpp:212-243``), each side reflected up to
  ``dim - 1`` and zero past it.
- Arithmetic: each axis as a product with a band matrix that holds the taps
  and the reflected borders, rows first, in float64: exact to ~1e-12 at the
  0..255 scale. With ``y = M_cols^T x M_rows``, the backward of a cotangent
  ``g`` is ``M_cols g M_rows^T``, columns first, in the same blocks.
- Rounding (uint8): ``floor(y + 0.5)``, clipped to 0..255.

A uint8 output value is judged against the exact float64 value ``y`` and its
exact rounding (``Judgement``): the share of values whose rounding differs,
and the largest difference in counts. A float32 answer is judged by its
largest absolute error, forward and backward (``FloatJudgement``).

The controls are the same reference with every operand of its two products
rounded one step below the precision that a configuration states
(``configs/*.json``, ``precision``), the sums in float32: float8 e4m3 below
the uint8 configurations' bfloat16 (``blur_lower_precision``), TF32 below the
float configurations' float32 (``blur_f32_lower_precision``,
``adjoint_f32_lower_precision``, and ``LowerPrecisionBlur``, which takes the
program's place in a run). Nothing here imports the port or JAX: it takes the
inputs and the program's output, and works the rest out itself.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["CONTROL_DTYPE", "FLOAT_CONTROL", "FloatJudgement", "Judgement", "LowerPrecisionBlur",
           "Operators", "adjoint_f32_lower_precision", "band_matrix", "blur_f32_lower_precision",
           "blur_lower_precision", "gaussian_taps", "gaussian_width", "judge", "judge_float",
           "round_tf32"]

# the control's operand type: the precision below the configurations' bfloat16
CONTROL_DTYPE = torch.float8_e4m3fn
# the float control's operand: TF32, the precision below the float configurations'
# float32 (a tensor-core product in one pass)
FLOAT_CONTROL = "tfloat32"

# output columns (rows for the column pass) per block product: each block
# reads only the input band that reaches it
_BLOCK = 2048
# taps per step while a band matrix is filled (bounds its index tensors)
_FILL_ELEMS = 1 << 24


def gaussian_width(sigma: float, max_width: int) -> int:
    """``Source.cpp:60-73``: the odd kernel width that holds the Gaussian."""
    radius = np.float32(sigma * math.sqrt(2.0 * math.log(255.0)) - 1.0)
    width = int(np.float32(radius * np.float32(2.0) + np.float32(0.5)))
    width = min(width, int(max_width))
    if width % 2 == 0:
        width += 1
    return max(width, 1)


def gaussian_taps(sigma: float, max_width: int) -> np.ndarray:
    """``Source.cpp:76-102``: normalised float32 taps, odd length."""
    width = gaussian_width(sigma, max_width)
    s = 2.0 * float(sigma) * float(sigma)
    if s == 0.0:
        taps = np.zeros(width, dtype=np.float32)
        taps[width // 2] = 1.0
        return taps
    y = np.arange(width, dtype=np.float64) - (width - 1) / 2.0
    taps = (np.exp(-(y * y) / s) / (math.pi * s)).astype(np.float32)
    norm = 1.0 / float(np.sum(taps, dtype=np.float64))
    return (taps.astype(np.float64) * norm).astype(np.float32)


def band_matrix(n: int, taps: np.ndarray, device) -> torch.Tensor:
    """``M`` of shape ``(n, n)`` with ``out[i] = sum_j x[j] * M[j, i]``: the
    correlation by ``taps`` of a line of ``n`` values under reflect-101
    borders (reflected up to ``n - 1`` a side, zero past it)."""
    width = int(taps.shape[0])
    r = (width - 1) // 2
    m = torch.zeros((n, n), dtype=torch.float64, device=device)
    t64 = torch.as_tensor(taps.astype(np.float64), device=device)
    i = torch.arange(n, device=device)
    step = max(1, _FILL_ELEMS // n)
    for t0 in range(0, width, step):
        t = torch.arange(t0, min(width, t0 + step), device=device)
        j = i[None, :] - r + t[:, None]
        keep = (j >= -(n - 1)) & (j <= 2 * (n - 1))
        j = torch.where(j < 0, -j, j)
        j = torch.where(j > n - 1, 2 * (n - 1) - j, j)
        ii = i[None, :].expand_as(j)
        vals = t64[t][:, None].expand_as(j)
        m.index_put_((j[keep], ii[keep]), vals[keep], accumulate=True)
    return m


def _blocks(n: int, r: int):
    for a in range(0, n, _BLOCK):
        b = min(n, a + _BLOCK)
        yield a, b, max(0, a - r), min(n, b + r)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Float32 ``x`` rounded to the nearest value with TF32's 10 mantissa
    bits, ties away from zero (PTX ``cvt.rna.tf32.f32``), held in float32."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _rounded(x: torch.Tensor, operand) -> torch.Tensor:
    """``x`` rounded to the ``operand`` type (a dtype, or ``FLOAT_CONTROL``)
    and held in float32: an operand of a product in that type whose sums are
    float32."""
    if operand == FLOAT_CONTROL:
        return round_tf32(x)
    return x.to(operand).to(torch.float32)


def _blur_plane(x: torch.Tensor, m_rows: torch.Tensor, m_cols: torch.Tensor,
                r_rows: int, r_cols: int, operand=None) -> torch.Tensor:
    """One ``(H, W)`` plane through both band products, in ``x``'s dtype:
    the rows (along W) first, then the columns. With ``operand``, the
    intermediate is rounded to it before the column product."""
    h, w = x.shape
    t = torch.empty_like(x)
    for a, b, lo, hi in _blocks(w, r_rows):
        t[:, a:b] = x[:, lo:hi] @ m_rows[lo:hi, a:b]
    if operand is not None:
        t = _rounded(t, operand)
    y = torch.empty_like(x)
    for a, b, lo, hi in _blocks(h, r_cols):
        y[a:b, :] = m_cols[lo:hi, a:b].T @ t[lo:hi, :]
    return y


def _adjoint_plane(g: torch.Tensor, m_rows: torch.Tensor, m_cols: torch.Tensor,
                   r_rows: int, r_cols: int, operand=None) -> torch.Tensor:
    """The adjoint of ``_blur_plane`` on one ``(H, W)`` cotangent, in ``g``'s
    dtype: ``M_cols g M_rows^T``, the columns first, then the rows (the
    reflect-101 bands are not symmetric, so the transposes matter). Each
    output block reads the input band within the radius of it, as the
    forward's do. With ``operand``, the intermediate is rounded to it."""
    h, w = g.shape
    u = torch.empty_like(g)
    for a, b, lo, hi in _blocks(h, r_cols):
        u[a:b, :] = m_cols[a:b, lo:hi] @ g[lo:hi, :]
    if operand is not None:
        u = _rounded(u, operand)
    gx = torch.empty_like(g)
    for a, b, lo, hi in _blocks(w, r_rows):
        gx[:, a:b] = u[:, lo:hi] @ m_rows[a:b, lo:hi].T
    return gx


class Judgement:
    """What the judged values read against the exact float64 blur ``y``:

    - ``mismatch_pct``: the share of values, in %, whose rounding differs
      from the exact rounding ``floor(y + 0.5)`` (a change of precision moves
      it; averaged over every value judged, it is steady from seed to seed);
    - ``worst_count_diff``: the largest difference in counts from the exact
      rounding (the configuration's guarantee: 1);
    - ``worst_excess_counts``: the worst ``|out - y| - 0.5`` (reported).

    A missing answer, or one of the wrong shape or type, reads 100% and 255
    counts."""

    def __init__(self) -> None:
        self.excess = -math.inf
        self.worst_diff = 0
        self.mismatches = 0
        self.values = 0
        self.missing = False

    def add(self, out_plane: torch.Tensor, y: torch.Tensor) -> None:
        out = out_plane.to(torch.float64)
        self.excess = max(self.excess, float((out - y).abs().max()) - 0.5)
        diff = (out - torch.clamp(torch.floor(y + 0.5), 0, 255)).abs()
        self.worst_diff = max(self.worst_diff, int(diff.max()))
        self.mismatches += int((diff > 0).sum())
        self.values += out_plane.numel()

    def fail(self) -> None:
        """An answer that is missing or of the wrong shape or type."""
        self.missing = True

    def numbers(self) -> dict:
        if self.missing or not self.values:
            return {"mismatch_pct": 100.0, "worst_count_diff": 255, "worst_excess_counts": 254.5}
        return {"mismatch_pct": 100.0 * self.mismatches / self.values,
                "worst_count_diff": self.worst_diff, "worst_excess_counts": self.excess}


class FloatJudgement:
    """What float32 answers read against the exact float64 blur ``y`` and,
    with a backward, its exact adjoint ``gx``:

    - ``max_abs_err``: the largest ``|y_out - y|`` over every value judged,
      at the frames' 0..255 scale;
    - ``grad_max_abs_err``: the largest ``|gx_out - gx|`` (with a backward).

    A missing answer, or one of the wrong shape or type, and a NaN, read
    ``inf``."""

    def __init__(self, backward: bool) -> None:
        self.backward = backward
        self.err = 0.0
        self.grad_err = 0.0
        self.values = 0
        self.missing = False

    @staticmethod
    def _worst(out: torch.Tensor, exact: torch.Tensor) -> float:
        e = float((out.to(torch.float64) - exact).abs().max())
        return math.inf if math.isnan(e) else e

    def add(self, out_plane: torch.Tensor, y: torch.Tensor) -> None:
        self.err = max(self.err, self._worst(out_plane, y))
        self.values += out_plane.numel()

    def add_grad(self, gx_plane: torch.Tensor, gx: torch.Tensor) -> None:
        self.grad_err = max(self.grad_err, self._worst(gx_plane, gx))

    def fail(self) -> None:
        """An answer that is missing or of the wrong shape or type."""
        self.missing = True

    def numbers(self) -> dict:
        bad = self.missing or not self.values
        out = {"max_abs_err": math.inf if bad else self.err}
        if self.backward:
            out["grad_max_abs_err"] = math.inf if bad else self.grad_err
        return out


class Operators:
    """The band matrices of one frame shape and sigma, made once and reused
    over several outputs: float64 for ``judge``, or, for the control, rounded
    to its ``operand`` type and held in float32."""

    def __init__(self, h: int, w: int, sigma: float, device, operand=None) -> None:
        taps = gaussian_taps(sigma, max(h, w))
        self.r = (taps.shape[0] - 1) // 2
        self.operand = operand
        self.rows = band_matrix(w, taps, device)
        self.cols = band_matrix(h, taps, device)
        if operand is not None:
            self.rows, self.cols = _rounded(self.rows, operand), _rounded(self.cols, operand)


def judge(outputs, frames: torch.Tensor, sigma: float, judgement: Judgement | None = None,
          ops: Operators | None = None) -> Judgement:
    """Judge the program's ``outputs`` (uint8 ``(B, H, W, C)``, or None where
    no answer came) against the exact blur of ``frames``, plane by plane in
    float64 on ``frames``' device."""
    judgement = judgement or Judgement()
    if (not isinstance(outputs, torch.Tensor) or outputs.shape != frames.shape
            or outputs.dtype != torch.uint8):
        judgement.fail()
        return judgement
    outputs = outputs.to(frames.device)
    bsz, h, w, c = frames.shape
    ops = ops or Operators(h, w, sigma, frames.device)
    for b in range(bsz):
        for ch in range(c):
            x = frames[b, :, :, ch].to(torch.float64)
            y = _blur_plane(x, ops.rows, ops.cols, ops.r, ops.r)
            del x
            judgement.add(outputs[b, :, :, ch], y)
            del y
    return judgement


def blur_lower_precision(frames: torch.Tensor, sigma: float, operand=CONTROL_DTYPE,
                         ops: Operators | None = None) -> torch.Tensor:
    """The control: the reference with every operand of its two band
    products (the frame, the band matrices, the intermediate) rounded to
    ``operand`` and the sums in float32, as a tensor-core product in that
    type computes; rounded to uint8 as the upstream rounds."""
    bsz, h, w, c = frames.shape
    ops = ops or Operators(h, w, sigma, frames.device, operand)
    out = torch.empty_like(frames)
    for b in range(bsz):
        for ch in range(c):
            x = _rounded(frames[b, :, :, ch].to(torch.float32), ops.operand)
            y = _blur_plane(x, ops.rows, ops.cols, ops.r, ops.r, ops.operand)
            out[b, :, :, ch] = torch.clamp(torch.floor(y + 0.5), 0, 255).to(torch.uint8)
            del x, y
    return out


def _planes(t: torch.Tensor) -> torch.Tensor:
    """``(..., H, W)`` as ``(P, H, W)``."""
    return t.reshape(-1, t.shape[-2], t.shape[-1])


def judge_float(answer, planes: torch.Tensor, cotangent: torch.Tensor | None, sigma: float,
                judgement: FloatJudgement | None = None,
                ops: Operators | None = None) -> FloatJudgement:
    """Judge the program's ``answer`` on float32 ``planes`` ``(..., H, W)``:
    ``(y,)``, or ``(y, gx)`` where a ``cotangent`` went back (None where no
    answer came), against the exact blur of ``planes`` and the exact adjoint
    of ``cotangent``, plane by plane in float64 on ``planes``' device."""
    judgement = judgement or FloatJudgement(cotangent is not None)
    want = 1 if cotangent is None else 2
    if (not isinstance(answer, tuple) or len(answer) != want
            or any(not isinstance(t, torch.Tensor) or t.shape != planes.shape
                   or t.dtype != torch.float32 for t in answer)):
        judgement.fail()
        return judgement
    h, w = planes.shape[-2:]
    ops = ops or Operators(h, w, sigma, planes.device)
    answer = [_planes(t.detach().to(planes.device)) for t in answer]
    x_all = _planes(planes.detach())
    g_all = None if cotangent is None else _planes(cotangent)
    for k in range(x_all.shape[0]):
        y = _blur_plane(x_all[k].to(torch.float64), ops.rows, ops.cols, ops.r, ops.r)
        judgement.add(answer[0][k], y)
        del y
        if g_all is not None:
            gx = _adjoint_plane(g_all[k].to(torch.float64), ops.rows, ops.cols, ops.r, ops.r)
            judgement.add_grad(answer[1][k], gx)
            del gx
    return judgement


def _through(t: torch.Tensor, ops: Operators, plane_fn) -> torch.Tensor:
    """Float32 ``t`` ``(..., H, W)``, plane by plane through ``plane_fn``
    with ``ops``' operand rounding: the operand rounded, the sums float32."""
    out = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    src, dst = _planes(t.detach()), _planes(out)
    for k in range(src.shape[0]):
        x = _rounded(src[k], ops.operand)
        dst[k] = plane_fn(x, ops.rows, ops.cols, ops.r, ops.r, ops.operand)
        del x
    return out


def blur_f32_lower_precision(planes: torch.Tensor, sigma: float, operand=FLOAT_CONTROL,
                             ops: Operators | None = None) -> torch.Tensor:
    """The float control, forward: the reference with every operand of its
    two band products (the planes, the band matrices, the intermediate)
    rounded to ``operand`` (TF32) and the sums in float32, as one pass on
    the tensor cores computes."""
    ops = ops or Operators(planes.shape[-2], planes.shape[-1], sigma, planes.device, operand)
    return _through(planes, ops, _blur_plane)


def adjoint_f32_lower_precision(cotangent: torch.Tensor, sigma: float, operand=FLOAT_CONTROL,
                                ops: Operators | None = None) -> torch.Tensor:
    """The float control, backward: the reference's adjoint with its
    operands rounded as ``blur_f32_lower_precision``'s."""
    ops = ops or Operators(cotangent.shape[-2], cotangent.shape[-1], sigma, cotangent.device,
                           operand)
    return _through(cotangent, ops, _adjoint_plane)


class LowerPrecisionBlur(torch.autograd.Function):
    """The float control in the program's place: ``apply(planes, ops)`` is
    ``blur_f32_lower_precision``, its backward
    ``adjoint_f32_lower_precision``, both with ``ops``' operand."""

    @staticmethod
    def forward(ctx, planes: torch.Tensor, ops: Operators) -> torch.Tensor:
        ctx.ops = ops
        return _through(planes, ops, _blur_plane)

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        return _through(ct, ctx.ops, _adjoint_plane), None
