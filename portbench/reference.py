"""The plain reference that decides ``correct``: the upstream Gaussian blur of
uint8 ``(B, H, W, C)`` frames, worked out again from the upstream formulas.

- Taps: ``Source.cpp:60-102`` (``gaussian_window``: width from
  ``sigma * sqrt(2 ln 255) - 1`` in float32, clamped to the larger frame side
  and forced odd; ``getGaussian``: samples stored in float32, normalised by
  their float64 sum).
- Borders: reflect-101 (``Utils.hpp:212-243``), each side reflected up to
  ``dim - 1`` and zero past it.
- Arithmetic: each axis as a product with a band matrix that holds the taps
  and the reflected borders, rows first, in float64: exact to ~1e-12 at the
  0..255 scale.
- Rounding: ``floor(y + 0.5)``, clipped to 0..255.

Each output value is judged against the exact float64 value ``y`` and its
exact rounding (``Judgement``): the share of values whose rounding differs,
and the largest difference in counts.

The control (``blur_lower_precision``) is the same reference with every
operand of its two products rounded to float8 e4m3 and the sums in float32:
the step below the bfloat16 band products that the configurations state
(``configs/*.json``, ``precision``). Nothing here imports the port or JAX: it
takes the frames and the program's output, and works the rest out itself.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["CONTROL_DTYPE", "Judgement", "Operators", "band_matrix", "blur_lower_precision",
           "gaussian_taps", "gaussian_width", "judge"]

# the control's operand type: the precision below the configurations' bfloat16
CONTROL_DTYPE = torch.float8_e4m3fn

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


def _rounded(x: torch.Tensor, operand) -> torch.Tensor:
    """``x`` rounded to the ``operand`` type and held in float32: an operand
    of a product in that type whose sums are float32."""
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
