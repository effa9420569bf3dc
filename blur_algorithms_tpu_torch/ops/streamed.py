"""Strip-streamed blur for frames too large to transform whole.

The port of the JAX package's ``ops/streamed.py``. A frame whose whole-frame
FFT intermediates outgrow the device's budget is blurred one strip at a
time, so peak memory stays one full-size float32 intermediate plus a strip's
transforms:

- the rows pass slices strips of rows and transforms the last axis; the
  columns pass slices strips of columns and transforms the column axis (a
  strip's transpose is the only transpose copy);
- the last strip's start clamps to ``n - strip`` (no whole-frame pad to a
  multiple of the strip): its overlap recomputes values equal to the
  previous strip's, since each output depends only on its own line;
- each strip goes into a preallocated output (``narrow(...).copy_``);
- the uint8 forms convert each strip to float32 on the way in and round
  each strip on the way out, so only one full-size float32 intermediate is
  alive.

Two engines: ``blur_fft_tiles_streamed(_u8)`` transform each strip with
``torch.fft`` (the JAX ones with ``jnp.fft``, outside any Pallas kernel;
``ops/fft_conv._tile_pass``, numerically the ``fft_tiles`` engine), and
``blur_fft_mxu_streamed(_u8)`` through K3f (K3 for short transforms,
``cuda_kernels/fft4step.conv_axis_framed``), as the JAX ``_mxu_blur_chunk``
runs the four-step kernel: the CUDA kernels on a CUDA tensor, their plain
version on a CPU tensor. A strip transforms a whole axis, so past 16384 the
strips run K3/K3f's cluster form (at 262144 the wide one, on 16 CTAs),
and past 262144 their staged form. The float forms are differentiable: their
backward pass is the blur's adjoint (``ops/adjoint.blur_adjoint``, whole
frame), as the JAX ``_streamed_bwd``.
"""

from __future__ import annotations

import torch

from blur_algorithms_tpu_torch.cuda_kernels.fft4step import conv_axis_framed
from blur_algorithms_tpu_torch.ops.adjoint import blur_adjoint
from blur_algorithms_tpu_torch.ops.fft_conv import _tile_pass
from blur_algorithms_tpu_torch.ops.layout import round_to_u8
from blur_algorithms_tpu_torch.ops.plan import BlurPlan

__all__ = [
    "blur_fft_mxu_streamed",
    "blur_fft_mxu_streamed_u8",
    "blur_fft_tiles_streamed",
    "blur_fft_tiles_streamed_u8",
    "estimate_fft_tiles_bytes",
]

STRIP = 1024  # lines a strip, the JAX default


def estimate_fft_tiles_bytes(plan: BlurPlan, channels: int = 3) -> int:
    """Rough peak-memory estimate of the whole-frame tile path (f32 +
    complex64)."""
    h, w = plan.shape
    per_px = 4 + 8  # padded f32 + half-spectrum complex64, worst axis
    return channels * max(h * plan.row.fft_len, w * plan.col.fft_len) * per_px


def _pass_over_strips(x: torch.Tensor, axis_plan, fft_axis: int, strip_axis: int,
                      strip: int, out_dtype: torch.dtype, chunk_fn) -> torch.Tensor:
    """Blur along ``fft_axis``, streaming strips sliced along ``strip_axis``
    into one preallocated output of ``out_dtype``."""
    fft_axis %= x.ndim
    strip_axis %= x.ndim
    n_strip = x.shape[strip_axis]
    strip = min(strip, n_strip)
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    for i in range(-(-n_strip // strip) if strip else 0):
        start = min(i * strip, n_strip - strip)
        blurred = chunk_fn(x.narrow(strip_axis, start, strip).to(torch.float32),
                           axis_plan, fft_axis)
        if out_dtype == torch.uint8:
            blurred = round_to_u8(blurred)
        out.narrow(strip_axis, start, strip).copy_(blurred)
    return out


def _both_axes(planar: torch.Tensor, plan: BlurPlan, strip: int, out_dtype: torch.dtype,
               chunk_fn) -> torch.Tensor:
    """The rows pass in strips of rows into float32, then the columns pass
    in strips of columns into ``out_dtype``."""
    x = _pass_over_strips(planar, plan.row, -1, -2, strip, torch.float32, chunk_fn)
    return _pass_over_strips(x, plan.col, -2, -1, strip, out_dtype, chunk_fn)


class _Streamed(torch.autograd.Function):
    """The streamed float blur; backward the whole-frame adjoint (the blur
    is linear: no saved tensors)."""

    @staticmethod
    def forward(ctx, planar: torch.Tensor, plan: BlurPlan, strip: int, chunk_fn):
        ctx.plan = plan
        return _both_axes(planar, plan, strip, torch.float32, chunk_fn)

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        return blur_adjoint(ct, ctx.plan), None, None, None


def blur_fft_tiles_streamed(planar: torch.Tensor, plan: BlurPlan,
                            strip: int = STRIP) -> torch.Tensor:
    """Float planar ``(..., H, W)`` -> float32, strip-streamed ``torch.fft``
    blur; differentiable (backward: the whole-frame adjoint)."""
    return _Streamed.apply(planar.to(torch.float32), plan, strip, _tile_pass)


def blur_fft_tiles_streamed_u8(planar_u8: torch.Tensor, plan: BlurPlan,
                               strip: int = STRIP) -> torch.Tensor:
    """uint8 planar in -> uint8 planar out, one float32 intermediate."""
    return _both_axes(planar_u8, plan, strip, torch.uint8, _tile_pass)


def blur_fft_mxu_streamed(planar: torch.Tensor, plan: BlurPlan,
                          strip: int = STRIP) -> torch.Tensor:
    """Float planar ``(..., H, W)`` -> float32, strip-streamed through
    K3f/K3; differentiable (backward: the whole-frame adjoint)."""
    return _Streamed.apply(planar.to(torch.float32), plan, strip, conv_axis_framed)


def blur_fft_mxu_streamed_u8(planar_u8: torch.Tensor, plan: BlurPlan,
                             strip: int = STRIP) -> torch.Tensor:
    """uint8 planar in -> uint8 planar out through K3f/K3, one float32
    intermediate."""
    return _both_axes(planar_u8, plan, strip, torch.uint8, conv_axis_framed)
