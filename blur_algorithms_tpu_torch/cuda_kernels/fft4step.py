"""Four-step FFT convolution of rows (K3, K3f) and the FFT_MXU blur.

The port of the JAX package's ``pallas_kernels/fft4step.py``:

- ``fft_conv_rows`` circularly convolves rows already framed to the
  transform length ``n`` (K3, the TPU's ``_conv_rows_pallas`` ->
  ``_kernel``);
- ``fft_conv_rows_framed`` takes unpadded rows and frames them inside the
  kernel: reflect-101 pad, zeros to ``n``, crop (K3f, the TPU's
  ``_conv_rows_pallas_framed`` -> ``_kernel_framed``);
- ``conv_axis_framed`` runs one axis of a blur through K3f, or through K3
  where ``framed_applicable(n)`` is false, as the JAX function does;
- ``blur_fft_mxu_cuda`` is the differentiable separable blur (a
  ``torch.autograd.Function``: forward K3f/K3 on both axes, backward
  ``ops.adjoint.blur_adjoint``), the counterpart of the JAX ``custom_vjp``
  ``_blur_fft_mxu_pallas_diff``.

Both kernels are the one CUDA source ``csrc/fft4step.cu`` (two C entries).
A CUDA tensor launches it; a CPU tensor runs the plain version, the
full-float32 einsum four-step ``ops.fft_mxu._conv_rows_einsum`` under the
same framing. Up to ``BODY_N`` (16384) one block holds a pair of rows; past
it (32768, 65536, 131072) a thread-block cluster does, CTA q on segment q
of ``cluster_segment(n)`` points (the cluster form): the transform's first
pass (radix ``n / 1024``) reads the rows and stores each output into its
segment's CTA over distributed shared memory, the segments run the body's
radix-32 passes, and the last pass, the first's adjoint, runs where the
segments push its inputs. At 262144 (``CLUSTER_LONGEST``) a cluster of 16
CTAs does, in the wide cluster form: a radix-16 pass over stride
``BODY_N`` into the segments, the whole one-block body on each, the
adjoint pass back by remote loads, on persistent clusters; no scratch, one
read and one write of the rows. ``_radices`` past ``BODY_N`` names the
first pass's two digits (``C``, then ``segment / 1024``), which set the
bin order H is kept in. Past ``CLUSTER_LONGEST`` the staged form takes
every power of two: radix-8/16/32 passes over the ``n / BODY_N`` segments
(``staged_digits``) through a complex scratch buffer in device memory, each
segment through the one-block body (its first and last passes reading and
storing scratch), then the passes' adjoints back to the rows; ``_radices``
names those digits first. At ``CLUSTER_LONGEST`` itself the staged form
runs where the card places no cluster of 16 (a non-portable size: a MIG
slice or a part with fewer free SMs in a GPC); its one digit, 16, is the
wide form's C, so both keep H in one bin order. ``_form`` chooses the form
before the launch, from ``cudaOccupancyMaxActiveClusters``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from blur_algorithms_tpu_torch.ops.adjoint import blur_adjoint
from blur_algorithms_tpu_torch.ops.fft_mxu import (
    _conv_rows_einsum,
    conv_axis,
    transform_length,
)
from blur_algorithms_tpu_torch.ops.kernels import wrap_centered
from blur_algorithms_tpu_torch.ops.plan import BlurPlan
from blur_algorithms_tpu_torch.utils import trace

__all__ = [
    "BODY_N",
    "CLUSTER_LONGEST",
    "blur_fft_mxu_cuda",
    "cluster_occupancy",
    "cluster_segment",
    "conv_axis_framed",
    "fft_conv_rows",
    "fft_conv_rows_framed",
    "framed_applicable",
    "kernel_length",
    "staged_digits",
]

# Longest transform one block holds: a complex row of 16384 f32 pairs is
# 128 KB of its shared memory (of 227 KB on an H100). Past it the cluster
# form splits the row into segments of this length, one a CTA.
BODY_N = 16384
# Longest transform of the cluster form: a cluster of 16 CTAs of BODY_N (the
# wide cluster form; past the portable 8, a size the H100 places). Past it,
# and at it on a card that places no cluster of 16, the staged form runs.
CLUSTER_LONGEST = 16 * BODY_N
# The C entries take int lengths: the longest power of two they hold.
_INT_LONGEST = 1 << 30


def framed_applicable(n: int) -> bool:
    """The JAX in-kernel-framing form takes ``n = 128 * m`` with ``m >= 32``
    (every wide-radius length past 4096); shorter transforms keep K3."""
    return n % 128 == 0 and n // 128 >= 32


def kernel_length(n: int) -> bool:
    """The transform lengths K3/K3f take: every power of two from 256 (to
    2^30, the C entries' int) and ``1024 k`` for k = 5..16 (what
    ``transform_length`` and the adjoint plan)."""
    return (256 <= n <= _INT_LONGEST and n & (n - 1) == 0) or (
        4096 < n <= BODY_N and n % 1024 == 0)


def staged_digits(n: int) -> list[int]:
    """The radices of the staged form's first passes at a power of two
    ``n`` from ``CLUSTER_LONGEST`` on: ``P = n / BODY_N`` split into
    ``ceil(log2(P) / 5)`` digits of 8, 16 or 32, the first ones the larger
    (``csrc/fft4step.cu``: ``staged_digit_log2``); [16] at
    ``CLUSTER_LONGEST``, the wide cluster form's C."""
    if not (CLUSTER_LONGEST <= n <= _INT_LONGEST and n & (n - 1) == 0):
        raise ValueError(f"n = {n} is not a length of the staged form")
    p = (n // BODY_N).bit_length() - 1
    t = -(-p // 5)
    return [1 << (p // t + (i < p % t)) for i in range(t)]


def cluster_segment(n: int) -> int:
    """The segment a CTA of the cluster form holds at transform length
    ``n`` in ``BODY_N``..``CLUSTER_LONGEST``: 8192 at 65536 (clusters of 8,
    two CTAs an SM), ``BODY_N`` at 32768 and 131072 (clusters of 2 and 8),
    the faster on the card (``csrc/fft4step.cu``: ``cluster_segment``), and
    at 262144 (the wide form's 16)."""
    return 8192 if n == 65536 else BODY_N


def _radices(n: int, segment: int | None = None) -> list[int]:
    """The kernel's forward passes, in order: past ``CLUSTER_LONGEST`` the
    staged form's digits (``staged_digits``), then the segment's passes
    (those of ``BODY_N``); past ``BODY_N`` the two digits of the cluster
    form's first pass (radix ``C = n / segment`` over
    the segments, then radix ``segment / 1024``: one pass of radix
    ``n / 1024`` in the kernel) and then the segment's radix-32 passes
    (``segment``: ``cluster_segment(n)``, or a probe variant's; at 262144
    the wide form's radix-16 pass, then the segment's three, the same
    digits as the staged form's there); else radix
    Q, the odd part of ``n`` (when > 1), radix R0 (when > 1), then ``a``
    radix-32 passes, with ``n = Q * R0 * 32**a`` and ``a = 2`` from
    ``n / Q = 1024`` on (``csrc/fft4step.cu``: ``launch``)."""
    if not kernel_length(n):
        raise ValueError(f"n = {n} is not a K3 transform length")
    if n > CLUSTER_LONGEST:
        return staged_digits(n) + _radices(BODY_N)
    if n > BODY_N:
        seg = segment or cluster_segment(n)
        return [n // seg] + _radices(seg)
    q, p = n, 0
    while q % 2 == 0:
        q //= 2
        p += 1
    a = 2 if p >= 10 else 1
    r0 = 1 << (p - 5 * a)
    return [r for r in (q, r0) if r > 1] + [32] * a


def _kernel_bin_order(n: int, segment: int | None = None) -> np.ndarray:
    """Natural frequency held at each position of the kernel's forward
    spectrum (digit-reversed: the first pass's digit is the position's
    most significant and the frequency's least significant)."""
    rem = np.arange(n, dtype=np.int64)
    k = np.zeros(n, dtype=np.int64)
    span, mult = n, 1
    for r in _radices(n, segment):
        span //= r
        k += (rem // span) * mult
        rem = rem % span
        mult *= r
    return k


# entries of the low twiddle table; the high one has n / _LO <= 128
_LO = 128


def _twiddle_tables(n: int) -> np.ndarray:
    """The kernel's twiddle tables, (272, 2) float32 (re, im): ``Tlo[l] =
    W_n^l`` (l < 128), ``Thi[h] = W_n^(128 h)`` (h < n / 128, zero past
    it), ``W_Q^k`` (k < Q, zero past it), each ``exp(-2 pi i x / n)`` in
    float64 rounded to float32. The kernel takes ``W_n^e = Thi[e >> 7] *
    Tlo[e & 127]``. Past ``BODY_N``: the tables of ``BODY_N`` (each CTA
    fills its W_1024 table from them, at either segment length; the staged
    form's segment blocks likewise), then ``W_n^l`` (l < 128) and
    ``W_n^(128 h)`` (h < n / 128) for the passes over spans past the
    segment (the cluster form's first pass, whose W_(n/1024)^e are entries
    8 e of the high one; the staged form's first passes), (400 + n / 128, 2)
    in all."""
    if n > BODY_N:
        ang = -2.0 * np.pi * np.concatenate(
            [np.arange(_LO), _LO * np.arange(n // _LO)]) / n
        cluster = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
        return np.concatenate([_twiddle_tables(BODY_N), cluster])
    q = n
    while q % 2 == 0:
        q //= 2
    ang = np.zeros(2 * _LO + 16)
    ang[:_LO] = np.arange(_LO) / n
    ang[_LO:_LO + n // _LO] = _LO * np.arange(n // _LO) / n
    ang[2 * _LO:2 * _LO + q] = np.arange(q) / q
    used = np.zeros(ang.shape, bool)
    used[:_LO + n // _LO] = True
    used[2 * _LO:2 * _LO + q] = True
    ang = -2.0 * np.pi * ang
    tab = np.stack([np.cos(ang), np.sin(ang)], axis=-1) * used[:, None]
    return tab.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _twiddles(n: int, device: torch.device) -> torch.Tensor:
    """``_twiddle_tables(n)`` on the device."""
    return torch.from_numpy(_twiddle_tables(n)).to(device)


@functools.lru_cache(maxsize=128)
def _kernel_spectrum(axis_plan, n: int, device: torch.device,
                     segment: int | None = None) -> tuple[torch.Tensor, bool]:
    """The correlation spectrum conj(fft(wrap_centered(taps, n))) / n in the
    kernel's bin order (of ``segment``'s cluster form past ``BODY_N``, of
    the staged form from ``CLUSTER_LONGEST`` on, where both forms share
    it): n
    floats (symmetric taps) or (n, 2) interleaved complex, and whether it
    is complex."""
    full = np.conj(np.fft.fft(wrap_centered(axis_plan.taps, n).astype(np.float64))) / n
    full = full[_kernel_bin_order(n, segment)]
    if axis_plan.symmetric:
        return torch.from_numpy(full.real.astype(np.float32)).to(device), False
    h = np.stack([full.real, full.imag], axis=-1).astype(np.float32)
    return torch.from_numpy(h).to(device), True


def _check_rows(rows: torch.Tensor, length: int, what: str) -> None:
    if rows.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 rows, got {rows.dtype}")
    if rows.ndim != 2 or rows.shape[1] != length:
        raise ValueError(f"{what} takes (R, {length}) rows, got {tuple(rows.shape)}")


def _form(n: int, framed: bool, device: torch.device) -> str:
    """The form of K3 (K3f where ``framed``) that runs at transform length
    ``n`` on ``device``, the current CUDA card: "body" (one block a pair of
    rows) up to ``BODY_N``, "cluster" past it, "staged" past
    ``CLUSTER_LONGEST``; at ``CLUSTER_LONGEST`` "wide" where the card places
    a cluster of 16 CTAs of the wide form's kernel, "staged" where it places
    none. Chosen before the launch: nothing catches a failed one."""
    if n <= BODY_N:
        return "body"
    if n < CLUSTER_LONGEST:
        return "cluster"
    if n == CLUSTER_LONGEST and _wide_clusters(device.index, framed) >= 1:
        return "wide"
    return "staged"


@functools.lru_cache(maxsize=None)
def _wide_clusters(index: int, framed: bool) -> int:
    """``cluster_occupancy(CLUSTER_LONGEST, framed)`` on card ``index`` (the
    current one), queried once a process and card."""
    return cluster_occupancy(CLUSTER_LONGEST, framed)


def _launch(wrapper, rows: torch.Tensor, n: int, axis_plan, *extra) -> torch.Tensor:
    """Launch the C entry of ``csrc/fft4step.cu`` named as ``wrapper`` on
    CUDA rows, in the form ``_form`` chooses (the staged one through
    ``fft_conv_rows_staged``, with a scratch buffer of (R + 1) / 2 x n
    complex64; the others allocate nothing but the output), in the span
    ``launch.<C entry>``, and count the launch on ``wrapper``
    (``utils.trace.launched``): ``.launches``, and ``.cluster_launches``
    (the cluster and the wide form) or ``.staged_launches``. Raise on a
    length the kernel does not take, a device that is neither CUDA nor CPU,
    a non-contiguous tensor or a failed launch."""
    if not kernel_length(n):
        raise ValueError(f"n = {n} is not a K3 transform length")
    if rows.device.type != "cuda":
        raise ValueError(f"K3 runs on CUDA or CPU tensors, not {rows.device}")
    if not rows.is_contiguous():
        raise ValueError("K3 needs contiguous rows")
    if rows.shape[0] == 0:
        return torch.empty_like(rows)
    from blur_algorithms_tpu_torch.utils.build import load_library

    framed = wrapper is fft_conv_rows_framed
    with torch.cuda.device(rows.device):
        form = _form(n, framed, rows.device)
        entry = "fft_conv_rows_staged" if form == "staged" else wrapper.__name__
        with trace.span(f"launch.{entry}"):
            out = torch.empty_like(rows)
            tw = _twiddles(n, rows.device)
            h, complex_h = _kernel_spectrum(axis_plan, n, rows.device)
            lib = load_library()
            scratch = None
            if form == "staged":
                # K3: dim n, pad 0; the complex scratch of the staged form
                dim_pad = extra or (n, 0)
                scratch = torch.empty(((rows.shape[0] + 1) // 2, n, 2),
                                      dtype=torch.float32, device=rows.device)
                extra = (*dim_pad, int(framed), scratch.data_ptr())
            rc = getattr(lib, entry)(
                rows.data_ptr(), out.data_ptr(), tw.data_ptr(), h.data_ptr(),
                int(complex_h), rows.shape[0], n, *extra,
                torch.cuda.current_stream(rows.device).cuda_stream,
            )
    if rc:
        msg = lib.blur_cuda_error_string(rc).decode()
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc} ({msg})")
    trace.launched(wrapper, entry, trace.nbytes(rows, out, tw, h, scratch),
                   _FORM_COUNTS.get(form))
    return out


# the wrapper's own count of each form's launches, beside ``.launches``
_FORM_COUNTS = {"cluster": "cluster_launches", "wide": "cluster_launches",
                "staged": "staged_launches"}


def cluster_occupancy(n: int, framed: bool = False) -> int:
    """How many clusters of the cluster form's kernel at transform length
    ``n`` (K3f's where ``framed``) the current CUDA card holds at once
    (``cudaOccupancyMaxActiveClusters``); raises on a failed query."""
    import ctypes

    from blur_algorithms_tpu_torch.utils.build import load_library

    if not (BODY_N < n <= CLUSTER_LONGEST and kernel_length(n)):
        raise ValueError(f"n = {n} is not a length of the cluster form")
    lib = load_library()
    out = ctypes.c_int(0)
    rc = lib.fft_conv_rows_cluster_occupancy(n, int(framed), ctypes.byref(out))
    if rc:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: CUDA error {rc} "
                           f"({lib.blur_cuda_error_string(rc).decode()})")
    return out.value


def fft_conv_rows(rows: torch.Tensor, n: int, axis_plan) -> torch.Tensor:
    """(R, n) float32 rows framed to the transform length -> the rows
    circularly correlated by the axis taps (K3).

    A CUDA tensor launches the kernel; a CPU tensor runs the plain version.
    ``fft_conv_rows.launches`` counts kernel launches, ``.cluster_launches``
    those of the cluster form and the wide one (``BODY_N < n <=
    CLUSTER_LONGEST``), ``.staged_launches`` those of the staged form (past
    it, and at it on a card that places no cluster of 16: ``_form``).
    """
    _check_rows(rows, n, "K3")
    if rows.device.type == "cpu":
        return _conv_rows_einsum(rows, n, axis_plan)
    return _launch(fft_conv_rows, rows, n, axis_plan)


fft_conv_rows.launches = 0
fft_conv_rows.cluster_launches = 0
fft_conv_rows.staged_launches = 0


def fft_conv_rows_framed_ref(rows: torch.Tensor, n: int, axis_plan) -> torch.Tensor:
    """Plain version of K3f: (R, dim) rows -> (R, dim), the reflect-101 and
    zero framing of ``ops.fft_mxu.conv_axis`` around the einsum four-step."""
    return conv_axis(rows, axis_plan, -1, _conv_rows_einsum)


def fft_conv_rows_framed(rows: torch.Tensor, n: int, axis_plan) -> torch.Tensor:
    """(R, dim) unpadded float32 rows -> (R, dim), framed, convolved and
    cropped in the kernel (K3f); ``n`` is ``transform_length(axis_plan)``.

    A CUDA tensor launches the kernel; a CPU tensor runs the plain version.
    ``fft_conv_rows_framed.launches`` counts kernel launches,
    ``.cluster_launches`` and ``.staged_launches`` those of the cluster and
    the staged form, as ``fft_conv_rows``'s.
    """
    dim, pad = axis_plan.dim, axis_plan.pad
    _check_rows(rows, dim, "K3f")
    if n != transform_length(axis_plan):
        raise ValueError(f"n = {n} is not the axis transform length")
    if rows.device.type == "cpu":
        return fft_conv_rows_framed_ref(rows, n, axis_plan)
    return _launch(fft_conv_rows_framed, rows, n, axis_plan, dim, pad)


fft_conv_rows_framed.launches = 0
fft_conv_rows_framed.cluster_launches = 0
fft_conv_rows_framed.staged_launches = 0


def conv_axis_framed(x: torch.Tensor, axis_plan, axis: int) -> torch.Tensor:
    """One axis of the blur through K3f (K3 with the framing outside the
    kernel where ``framed_applicable(n)`` is false). The axis is moved last
    and made contiguous first (a transpose copy for the column axis)."""
    if axis_plan.support_radius == 0:
        return x
    n = transform_length(axis_plan)
    if not framed_applicable(n):
        return conv_axis(x, axis_plan, axis, fft_conv_rows)
    dim = axis_plan.dim
    x = x.movedim(axis, -1)
    lead = x.shape[:-1]
    out = fft_conv_rows_framed(x.reshape(-1, dim).contiguous(), n, axis_plan)
    return out.reshape(*lead, dim).movedim(-1, axis).contiguous()


class _BlurFftMxu(torch.autograd.Function):
    """Forward K3f/K3 on both axes, backward the blur's adjoint (the blur is
    linear, so the VJP needs no saved tensors)."""

    @staticmethod
    def forward(ctx, planar: torch.Tensor, plan: BlurPlan) -> torch.Tensor:
        ctx.plan = plan
        out = conv_axis_framed(planar, plan.row, -1)
        return conv_axis_framed(out, plan.col, -2)

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        return blur_adjoint(ct, ctx.plan), None


def blur_fft_mxu_cuda(planar: torch.Tensor, plan: BlurPlan) -> torch.Tensor:
    """Separable four-step FFT blur of planar ``(..., H, W)`` -> float32,
    differentiable (backward: ``blur_adjoint``). Radius-free: its cost does
    not grow with the support radius."""
    return _BlurFftMxu.apply(planar.to(torch.float32), plan)
