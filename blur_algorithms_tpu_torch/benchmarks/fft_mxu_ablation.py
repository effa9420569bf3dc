"""B2: where K3/K3f's time goes, stage by stage.

The port of the JAX package's ``benchmarks/fft_mxu_ablation.py``, which
times the TPU's four-step FFT kernel with its dots, twiddle products and
relayouts turned off. Here the kernel is ``csrc/fft4step.cu``'s own body
built with a mask of stages to leave out (``csrc/probes/fft_ablation.cu``):
the butterflies, the twiddle products, the shared-memory exchanges between
passes, the product by H, or everything but the first pass's reads and the
last pass's stores. Only ``full`` (mask 0, the production kernel's code) is
a correct result; the other modes are for timing only, as in the JAX probe.

``MODES`` maps each JAX mode to its mask. ``1dot`` maps to none: it runs one
bf16 dot in place of the three of the TPU's bf16x3 split, and the H100
kernel computes its FFT in f32 on the CUDA cores, with no split dots.

A CUDA tensor runs the probe's kernel; a CPU tensor runs ``full``'s plain
version, K3's (``ops.fft_mxu._conv_rows_einsum``) or K3f's
(``cuda_kernels.fft4step.fft_conv_rows_framed_ref``), and refuses the
other modes.

Past 16384 (the cluster form), ``cluster_ablation`` runs PR 16's design of
the cluster form, the yardstick the current one is timed against in turns
(``probes/k3_cluster_variants.py``, ``chip_smoke.py`` phase 18), whole
(``pr16``) or with the parts of ``CLUSTER_VARIANTS`` left out: the
exchanges through the CTA's own shared memory, the cluster barriers after
the first, everything but the radix-C pass's reads and the last stores, or
everything but the length-16384 body. ``cluster_cells`` are the shapes it
is timed at. From 262144, ``staged_yardstick`` runs the copying staged form
(``chip_smoke.py`` phase 20 times the wide cluster form in turns with it).

Run: ``python -m blur_algorithms_tpu_torch.benchmarks.fft_mxu_ablation``
(``--rows``/``--n`` as the JAX probe: 8192 rows of n 16384 by default; the
4K shapes of ``chip_smoke.py`` with ``--cells``). Prints one JSON line per
mode.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from blur_algorithms_tpu_torch.benchmarks._common import (
    check_launch,
    device_arg,
    device_of,
    emit,
)

__all__ = ["CLUSTER_VARIANTS", "CURRENT_VARIANTS", "MODES", "ONE_DOT", "OTHER_SEGMENT",
           "PORT_MODES", "STAGES", "cells", "cluster_ablation", "cluster_cells",
           "conv_rows_ablation", "jax_default", "mask_keeps", "staged_yardstick"]

# the stages a mask leaves out (csrc/fft4step.cu: Ablate)
NO_BUTTERFLIES, NO_TWIDDLES, NO_EXCHANGES, NO_SPECTRUM, IO_ONLY = 1, 2, 4, 8, 16
STAGES = {"butterflies": NO_BUTTERFLIES, "twiddles": NO_TWIDDLES,
          "exchanges": NO_EXCHANGES, "spectrum": NO_SPECTRUM}

# the JAX probe's modes (fft_mxu_ablation.py main) and their masks
MODES = {
    "full": 0,
    "norot": NO_EXCHANGES,
    "notw": NO_TWIDDLES,
    "norot_notw": NO_EXCHANGES | NO_TWIDDLES,
    "1dot": None,
    "nodot": NO_BUTTERFLIES,
    "nodot_norot_notw": NO_BUTTERFLIES | NO_EXCHANGES | NO_TWIDDLES,
}
ONE_DOT = ("no counterpart: 1dot runs one bf16 dot in place of the three of the TPU's "
           "bf16x3 split; the H100 kernel's FFT is f32 on the CUDA cores, with no split dots")
# modes of the port alone: the product by H, and the reads and stores alone
PORT_MODES = {"noh": NO_SPECTRUM, "io_only": IO_ONLY}

# PR 16's cluster form whole, and its variants (csrc/probes/fft_ablation.cu:
# ClusterVariant): exchanges to the CTA's own shared memory (1), no cluster
# barrier after the first (2), the radix-C reads and last stores alone (4),
# the length-16384 body alone (8)
CLUSTER_VARIANTS = {"pr16": 0, "local": 1, "no_barriers": 2, "local_no_barriers": 3,
                    "io_only": 4, "body_only": 8}
# the current cluster form with the other segment length (8192 at n 32768
# for K3 and K3f, 16384 at 65536 for K3f): a design tried, not kept
OTHER_SEGMENT = "other_segment"
# the current cluster form with its pushes ended by cluster barriers in
# place of the receivers' transaction counts (16), with its exchanges to the
# CTA's own shared memory too (17), and with those barriers as the CTA's (19)
CURRENT_VARIANTS = {"current_push_barriers": 16, "current_local": 17,
                    "current_local_cta_barriers": 19}


def mask_keeps(mask: int) -> dict[str, bool]:
    """The stages a mask keeps, as the kernel's ``if constexpr`` tests read
    it (``IO_ONLY`` leaves out every stage but the reads and stores)."""
    if mask & IO_ONLY:
        mask |= NO_BUTTERFLIES | NO_TWIDDLES | NO_EXCHANGES | NO_SPECTRUM
    keeps = {name: not mask & bit for name, bit in STAGES.items()}
    keeps["middle passes"] = not mask & IO_ONLY
    return keeps


def _mask(mode: str) -> int:
    mask = {**MODES, **PORT_MODES}.get(mode, -1)
    if mask is None:
        raise ValueError(f"mode {mode!r}: {ONE_DOT}")
    if mask < 0:
        raise ValueError(f"the modes are {[*MODES, *PORT_MODES]}, not {mode!r}")
    return mask


def conv_rows_ablation(rows: torch.Tensor, n: int, axis_plan, mode: str = "full",
                       framed: bool = False) -> torch.Tensor:
    """K3 (rows framed to ``n``) or K3f (``framed``: unpadded rows, framed in
    the kernel) with ``mode``'s stages left out. A CUDA tensor launches the
    probe's kernel (n 16384 or 8192 for K3, 6144 or 4096 for K3f); a CPU
    tensor runs ``full``'s plain version. ``conv_rows_ablation.launches``
    counts."""
    from blur_algorithms_tpu_torch.cuda_kernels import fft4step
    from blur_algorithms_tpu_torch.ops.fft_mxu import _conv_rows_einsum

    mask = _mask(mode)
    dim, pad = (axis_plan.dim, axis_plan.pad) if framed else (n, 0)
    if rows.dtype != torch.float32 or rows.ndim != 2 or rows.shape[1] != dim:
        raise ValueError(f"takes (R, {dim}) float32 rows, got {tuple(rows.shape)} {rows.dtype}")
    if rows.device.type == "cpu":
        if mask:
            raise ValueError(f"mode {mode!r} is for timing on the card: only 'full' has a "
                             "plain version")
        plain = fft4step.fft_conv_rows_framed_ref if framed else _conv_rows_einsum
        return plain(rows, n, axis_plan)
    if rows.device.type != "cuda" or not rows.is_contiguous():
        raise ValueError(f"takes contiguous CUDA or CPU rows, not {rows.device}")
    from blur_algorithms_tpu_torch.utils.build import load_probe_library

    out = torch.empty_like(rows)
    tw = fft4step._twiddles(n, rows.device)
    h, complex_h = fft4step._kernel_spectrum(axis_plan, n, rows.device)
    rc = load_probe_library().fft_conv_rows_ablation(
        mask, int(framed), rows.data_ptr(), out.data_ptr(), tw.data_ptr(), h.data_ptr(),
        int(complex_h), rows.shape[0], n, dim, pad,
        torch.cuda.current_stream(rows.device).cuda_stream)
    check_launch(rc, "fft_conv_rows_ablation")
    conv_rows_ablation.launches += 1
    return out


conv_rows_ablation.launches = 0


def cluster_ablation(rows: torch.Tensor, n: int, axis_plan, variant: str = "pr16",
                     framed: bool = False) -> torch.Tensor:
    """PR 16's cluster form of K3 (rows framed to ``n``) or K3f (``framed``)
    at n 32768, 65536 or 131072 with ``variant``'s parts left out. A CUDA
    tensor launches the probe's kernel (every variant at C 2, and for K3f at
    C 4; ``pr16`` at every length; ``OTHER_SEGMENT``, the current kernel with
    the segment length it does not take, at n 32768, and for K3f at 65536;
    ``CURRENT_VARIANTS``, the current kernel with its pushes ended by
    cluster barriers, its exchanges kept in the CTA and its barriers made
    the CTA's, there too), the spectrum in its bin order; a CPU tensor runs
    ``pr16``'s plain version.
    ``cluster_ablation.launches`` counts."""
    from blur_algorithms_tpu_torch.cuda_kernels import fft4step
    from blur_algorithms_tpu_torch.ops.fft_mxu import _conv_rows_einsum

    names = [*CLUSTER_VARIANTS, OTHER_SEGMENT, *CURRENT_VARIANTS]
    if variant not in names:
        raise ValueError(f"the variants are {names}, not {variant!r}")
    if n <= fft4step.BODY_N or not fft4step.kernel_length(n):
        raise ValueError(f"n = {n} is not a length of the cluster form")
    dim, pad = (axis_plan.dim, axis_plan.pad) if framed else (n, 0)
    if rows.dtype != torch.float32 or rows.ndim != 2 or rows.shape[1] != dim:
        raise ValueError(f"takes (R, {dim}) float32 rows, got {tuple(rows.shape)} {rows.dtype}")
    if rows.device.type == "cpu":
        if variant != "pr16":
            raise ValueError(f"variant {variant!r} is for timing on the card: only 'pr16' has "
                             "a plain version")
        plain = fft4step.fft_conv_rows_framed_ref if framed else _conv_rows_einsum
        return plain(rows, n, axis_plan)
    if rows.device.type != "cuda" or not rows.is_contiguous():
        raise ValueError(f"takes contiguous CUDA or CPU rows, not {rows.device}")
    from blur_algorithms_tpu_torch.utils.build import load_probe_library

    out = torch.empty_like(rows)
    tw = fft4step._twiddles(n, rows.device)
    segment = fft4step.BODY_N  # PR 16's bin order
    if variant in CURRENT_VARIANTS:
        segment = fft4step.cluster_segment(n)
    if variant == OTHER_SEGMENT:
        segment = 8192 if fft4step.cluster_segment(n) == fft4step.BODY_N else fft4step.BODY_N
    h, complex_h = fft4step._kernel_spectrum(axis_plan, n, rows.device, segment)
    lib = load_probe_library()
    args = (rows.data_ptr(), out.data_ptr(), tw.data_ptr(), h.data_ptr(), int(complex_h),
            rows.shape[0], n, dim, pad, torch.cuda.current_stream(rows.device).cuda_stream)
    if variant == OTHER_SEGMENT:
        rc = lib.fft_cluster_other_segment(int(framed), *args)
    elif variant in CURRENT_VARIANTS:
        rc = lib.fft_cluster_current_ablation(CURRENT_VARIANTS[variant], int(framed), *args)
    else:
        rc = lib.fft_cluster_ablation(CLUSTER_VARIANTS[variant], int(framed), *args)
    check_launch(rc, "fft_cluster_ablation")
    cluster_ablation.launches += 1
    return out


cluster_ablation.launches = 0


def staged_yardstick(rows: torch.Tensor, n: int, axis_plan, framed: bool = False) -> torch.Tensor:
    """The copying staged form of K3 (rows framed to ``n``) or K3f
    (``framed``) at a power of two n from 262144 (where the wide cluster form
    now serves, and past it): a scratch buffer of (R + 1) / 2 x n complex64
    in device memory and a segment pass that copies each segment into shared
    memory and back, the yardstick the package's forms are timed against;
    never a path. A CUDA tensor launches the probe's entry,
    the spectrum in the bin order both forms share; a CPU tensor runs the
    plain version. ``staged_yardstick.launches`` counts."""
    from blur_algorithms_tpu_torch.cuda_kernels import fft4step
    from blur_algorithms_tpu_torch.ops.fft_mxu import _conv_rows_einsum

    if not (16 * fft4step.BODY_N <= n <= 1 << 30 and n & (n - 1) == 0):
        raise ValueError(f"n = {n} is not a length of the copying staged form")
    dim, pad = (axis_plan.dim, axis_plan.pad) if framed else (n, 0)
    if rows.dtype != torch.float32 or rows.ndim != 2 or rows.shape[1] != dim:
        raise ValueError(f"takes (R, {dim}) float32 rows, got {tuple(rows.shape)} {rows.dtype}")
    if rows.device.type == "cpu":
        plain = fft4step.fft_conv_rows_framed_ref if framed else _conv_rows_einsum
        return plain(rows, n, axis_plan)
    if rows.device.type != "cuda" or not rows.is_contiguous():
        raise ValueError(f"takes contiguous CUDA or CPU rows, not {rows.device}")
    from blur_algorithms_tpu_torch.utils.build import load_probe_library

    out = torch.empty_like(rows)
    tw = fft4step._twiddles(n, rows.device)
    h, complex_h = fft4step._kernel_spectrum(axis_plan, n, rows.device)
    scratch = torch.empty(((rows.shape[0] + 1) // 2, n, 2), dtype=torch.float32,
                          device=rows.device)
    rc = load_probe_library().fft_staged_yardstick(
        int(framed), rows.data_ptr(), out.data_ptr(), tw.data_ptr(), h.data_ptr(),
        int(complex_h), rows.shape[0], n, dim, pad, scratch.data_ptr(),
        torch.cuda.current_stream(rows.device).cuda_stream)
    check_launch(rc, "fft_staged_yardstick")
    staged_yardstick.launches += 1
    return out


staged_yardstick.launches = 0


def cluster_cells() -> list[tuple[str, int, int, object, bool]]:
    """(label, rows, n, axis plan, framed): the cluster form's timed shapes.
    K3 on the adjoint's rows of ``blur`` fwd + bwd on a 4 x 3 x 2160 x 15360
    panorama at sigma 400 (n 32768, C 2); K3f on a 24000x14500 RGB frame's
    rows at sigma 900 (n 32768, C 2); K3f on one streamed column strip of 4
    such frames at sigma 1500 (1024 columns a plane, n 65536)."""
    from blur_algorithms_tpu_torch import make_plan

    pano = make_plan((2160, 15360), 400.0).row
    r = pano.support_radius
    n_adj = max(256, 1 << (pano.dim + 4 * r - 1).bit_length())
    giant = make_plan((24000, 14500), 900.0).row
    strip = make_plan((24000, 14500), 1500.0).col
    from blur_algorithms_tpu_torch.ops.fft_mxu import transform_length

    return [
        ("K3 adjoint rows panorama sigma=400", 4 * 3 * 2160, n_adj, pano, False),
        ("K3f giant rows sigma=900", 3 * 24000, transform_length(giant), giant, True),
        ("K3f streamed column strip sigma=1500", 4 * 3 * 1024, transform_length(strip), strip,
         True),
    ]


def cells(batch: int = 4, h: int = 2160, w: int = 3840) -> list[tuple[str, int, int, object, bool]]:
    """(label, rows, n, axis plan, framed): K3 on both axes of the sigma 400
    adjoint and K3f on both axes of sigma 250 on ``batch`` RGB frames, as
    ``chip_smoke.py`` phase 10 builds them."""
    from blur_algorithms_tpu_torch import make_plan
    from blur_algorithms_tpu_torch.ops.fft_mxu import transform_length

    planes = 3 * batch
    out = []
    p = make_plan((h, w), 400.0)
    for ax, rows, label in ((p.row, planes * h, "rows"), (p.col, planes * w, "cols")):
        r = ax.support_radius
        n = max(256, 1 << (ax.dim + 4 * r - 1).bit_length())
        out.append((f"K3 adjoint {label} sigma=400", rows, n, ax, False))
    p = make_plan((h, w), 250.0)
    for ax, rows, label in ((p.row, planes * h, "rows"), (p.col, planes * w, "cols")):
        out.append((f"K3f {label} sigma=250", rows, transform_length(ax), ax, True))
    return out


def jax_default(rows: int = 8192, n: int = 16384) -> tuple[str, int, int, object, bool]:
    """The JAX probe's default cell: ``rows`` rows of K3 at ``n`` (the taps of
    the sigma 400 adjoint's rows on 4K frames, whose transform it is)."""
    from blur_algorithms_tpu_torch import make_plan

    return (f"K3 rows={rows} n={n}", rows, n, make_plan((2160, 3840), 400.0).row, False)


def main(argv: list[str] | None = None) -> int:
    from blur_algorithms_tpu_torch.utils.timing import time_cuda

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    device_arg(p)
    p.add_argument("--rows", type=int, default=8192)
    p.add_argument("--n", type=int, default=16384)
    p.add_argument("--cells", action="store_true", help="the 4K cells of chip_smoke.py")
    args = p.parse_args(argv)
    device = device_of(args.device)
    todo = cells() if args.cells else [jax_default(args.rows, args.n)]
    rng = np.random.default_rng(0)
    for label, nrows, n, ax, framed in todo:
        if device.type == "cpu":  # the plain version of full, on a few rows
            nrows = 4
        x = torch.from_numpy(rng.standard_normal(
            (nrows, ax.dim if framed else n), dtype=np.float32)).to(device)
        full = None
        for mode in [*MODES, *PORT_MODES]:
            if MODES.get(mode, 0) is None:
                emit({"probe": "B2", "cell": label, "mode": mode, "ms": None, "reason": ONE_DOT})
                continue
            if device.type == "cpu":
                if mode == "full":
                    out = conv_rows_ablation(x, n, ax, mode, framed)
                    emit({"probe": "B2", "cell": label, "mode": mode, "device": "cpu",
                          "sum": float(out.double().sum())})
                continue
            ms = time_cuda(conv_rows_ablation, x, n, ax, mode, framed, iters=10,
                           name=mode).median_ms
            full = ms if mode == "full" else full
            emit({"probe": "B2", "cell": label, "mode": mode, "ms": ms,
                  "minus_full_ms": ms - full, "keeps": mask_keeps(_mask(mode)),
                  "device": torch.cuda.get_device_name(device)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
