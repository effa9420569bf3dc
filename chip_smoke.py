"""Chip smoke test of the PyTorch + CUDA port (blur_algorithms_tpu_torch).

Drives the port's main path on one CUDA card and fails loudly on any fault:

1. prints the card (``nvidia-smi`` name and power limit), then builds the
   CUDA kernels from ``blur_algorithms_tpu_torch/csrc`` and prints the time;
   then K2's and its single-axis form's 12 instantiations in the built
   library's SASS (``cuobjdump -sass``): HMMA, their 3xTF32 band products,
   in each, and fewer FFMA than HMMA (no per-tap FMA loop), with ptxas's
   registers and spills;
2. kernel vs plain version: K1 (the fused int8 blur) against its plain
   PyTorch version on the card, uint8 RGB 1080x1920 frames at
   sigma 1, 3, 10, 50, 150 and 180 (support radius up to 598), an
   anisotropic sigma (5, 11) and a ragged 1001x1777 frame; each must be
   ``torch.equal``; then K1's int8 and hybrid instantiations in the built
   library's SASS (``cuobjdump -sass``): IMMA in each, HMMA in the hybrid
   ones, no IDP4A, with ptxas's registers and spills;
3. main path of slice 1: ``blur_u8`` on a (4, 2160, 3840, 3) uint8
   CUDA tensor at sigma 10 (``bench.py``'s configuration, and its frames
   through the port's copy ``utils/frames.make_frames``), K1 on the rung
   AUTO routes (``utils/hw.py``'s certified ladder: K1's hybrid body on the
   H100), through AUTO, or through the rung's pin where the card's uint8
   split radius covers r 32 (the H100's, 82, does not): that body's launch
   count must rise, the result must equal its plain version bit for bit
   (int8; the hybrid body, which sums its taps on the tensor cores in
   groups of 16, within 1 count) and frame 0 must be within 1 count of the
   NumPy oracle; where the rung is not int8,
   the same for K1 int8 through the ``precision="int8"`` pin; then AUTO
   where it splits: the split's two passes once each, frame 0 within 1
   count;
4. times from CUDA events (median of 20 after warm-up): K1 alone, the plain
   version, and the whole ``blur_u8`` AUTO with its layout copies;
5. K2 (the fused f32 blur, 3xTF32 band products on the tensor cores)
   against its plain version (one fmaf a tap) on the card: f32
   planes 1080x1920 at sigma 1, 10, 50 and 180 (r up to 598), sigma
   (5, 11), a radius-0 row axis, asymmetric custom taps on both axes, a
   ragged 1001x1777 frame, and uint8 in / uint8 out with a signed sharpen
   filter; f32 within 1e-3 * max|x| / 255, uint8 within 1 count;
6. main path of slice 2: ``blur`` AUTO on the same batch as float planes
   (4, 3, 2160, 3840) at sigma 10 launches K2 once (or, where the card's
   split radius covers r 32, as on the H100, K2's single-axis form on each
   axis) and not K1, matches K2's plain version and (plane 0) the float64
   direct oracle within 1e-3; its
   backward pass equals ``blur_adjoint`` of the cotangent and satisfies the
   adjoint identity <A x, g> = <x, A^T g> to 1e-5 relative; and
   ``convolve_separable`` with a signed 5-tap sharpen on the uint8 batch
   launches K2, not K1, within 1 count of the plain version;
7. times from CUDA events (median of 20): K2 alone, its plain version,
   ``blur`` forward, forward + backward, the uint8 ``convolve_separable``,
   a yardstick the port never calls (reflect pad + two depthwise
   ``F.conv2d``, TF32 off), the f32 split's two passes (K2's single-axis
   form at r 32) and the bounds (an earlier source's kernels are timed
   against these in turns by ``probes/k2_variants.py --earlier``);
8. K3 (FFT convolution of framed rows) at n 256, 2048, 6144, 7168, 8192
   and 16384, K3f (the same with the framing in the kernel) at n 4096,
   5120, 6144 and 7168 (the main path's lengths), symmetric and asymmetric
   taps, odd row counts, against their plain versions (full-float32
   einsums) on the card within 2e-2 at 0..255 scale, with the worst error;
   K5 (the spectral multiply) on a 4K rfft2 spectrum, bit-equal;
9. main path of slice 3, counts set to 0 first: ``blur_u8`` with
   ``engine="fft_mxu"`` at sigma 250 (r 831) on the batch launches K3f
   twice and nothing else, frame 0 within 1 count of the oracle; ``blur_u8``
   AUTO at sigma 250 launches what the card's crossover routes (the split's
   rows pass and pass 2 once each, or K3f twice), frame 0 within 1 count;
   ``blur`` forward + backward on the
   float batch at sigma 400 (r 1330) launches K3f twice and K3 in the
   backward pass, ``x.grad`` equals ``blur_adjoint(g)`` and plane 0 is
   within 2e-2 of the pocketfft oracle; frame 0 through ``"fft2"``,
   ``"fft_tiles"``, ``"pffft"`` and ``blur_fft2(kernel_multiply=True)``
   (K5), and ``dft_spectrum``, each against its oracle;
10. times (median of 20, of 5 for calls over 100 ms): K3f per axis, K3 per
   axis of the adjoint, K5, their plain versions and the cuFFT yardstick
   ``rfft`` -> multiply -> ``irfft`` on the same framed rows (K5's:
   ``torch.mul`` by the outer product), each kernel against its yardstick
   and its bound (per axis and summed), the registers, shared memory and
   spills ptxas reports for K3/K3f and K5, the whole
   calls, and the fused/FFT crossover sweep: ``blur_u8`` fused against
   FFT_MXU and ``blur`` fused against FFT_MXU, in turns at support radii
   32..598, and ``blur_u8`` on to r 1920 (the split) until the fused engine
   has lost twice (the values ``utils/hw.py`` takes; the fused engine as
   routed, K1/K2, or the split from ``fused_split_min_radius``);
11. K4 (the box scan) on HD planes at support 2..1250, passes 1-3, both
   axes, uint8 and f32 in and out; the int8 split forms (rows to int16 E,
   rows to f32, cols from E to uint8 and f32) at r 2..1996, bit-equal; K2's single-axis form
   at r up to 3994 on both axes, f32 and uint8 in; each against its plain
   version on the card (the single-axis form against its float64 mode:
   the f32 mode's own rounding reaches the limit at r 3994);
12. the slice's paths at full width, counts set to 0 first: ``box_blur`` at
   nsmooth 20 (support 800) on the uint8 batch runs K4 twice and no K1,
   frame 0 within 1 count of the float64 box oracle; on the float batch
   its forward against the plain version and its backward at HD against
   ``blur_adjoint``; ``blur_u8(engine="fused")`` at sigma 250 runs the two
   int8 split forms, frame 0 within 1 count of the oracle; ``blur_u8`` AUTO
   on a 2160x15360 panorama at sigma 250 (FFT_MXU cannot serve it) runs
   the split, three full-height patches of 512 columns within 1 count of
   the oracle on their crops; ``blur(engine="fused")`` at sigma 400 runs
   the f32 split forward (plane 0 within 2e-2 of FFT_MXU) and the adjoint
   backward; ``blur_u8(engine="cascade")`` at sigma 400 within 1 count;
13. times (median of 20, of 5 for calls over 100 ms): K4 per axis (uint8
   and f32, each with the earlier kernel's time as PERF.md records it,
   bound and share, the yardstick and ptxas; the uint8 batch's rows and
   columns first held against the plain version, 1e-3 * max / 255 and 1
   count), the split forms per pass, the int8 cols pass at column r 49,
   165 and 831 on the batch, at HD and on the pre-padded dp 2 x sp 2 shard
   (both stores ``torch.equal`` to the plain version; time, the earlier
   kernel's time as PERF.md records it, bound and share, ptxas), the split with the int8
   pass 2 against the hybrid pass 2 in turns at r 49, 165 and 831 and
   ``blur_u8(engine="fused")`` at sigma (250, 0.9) (the int8 pass 2) beside
   sigma 250 (the hybrid pass 2), the whole calls of phase 12, the plain versions
   (the split's and the single-axis form's at HD), the yardsticks (reflect
   pad + ``avg_pool2d`` per pass for K4, depthwise ``conv2d`` per axis with
   TF32 off for the f32 form), and two sweeps in turns that set
   ``utils/hw.py``'s ``box_scan_crossover_radius`` (box on the fused engine
   against K4 at support 2..338), ``fused_split_min_radius_u8`` (the int8
   split against K1 from r 1, gaussian r 1..332 and box support 2..338) and
   ``fused_split_min_radius`` (the f32 split against K2 at r 2..332; and
   the split against FFT_MXU at r 665..1330, for the record), K1 on the
   rung and in the form AUTO routes;
14. K1's hybrid and bf16 bodies against their plain versions as phase 2,
   (each ``torch.equal``) and the split's hybrid pass 2 at column radius
   332, 831 and 1996, uint8 and f32 out (within 2e-2, 1 count, printing
   the worst difference and the share that differs); at batch 4 RGB 4K sigma 10,
   ``blur_u8(precision="hybrid")`` and ``blur_u8`` AUTO on the card's spec
   with bf16 routed in place of hybrid and no split radius (counts set to 0 first: that body
   alone, equal to its plain version, frame 0 within 1 count);
   ``blur_u8`` AUTO at sigma 15 and 50 (r 49 and 165, where the split runs
   under the fused/FFT crossover) and ``engine="fused"`` at sigma 250,
   each through the split with the pass 2 the device routes, frame 0
   within 1 count; a trimmed certification gate (the 9 patterns of
   ``certify.py`` at 1088x1920, at the headline and at each routed floor,
   for every routed rung, and the split's routed pass 2 at column radius
   49 and 165, each within 1 count); times in turns against K1 int8 and
   against the int8 pass 2 at r 831, the plain versions, bf16 depthwise
   ``conv2d`` yardsticks and the bounds; the split's two tensor-core
   passes at r 49, 165 and 831 on the batch and at HD r 831: time, the
   earlier time, bound and share, the yardstick, registers, shared memory
   and spills (the hybrid pass 2 against its plain version within 2e-2 at
   0..255 scale, 1 count on the uint8 store, here and in phase 16);
15. K1's staging forms (strip K1s, assembled K1a with A5 and its pipelined
   variant, rows-resident K1r) against K1 direct and the body's plain
   version, ``torch.equal``, on phase 2's cases for every rung each serves
   where its block fits, uint8 and f32 out, and A5 against its plain
   version at the JAX geometries; at batch 4 RGB 4K sigma 10, counts set to
   0 first: ``blur_u8`` with AUTO's rung pinned (the form the card
   routes), then with the card's form rule
   replaced to route K1a and K1r, and
   ``blur_fused_u8_dma`` with ``strip=True`` and ``pipelined=True`` (each
   form launched once, equal to the plain version, frame 0 within 1
   count); the repaired ``precision="int8"`` pin at sigma 15 and 100 (r
   49, 332): the form the card's rule names for K1's int8 body, alone, no
   split form; times in turns of K1a (with A5) and K1r against K1 direct
   on 3, 6 and 12 planes at r 6..598, hybrid and int8, and of K1s on 12
   planes to r 99 (the sweep ``utils/hw._MEASURED_K1_FORM`` takes), K1a
   with and without A5, A5 alone, the pipelined variant against K1a, the
   plain versions, the ``F.pad`` yardstick and the bytes bounds;
16. the sharded path (``parallel/``) on meshes of the one card repeated:
   A4 at column radius 1, 32, 332 and 598, K1a on A4's frame (int8, hybrid
   and bf16, uint8 and f32 out), K2 with ``pre_padded_col`` (2-D at r
   2..598; single-axis at column radius 960 and 3994) and the split's int8
   and hybrid pass 2 on pre-padded ``E`` against their plain versions
   (bit-equal; K2 within phase 5's tolerances, the single-axis form against
   the plain version in float64 as in phase 11, the hybrid pass 2 within
   phase 14's); then at full width, counts
   set to 0 before each call: ``blur_sharded_u8`` at sigma 9 (r 29, under
   the card's split radius) on dp 2 x sp 2 and dp 1 x sp 4 (A4 and K1a once
   a shard, nothing else), at sigma 10 on dp 2 x sp 2 (each shard's haloed
   split, where the card's split radius covers r 32), on sp 16 at sigma 50
   (the multi-hop gather) and on a 1001-row crop on sp 4 at sigma 9 (the
   pad-row fill), each ``torch.equal`` to single-card ``blur_u8`` on the
   same rung; ``blur_sharded`` uint8 -> f32 (K1a's int8 f32 store, equal to
   K1 int8's plain version), and on the float batch at sigma 5 (r 15: K2
   pre-padded, as AUTO routes it under the card's float split radius) and
   50 (the haloed f32 split, the card's float crossover raised to r 165 for
   the call) against single-card ``blur``;
   ``blur_sharded_u8`` at sigma 155 with the card's uint8 crossover
   lowered to 165 rerouted to ``blur_fft_sharded`` (no kernel),
   ``blur_fft_sharded_u8`` at sigma 250, both within 1 count of the
   oracle; the haloed int8 split (hybrid, then int8 pass 2) at sigma 250
   under the card's crossover; times of each kernel on a dp 2
   x sp 2 shard at sigma 9 (K2 pre-padded at 5), the plain versions, the ``F.pad`` and ``conv2d``
   yardsticks, the sharded calls against the single-card ones in turns,
   and ``blur_sharded_u8``'s time in parts;
17. the probes B1-B3 (the JAX package's ``benchmarks/`` kernels; their
   library, ``csrc/probes/``, built beside phase 1's, its ptxas lines
   printed here, each mask-0 ablation kernel held to its K3/K3f twin's
   registers and spills): B1's chain (``benchmarks.mxu_dot_rate``) by
   ``mma.sync`` and by ``wgmma`` ``torch.equal`` to its plain version at
   the nine shapes in int8 (``inner`` 3, ``steps`` 2) and within
   ``bf16_bound`` in bf16 (``inner`` 1), and so the launches the rates
   time (filling the card; streamed, and resident against the plain chain
   on ``resident_rhs``) at two shapes; B2 (``fft_mxu_ablation``): ``full``
   ``torch.equal`` to K3's and K3f's production kernels at the JAX probe's
   default and the four 4K cells of phase 10; B3 (``dma_fetch_rate``): the
   windows by ``cp.async`` and by TMA, the strip, and K1's direct and
   assembled loaders at sigma 10's tile, each store ``torch.equal`` to its
   plain version. Then each probe's path: its entry point (``main``, as
   ``python -m`` runs it) with every count at 0 just before and read just
   after, which gives the kernels-line launches, B1's TOP/s per shape,
   path and type (beside ``torch._int_mm`` / bf16 ``matmul`` and the
   published peaks) and B2's ms per mode; B3's GB/s fetched, frame GB/s
   and read amplification beside a ``copy_`` of the frame. No route of the
   blur runs a probe: their counts, set to 0 before phase 3, are still 0
   before phase 17.

The line before the last is a JSON object describing each kernel; the last
is ``{"ok": true, "device": {...}}``. Run from the repository root:

    python3 chip_smoke.py

It exits non-zero, printing no result, where no CUDA device is available.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

SIGMA = 10.0
BATCH, H, W = 4, 2160, 3840
ITERS = 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
INT8_OP_PER_S = 1979e12  # H100 SXM dense int8 tensor-core rate
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
TF32_FLOP_PER_S = 495e12  # H100 SXM dense TF32 tensor-core rate
HD, RAGGED = (1080, 1920), (1001, 1777)  # phase 5 frame shapes
SHARPEN5 = [-0.125, -0.25, 1.75, -0.25, -0.125]  # signed, sums to 1
SIGMA_U8_WIDE, SIGMA_F32_WIDE = 250.0, 400.0  # phase 9: r 831 and r 1330
FFT_TOL = 2e-2  # FFT engines against plain versions and oracles, 0..255 scale
# the split's hybrid pass 2 (tensor-core groups of 16 taps) against its plain
# version (taps one by one): ~2 f32 ulps of |acc| <= 16384 per group, over
# <= ~530 groups at r 4094, over 127; the uint8 store within 1 count
HYBRID_TOL = 2e-2
# phase 10 sweep: support radius 32, 82, 119, 165, 212, 265, 332, 398, 598
SWEEP_SIGMAS = (10.0, 25.0, 36.0, 50.0, 64.0, 80.0, 100.0, 120.0, 180.0)
# and uint8 on past r 598 (the split against FFT_MXU): r 665, 831, 997,
# 1164, 1330, 1497, 1663, 1830 and 1920 (the plan's limit on 3840 columns)
SWEEP_SIGMAS_U8_WIDE = (200.0, 250.0, 300.0, 350.0, 400.0, 450.0, 500.0, 550.0, 600.0)
BOX_NSMOOTH = 20.0  # phase 12: box_blur radius 400, support radius 800
PANO_H, PANO_W = 2160, 15360  # phase 12: a panorama FFT_MXU cannot serve
SIGMA_CASCADE = 400.0  # phase 12: one cascade step at r 1330
# phase 13 sweeps: box radius per pass (2 passes: support 2..338), and the
# split against the single kernels (r 2, 4, 7, 10, 12, 15, 19, 24, 29, 32,
# 49, 65, 82, 119, 165, 212, 265, 332) and against FFT_MXU (r 665, 831,
# 1330)
BOX_SWEEP_R = (1, 4, 16, 41, 82, 169)
SPLIT_SWEEP_SIGMAS = (1.0, 1.5, 2.5, 3.5, 4.0, 5.0, 6.0, 7.5, 9.0, 10.0, 15.0, 20.0, 25.0,
                      36.0, 50.0, 64.0, 80.0, 100.0)
# phase 13's uint8 split sweep from r 1: gaussian r 1..332, box support 2..338
U8_SPLIT_SIGMAS = (0.6, 1.0, 2.1, 3.0, 5.1, 7.0, 10.0, 15.0, 20.0, 25.0, 30.0, 36.0, 50.0,
                   100.0)
U8_SPLIT_BOX_R = (1, 2, 4, 8, 16, 24, 33, 41, 50, 66, 82, 169)
SPLIT_FFT_SIGMAS = (200.0, 250.0, 400.0)
# phase 11 cases: K4 (radius per pass, passes) on HD planes; the int8 split
# forms and K2's single-axis form as (frame shape, sigma)
BOX_CASES = ((1, 2), (8, 1), (41, 2), (110, 3), (625, 2))
SPLIT_CASES = ((HD, 1.0), (HD, 3.0), (HD, 50.0), (HD, 250.0), ((256, 4200), 600.0))
AXIS_CASES = ((HD, 10.0), (HD, 400.0), ((96, 8400), 1200.0), ((8400, 96), 1200.0))
# phase 14: K1's hybrid and bf16 bodies as phase 2 (r 2..598); the split's
# hybrid pass 2 at column radius 332, 831 and 1996
HYBRID_SPLIT_CASES = ((HD, 100.0), (HD, 250.0), ((4200, 256), (600.0, 3.0)))
# phase 14: AUTO through the split under the fused/FFT crossover (r 49, 165)
AUTO_SPLIT_SIGMAS = (15.0, 50.0)


def _bound_ms(nbytes: float, ops: float, op_rate: float) -> tuple[float, str]:
    """Least time for the work: bytes over the memory rate or operations
    over the peak rate, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / op_rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _case_frames(h: int, w: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    planes = rng.integers(0, 256, size=(3, h, w), dtype=np.uint8)
    return torch.from_numpy(planes).cuda()


def _f32_planes(h: int, w: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.random((3, h, w)) * 255).astype(np.float32)).cuda()


def _phase5(make_plan, fused_blur) -> tuple[float, int]:
    """K2 against its plain version; returns the worst f32 error and the
    worst uint8 error."""
    from blur_algorithms_tpu_torch import make_custom_plan
    from blur_algorithms_tpu_torch.ops.kernels import gaussian_kernel

    hd = HD
    cases = [(f"sigma={s}", make_plan(hd, s)) for s in (1.0, 10.0, 50.0, 180.0)]
    cases += [
        ("sigma=(5, 11)", make_plan(hd, (5.0, 11.0))),
        ("radius-0 row axis", make_custom_plan(hd, [1.0], gaussian_kernel(4.0, 25))),
        ("asymmetric taps", make_custom_plan(
            hd, [0.05, 0.1, 0.5, 0.2, 0.3, -0.1, 0.02],
            [-0.2, 0.4, 0.9, 0.1, -0.05])),
        ("ragged sigma=10", make_plan(RAGGED, SIGMA)),
    ]
    f32_err = 0.0
    for k, (name, plan) in enumerate(cases):
        x = _f32_planes(*plan.shape, seed=100 + k)
        got = fused_blur.blur_fused_f32(x, plan)
        want = fused_blur.blur_fused_f32_ref(x, plan)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        limit = 1e-3 * float(x.abs().max()) / 255.0
        f32_err = max(f32_err, err)
        print(f"phase 5 K2 vs plain: {plan.shape[0]}x{plan.shape[1]}x3 f32 {name} "
              f"r=({plan.col.support_radius}, {plan.row.support_radius}) "
              f"max_abs_err={err:.3e} limit={limit:.3e}", flush=True)
        if not err <= limit:
            raise RuntimeError(f"K2 disagrees with its plain version: {name}")

    plan = make_custom_plan(hd, [-0.25, 1.5, -0.25])
    x = _case_frames(*hd, seed=200)
    got = fused_blur.blur_fused_f32(x, plan, out_u8=True)
    want = fused_blur.blur_fused_f32_ref(x, plan, out_u8=True)
    torch.cuda.synchronize()
    d = (got.int() - want.int()).abs()
    u8_err = int(d.max())
    print(f"phase 5 K2 vs plain: {hd[0]}x{hd[1]}x3 uint8 -> uint8, sharpen "
          f"[-0.25, 1.5, -0.25]: max_abs_err={u8_err} "
          f"exact={float((d == 0).float().mean())}", flush=True)
    if u8_err > 1:
        raise RuntimeError(f"K2 uint8 store is {u8_err} counts from the plain version")
    return f32_err, u8_err


def _slice2(frames, make_plan, oracle, fused_blur, fused_dma, timing) -> dict:
    """Phases 5-7; returns K2's entry of the kernels line."""
    import torch.nn.functional as F

    from blur_algorithms_tpu_torch import blur, convolve_separable
    from blur_algorithms_tpu_torch.ops.adjoint import blur_adjoint

    f32_err, u8_err = _phase5(make_plan, fused_blur)

    # ---- phase 6: the slice's path at full width ----
    x = torch.from_numpy(frames.astype(np.float32)).cuda()  # (B, C, H, W)
    plan = make_plan((H, W), SIGMA)
    # AUTO runs K2, or the f32 split (K2's single-axis form on each axis)
    # where the card's split radius covers sigma 10's r 32
    split = fused_blur._split_wins(plan, 4, "bf16x3", x.device)
    counted = (fused_dma.blur_fused_u8_dma, fused_blur.blur_fused_f32,
               fused_blur.blur_fused_axis_f32)
    torch.cuda.synchronize()
    for c in counted:
        c.launches = 0
    out = blur(x, SIGMA)
    torch.cuda.synchronize()
    ran = {c.__name__: c.launches for c in counted if c.launches}
    launches = fused_blur.blur_fused_f32.launches
    if ran != ({"blur_fused_axis_f32": 2} if split else {"blur_fused_f32": 1}):
        raise RuntimeError(f"blur AUTO at sigma {SIGMA} launched {ran}")
    if out.shape != x.shape or out.dtype != torch.float32 or out.device != x.device:
        raise RuntimeError(f"blur returned {out.shape} {out.dtype} {out.device}")
    ref = fused_blur.blur_fused_f32_ref(x, plan)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    f32_err = max(f32_err, err)
    limit = 1e-3 * float(x.abs().max()) / 255.0
    if not err <= limit:
        raise RuntimeError(f"blur differs from the plain version by {err}")
    del ref
    want0 = oracle.blur_direct(frames[0, 0].astype(np.float32), plan)
    d0 = float(np.abs(out[0, 0].cpu().numpy().astype(np.float64) - want0).max())
    print(f"phase 6 main path: blur AUTO {tuple(x.shape)} f32 sigma={SIGMA}: "
          f"launches {ran}, vs K2's plain version max_abs_err={err:.3e}, "
          f"plane 0 vs float64 oracle max={d0:.3e}", flush=True)
    if not d0 <= 1e-3:
        raise RuntimeError(f"plane 0 is {d0} from the oracle")

    g_np = np.random.default_rng(7).random(x.shape, dtype=np.float32)
    g = torch.from_numpy(g_np).cuda()
    xg = x.clone().requires_grad_()
    y = blur(xg, SIGMA)
    (y * g).sum().backward()
    want = blur_adjoint(g, plan)
    torch.cuda.synchronize()
    gerr = float((xg.grad - want).abs().max())
    gscale = float(want.abs().max())
    lhs = float((y.detach().double() * g.double()).sum())
    rhs = float((x.double() * xg.grad.double()).sum())
    rel = abs(lhs - rhs) / abs(lhs)
    print(f"phase 6 backward: x.grad vs blur_adjoint(g) max={gerr:.3e} "
          f"(max |grad| {gscale:.3e}); <Ax,g>={lhs!r} <x,A^T g>={rhs!r} "
          f"relative {rel:.3e}", flush=True)
    if not gerr <= 1e-6 * gscale:
        raise RuntimeError(f"x.grad differs from blur_adjoint(g) by {gerr}")
    if not rel <= 1e-5:
        raise RuntimeError(f"the adjoint identity fails by {rel}")
    del xg, y, want, g

    img = torch.from_numpy(np.ascontiguousarray(np.moveaxis(frames, 1, -1))).cuda()
    fused_dma.blur_fused_u8_dma.launches = 0
    fused_blur.blur_fused_f32.launches = 0
    sharp = convolve_separable(img, SHARPEN5)
    torch.cuda.synchronize()
    conv_launches = fused_blur.blur_fused_f32.launches
    if conv_launches < 1 or fused_dma.blur_fused_u8_dma.launches:
        raise RuntimeError("convolve_separable on uint8 did not run K2 alone")
    launches += conv_launches  # K2's launches on the slice's paths
    from blur_algorithms_tpu_torch import make_custom_plan

    splan = make_custom_plan((H, W), SHARPEN5)
    sref = fused_blur.blur_fused_f32_ref(
        img.movedim(-1, -3).contiguous(), splan, out_u8=True).movedim(-3, -1)
    torch.cuda.synchronize()
    sd = (sharp.int() - sref.int()).abs()
    serr = int(sd.max())
    u8_err = max(u8_err, serr)
    print(f"phase 6 convolve_separable uint8 {tuple(img.shape)} sharpen "
          f"{SHARPEN5}: K2 launches={conv_launches}, K1 launches=0, vs plain "
          f"max={serr} exact={float((sd == 0).float().mean())}", flush=True)
    if serr > 1:
        raise RuntimeError(f"convolve_separable is {serr} counts from the plain version")
    del sref, sd, sharp

    # ---- phase 7: times ----
    mp = BATCH * H * W / 1e6
    k2 = timing.time_cuda(fused_blur.blur_fused_f32, x, plan, iters=ITERS,
                          name="K2 fused_blur f32", megapixels=mp)
    plain = timing.time_cuda(fused_blur.blur_fused_f32_ref, x, plan,
                             iters=ITERS, name="K2 plain version", megapixels=mp)
    fwd = timing.time_cuda(blur, x, SIGMA, iters=ITERS, name="blur forward",
                           megapixels=mp)
    gt = torch.ones_like(x)

    def fwd_bwd(t):
        t = t.detach().requires_grad_()
        blur(t, SIGMA).backward(gt)
        return t.grad

    both = timing.time_cuda(fwd_bwd, x, iters=ITERS,
                            name="blur forward + backward", megapixels=mp)
    conv = timing.time_cuda(convolve_separable, img, SHARPEN5, iters=ITERS,
                            name="convolve_separable uint8 sharpen", megapixels=mp)
    rh, rw = plan.col.support_radius, plan.row.support_radius
    c = x.shape[1]
    w_row = torch.from_numpy(plan.row.taps).cuda().view(1, 1, 1, -1).repeat(c, 1, 1, 1)
    w_col = torch.from_numpy(plan.col.taps).cuda().view(1, 1, -1, 1).repeat(c, 1, 1, 1)

    def library(t):
        t = F.pad(t, (rw, rw, rh, rh), mode="reflect")
        t = F.conv2d(t, w_row, groups=c)
        return F.conv2d(t, w_col, groups=c)

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        lib_err = float((library(x) - out).abs().max())
        lib = timing.time_cuda(library, x, iters=ITERS,
                               name="yardstick: reflect pad + 2 depthwise conv2d",
                               megapixels=mp)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    # the f32 split's two passes at sigma 10 (K2's single-axis form), what
    # blur AUTO runs where the card's split radius covers r 32
    rows10, cols10 = fused_blur._split_plans(plan)
    y10 = fused_blur.blur_fused_axis_f32(x, rows10)
    passes = {"rows": timing.time_cuda(fused_blur.blur_fused_axis_f32, x, rows10, iters=ITERS,
                                       name=f"K2 single-axis rows pass r={rw}", megapixels=mp),
              "cols": timing.time_cuda(fused_blur.blur_fused_axis_f32, y10, cols10,
                                       iters=ITERS, name=f"K2 single-axis cols pass r={rh}",
                                       megapixels=mp)}
    for res in (k2, plain, fwd, both, conv, lib, *passes.values()):
        print(f"phase 7 time: {res}", flush=True)
    print(f"phase 7 yardstick vs blur: max_abs_err={lib_err:.3e}", flush=True)

    outputs = x.numel()
    bound, by = _bound_ms(8 * outputs, outputs * (_band_flop(rw) + _band_flop(rh)),
                          TF32_FLOP_PER_S)
    b_pass = _bound_ms(8 * outputs, outputs * _band_flop(rw), TF32_FLOP_PER_S)
    print(f"phase 7 bounds (ms): K2 {bound:.4f} ({by}), a single-axis pass at r {rw} "
          f"{b_pass[0]:.4f} ({b_pass[1]}); the earlier f32 bound of K2 (one fmaf a tap at 67 "
          f"TFLOP/s) {_bound_ms(8 * outputs, 2 * outputs * (2 * rw + 2 * rh + 2), F32_FLOP_PER_S)[0]:.4f}",
          flush=True)
    del y10
    return {
        "name": "fused_blur_f32",
        "route": "cuda",
        "source": "blur_algorithms_tpu_torch/csrc/fused_blur.cu",
        "replaces": "blur_algorithms_tpu/pallas_kernels/fused_blur.py:136",
        "launches": launches,
        "max_abs_err": f32_err,
        "max_abs_err_u8": u8_err,
        "ms": k2.median_ms,
        "plain_ms": plain.median_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": lib.median_ms,
    }


def _time(fn, *args, name: str, mp: float | None = None):
    """Median of 20 CUDA-event timings, or of 5 for calls over 100 ms."""
    from blur_algorithms_tpu_torch.utils import timing

    first = timing.time_cuda(fn, *args, iters=1, warmup=1, name=name)
    iters = 5 if first.median_ms > 100 else ITERS
    return timing.time_cuda(fn, *args, iters=iters, warmup=1, name=name,
                            megapixels=mp)


def _fft_work(rows: int, n: int, row_bytes: int, complex_h: bool) -> tuple[float, float]:
    """Bytes and f32 operations of one K3/K3f launch: rows of ``row_bytes``
    read and written once, the spectrum and twiddles read once; two
    length-n FFTs (5 n log2 n each) and the spectral multiply per pair of
    rows."""
    pairs = (rows + 1) // 2
    nbytes = 2 * rows * row_bytes + n * (16 if complex_h else 12)
    ops = pairs * (10 * n * np.log2(n) + (6 if complex_h else 2) * n)
    return nbytes, ops


def _wide_taps(width: int, asymmetric: bool) -> np.ndarray:
    from blur_algorithms_tpu_torch.ops.kernels import gaussian_kernel

    t = gaussian_kernel(width / 6.0, width).astype(np.float64)
    if asymmetric:
        t *= np.linspace(0.6, 1.4, width)
    return (t / t.sum()).astype(np.float32)


def _phase8(frames) -> dict:
    """K3, K3f and K5 against their plain versions; returns the worst
    errors."""
    from blur_algorithms_tpu_torch import make_custom_plan, make_plan
    from blur_algorithms_tpu_torch.cuda_kernels import fft4step, spectral_multiply
    from blur_algorithms_tpu_torch.ops import fft_conv
    from blur_algorithms_tpu_torch.ops.fft_mxu import _conv_rows_einsum, transform_length
    from blur_algorithms_tpu_torch.ops.pad import reflect_101

    errs = {"K3": 0.0, "K3f": 0.0, "K5": 0.0}
    # the main path's lengths: K3f's 4096..7168 (Q 1, 3, 5, 7), the
    # adjoint's 8192 and 16384
    for n, width in ((256, 101), (2048, 801), (6144, 2001), (7168, 2661), (8192, 2661),
                     (16384, 2661)):
        for asym in (False, True):
            plan = make_custom_plan((8, n), _wide_taps(width, asym), [1.0])
            rows = torch.from_numpy(
                (np.random.default_rng(n).random((33, n)) * 255).astype(np.float32)).cuda()
            got = fft4step.fft_conv_rows(rows, n, plan.row)
            want = _conv_rows_einsum(rows, n, plan.row)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            errs["K3"] = max(errs["K3"], err)
            print(f"phase 8 K3 vs plain: 33 rows n={n} taps={width} "
                  f"{'asymmetric' if asym else 'symmetric'} max_abs_err={err:.3e} "
                  f"limit={FFT_TOL}", flush=True)
            if not err <= FFT_TOL:
                raise RuntimeError(f"K3 disagrees with its plain version at n={n}")
    for dim, width in ((2160, 1663), (3840, 1663), (2160, 2661), (3840, 2661)):
        for asym in (False, True):
            plan = make_custom_plan((8, dim), _wide_taps(width, asym), [1.0])
            n = transform_length(plan.row)
            rows = torch.from_numpy(
                (np.random.default_rng(dim).random((7, dim)) * 255).astype(np.float32)).cuda()
            got = fft4step.fft_conv_rows_framed(rows, n, plan.row)
            want = fft4step.fft_conv_rows_framed_ref(rows, n, plan.row)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            errs["K3f"] = max(errs["K3f"], err)
            print(f"phase 8 K3f vs plain: 7 rows dim={dim} n={n} taps={width} "
                  f"{'asymmetric' if asym else 'symmetric'} max_abs_err={err:.3e} "
                  f"limit={FFT_TOL}", flush=True)
            if not err <= FFT_TOL:
                raise RuntimeError(f"K3f disagrees with its plain version at n={n}")

    plan = make_plan((H, W), SIGMA)
    (bt, bb), (bl, br) = plan.col.border, plan.row.border
    planes = torch.from_numpy(frames[0].astype(np.float32)).cuda()
    spec = torch.fft.rfft2(reflect_101(planes, [(bt, bb), (bl, br)]))
    col = fft_conv._mirror_full(plan.col.spectrum, plan.fft_shape[0])
    got = spectral_multiply.spectral_multiply_2d(spec, col, plan.row.spectrum)
    want = spectral_multiply.spectral_multiply_2d_ref(spec, col, plan.row.spectrum)
    torch.cuda.synchronize()
    equal = torch.equal(got, want)
    errs["K5"] = float((got - want).abs().max())
    print(f"phase 8 K5 vs plain: rfft2 spectrum {tuple(spec.shape)} of frame 0 "
          f"(sigma {SIGMA}) equal={equal}", flush=True)
    if not equal:
        raise RuntimeError("K5 disagrees with its plain version")
    print(f"phase 8 worst: K3 max_abs_err={errs['K3']:.3e}, K3f max_abs_err="
          f"{errs['K3f']:.3e} (limit {FFT_TOL}); K5 equal", flush=True)
    return errs


def _phase9(frames, counters) -> dict:
    """The slice's main path at full width; returns the launches of K3,
    K3f and K5 in it."""
    from blur_algorithms_tpu_torch import blur, blur_u8, dft_spectrum, make_plan, oracle
    from blur_algorithms_tpu_torch.api import Engine, _resolve_engine
    from blur_algorithms_tpu_torch.cuda_kernels import fft4step
    from blur_algorithms_tpu_torch.ops import fft_conv
    from blur_algorithms_tpu_torch.ops.adjoint import blur_adjoint

    k3, k3f = fft4step.fft_conv_rows, fft4step.fft_conv_rows_framed
    img = np.ascontiguousarray(np.moveaxis(frames, 1, -1))
    x_u8 = torch.from_numpy(img).cuda()
    x = torch.from_numpy(frames.astype(np.float32)).cuda()
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0

    # FFT_MXU by name: with the split on the tensor cores the card's uint8
    # crossover lies past r 831, so AUTO runs the split there (checked next)
    plan = make_plan((H, W), SIGMA_U8_WIDE)
    out = blur_u8(x_u8, SIGMA_U8_WIDE, engine="fft_mxu")
    torch.cuda.synchronize()
    launched = {c.__name__: c.launches for c in counters}
    want0 = oracle.blur_u8(img[0], SIGMA_U8_WIDE)
    d = np.abs(out[0].cpu().numpy().astype(int) - want0.astype(int))
    print(f"phase 9 main path: blur_u8 engine=fft_mxu {tuple(x_u8.shape)} "
          f"sigma={SIGMA_U8_WIDE} r={plan.row.support_radius}; launches {launched}; "
          f"frame 0 vs oracle max={int(d.max())} exact={float((d == 0).mean())}",
          flush=True)
    if k3f.launches != 2 or sum(launched.values()) != 2:
        raise RuntimeError(f"blur_u8 at sigma {SIGMA_U8_WIDE} did not run K3f twice alone")
    if out.shape != x_u8.shape or out.dtype != torch.uint8 or d.max() > 1:
        raise RuntimeError(f"blur_u8 at sigma {SIGMA_U8_WIDE}: {out.shape} {out.dtype}, "
                           f"{int(d.max())} counts from the oracle")
    del out
    # AUTO at the same sigma: the route the card's crossover gives
    from blur_algorithms_tpu_torch.cuda_kernels import fused_split

    eng = _resolve_engine("auto", plan, 1, x_u8.device, BATCH * 3)
    split = (fused_split.fused_split_rows_int8, fused_split.fused_split_cols_hybrid,
             fused_split.fused_split_cols_int8)
    before = [c.launches for c in (*counters, *split)]
    out = blur_u8(x_u8, SIGMA_U8_WIDE)
    torch.cuda.synchronize()
    ran = {c.__name__: c.launches - b for c, b in zip((*counters, *split), before)}
    d = np.abs(out[0].cpu().numpy().astype(int) - want0.astype(int))
    print(f"phase 9 main path: blur_u8 AUTO sigma={SIGMA_U8_WIDE} -> {eng.value}; launches "
          f"{ran}; frame 0 vs oracle max={int(d.max())} exact={float((d == 0).mean())}",
          flush=True)
    want = ({"fft_conv_rows_framed": 2} if eng is Engine.FFT_MXU else
            {"fused_split_rows_int8": 1, _pass2(plan, x_u8.device): 1})
    if {k: v for k, v in ran.items() if v} != want or d.max() > 1:
        raise RuntimeError(f"blur_u8 AUTO at sigma {SIGMA_U8_WIDE} ({eng.value}) launched "
                           f"{ran}, not {want}, or is past 1 count of the oracle")
    del out

    plan = make_plan((H, W), SIGMA_F32_WIDE)
    g = torch.from_numpy(np.random.default_rng(7).random(x.shape, dtype=np.float32)).cuda()
    xg = x.clone().requires_grad_()
    before = (k3.launches, k3f.launches)
    y = blur(xg, SIGMA_F32_WIDE)
    torch.cuda.synchronize()
    fwd = (k3.launches - before[0], k3f.launches - before[1])
    (y * g).sum().backward()
    torch.cuda.synchronize()
    bwd = (k3.launches - before[0] - fwd[0], k3f.launches - before[1] - fwd[1])
    check = k3.launches
    want = blur_adjoint(g, plan)  # a check: its launches are not the path's
    torch.cuda.synchronize()
    k3.launches = check
    gerr = float((xg.grad - want).abs().max())
    gscale = float(want.abs().max())
    ref0 = oracle.blur_planar_fft2(frames[0, 0].astype(np.float64), plan)
    d0 = float(np.abs(y[0, 0].detach().cpu().numpy().astype(np.float64) - ref0).max())
    print(f"phase 9 main path: blur forward + backward {tuple(x.shape)} f32 "
          f"sigma={SIGMA_F32_WIDE} r=({plan.col.support_radius}, "
          f"{plan.row.support_radius}): forward K3/K3f launches {fwd}, backward "
          f"{bwd}; plane 0 vs pocketfft oracle max={d0:.3e} limit={FFT_TOL}; "
          f"x.grad vs blur_adjoint(g) max={gerr:.3e} (max |grad| {gscale:.3e})",
          flush=True)
    if fwd != (0, 2) or bwd[0] < 1 or bwd[1] != 0:
        raise RuntimeError(f"blur at sigma {SIGMA_F32_WIDE}: K3/K3f launches {fwd}, {bwd}")
    if not d0 <= FFT_TOL:
        raise RuntimeError(f"plane 0 is {d0} from the oracle")
    if not gerr <= 1e-6 * gscale:
        raise RuntimeError(f"x.grad differs from blur_adjoint(g) by {gerr}")
    del xg, y, g, want

    frame = x_u8[:1]
    for engine, size_mode, ref in (
        ("fft2", "auto", oracle.blur_u8(img[0], SIGMA)),
        ("fft_tiles", "auto", oracle.blur_u8(img[0], SIGMA)),
        ("pffft", "smooth235", oracle.blur_u8_pffft(img[0], SIGMA)),
    ):
        got = blur_u8(frame, SIGMA, engine=engine, size_mode=size_mode)
        d = np.abs(got[0].cpu().numpy().astype(int) - ref.astype(int))
        print(f"phase 9 blur_u8 engine={engine} frame 0 sigma={SIGMA} vs its oracle: "
              f"max={int(d.max())} exact={float((d == 0).mean())}", flush=True)
        if d.max() > 1:
            raise RuntimeError(f"engine {engine} is {int(d.max())} counts from its oracle")
    plan = make_plan((H, W), SIGMA)
    got = fft_conv.blur_fft2(x[0], plan, kernel_multiply=True)
    d = float(np.abs(got.cpu().numpy() - oracle.blur_planar_fft2(frames[0], plan)).max())
    print(f"phase 9 blur_fft2(kernel_multiply=True) frame 0 sigma={SIGMA} vs "
          f"pocketfft oracle max={d:.3e} limit={FFT_TOL}", flush=True)
    if not d <= FFT_TOL:
        raise RuntimeError(f"blur_fft2 with K5 is {d} from the oracle")
    spec = dft_spectrum(frame, SIGMA)[0].cpu().numpy()
    want = oracle.dft_spectrum_np(frames[0].astype(np.float32), plan)
    a, b = 10.0 ** (spec.astype(np.float64) / 20), 10.0 ** (want.astype(np.float64) / 20)
    rel = float(np.abs(a - b).max() / b.max())
    print(f"phase 9 dft_spectrum frame 0 {spec.shape}: magnitudes vs oracle "
          f"max/peak={rel:.3e} limit=4e-6", flush=True)
    if spec.shape != want.shape or not rel <= 4e-6:
        raise RuntimeError(f"dft_spectrum is {rel} (of the peak) from the oracle")
    launched = {c.__name__: c.launches for c in counters}
    print(f"phase 9 launches on the main path: {launched}", flush=True)
    for c in (k3, k3f, counters[-1]):
        if c.launches < 1:
            raise RuntimeError(f"{c.__name__} was not launched on the main path")
    return launched


def _fft_yardstick(rows: torch.Tensor, axis_plan, n: int, framed: bool):
    """cuFFT through torch.fft on the same framed rows: rfft, multiply by
    the half correlation spectrum, irfft (the library time; never a
    route of the port). Returns the framed rows and the call."""
    import torch.nn.functional as F

    from blur_algorithms_tpu_torch.ops.kernels import wrap_centered
    from blur_algorithms_tpu_torch.ops.pad import reflect_101

    if framed:
        pad = axis_plan.pad
        rows = F.pad(reflect_101(rows, [(pad, pad)]), (0, n - rows.shape[-1] - 2 * pad))
    half = np.conj(np.fft.rfft(wrap_centered(axis_plan.taps, n).astype(np.float64)))
    half = torch.from_numpy(half.astype(np.complex64)).cuda()
    return rows.contiguous(), lambda t: torch.fft.irfft(torch.fft.rfft(t) * half, n=n)


def _kernel_times(entry, rows, n, axis_plan, framed: bool, label: str) -> dict:
    """One K3/K3f launch: its time, its plain version's time and error,
    the cuFFT yardstick and the bound."""
    from blur_algorithms_tpu_torch.cuda_kernels import fft4step
    from blur_algorithms_tpu_torch.ops.fft_mxu import _conv_rows_einsum

    plain = fft4step.fft_conv_rows_framed_ref if framed else _conv_rows_einsum
    got = entry(rows, n, axis_plan)
    want = plain(rows, n, axis_plan)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    del got, want
    t_k = _time(entry, rows, n, axis_plan, name=f"{label} kernel")
    t_p = _time(plain, rows, n, axis_plan, name=f"{label} plain version")
    framed_rows, lib = _fft_yardstick(rows, axis_plan, n, framed)
    t_l = _time(lib, framed_rows, name=f"{label} cuFFT rfft -> multiply -> irfft")
    del framed_rows
    for res in (t_k, t_p, t_l):
        print(f"phase 10 time: {res}", flush=True)
    nbytes, ops = _fft_work(rows.shape[0], n, 4 * rows.shape[1], not axis_plan.symmetric)
    bound, by = _bound_ms(nbytes, ops, F32_FLOP_PER_S)
    print(f"phase 10 {label}: {rows.shape[0]} rows x {rows.shape[1]}, n={n}, "
          f"vs plain max_abs_err={err:.3e}; bound {bound:.4f} ms ({by}: "
          f"{nbytes / 1e9:.3f} GB, {ops / 1e9:.2f} GFLOP)", flush=True)
    return {"ms": t_k.median_ms, "plain_ms": t_p.median_ms, "library_ms": t_l.median_ms,
            "bound_ms": bound, "bound_by": by, "err": err, "bytes": nbytes, "ops": ops}


def _sum_axes(a: dict, b: dict) -> dict:
    """Both axes of one call as one entry: times and bounds add up."""
    nbytes, ops = a["bytes"] + b["bytes"], a["ops"] + b["ops"]
    bound, by = _bound_ms(nbytes, ops, F32_FLOP_PER_S)
    return {"ms": a["ms"] + b["ms"], "plain_ms": a["plain_ms"] + b["plain_ms"],
            "library_ms": a["library_ms"] + b["library_ms"], "bound_ms": bound,
            "bound_by": by, "err": max(a["err"], b["err"])}


def _template_args(tail: str) -> list[str]:
    """The template arguments in the tail of a mangled kernel name, in
    order: int and bool literals, after a leading float or uint8_t type
    argument where there is one (K2's input type)."""
    lead = re.match(r"I([fh])", tail)
    return ([{"f": "float", "h": "uint8_t"}[lead.group(1)]] if lead else []) + [
        ("false", "true")[int(v)] if k == "b" else v
        for k, v in re.findall(r"L([ib])(\d+)E", tail)]


def _ptxas_lines(kernels, log: str | None = None) -> list[tuple[str, str]]:
    """(kernel and template arguments, registers / shared memory / spills)
    from a build's ``-Xptxas -v`` output (the kernel library's unless
    ``log`` is given), for entry functions whose name holds one of
    ``kernels``."""
    from blur_algorithms_tpu_torch.utils import build

    out, name = [], None
    for ln in (build.last_build.get("log", "") if log is None else log).splitlines():
        if "Compiling entry function" in ln:
            hit = [k for k in kernels if k in ln]
            name = None
            if hit:
                tail = ln.split(hit[0], 1)[1].split("EvP")[0]  # the template arguments
                args = _template_args(tail)
                name = hit[0] + (f"<{', '.join(args)}>" if args else "")
                out.append([name, ""])
        elif name and ("Used" in ln or "spill" in ln):
            out[-1][1] = (out[-1][1] + " " + ln.replace("ptxas info    :", "").strip()).strip()
    return [tuple(x) for x in out]


SASS_OPS = ("IMMA", "HMMA", "IDP4A", "FFMA")


def _sass_counts(kernels) -> dict[str, dict[str, int]]:
    """Instruction counts of ``SASS_OPS`` in the kernel library's SASS
    (``cuobjdump -sass``), per entry function whose name holds one of
    ``kernels``, keyed as ``_ptxas_lines`` keys them (name<template
    arguments>): what shows whether a body runs on the tensor cores (IMMA,
    HMMA) or on ``__dp4a`` (IDP.4A)."""
    import shutil

    from blur_algorithms_tpu_torch.utils import build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", build.last_build["library"]], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, name = {}, None
    for ln in sass.splitlines():
        if "Function : " in ln:
            fn = ln.split("Function : ", 1)[1].strip()
            hit = [k for k in kernels if k in fn]
            name = None
            if hit:
                tail = fn.split(hit[0], 1)[1].split("Ev")[0]
                args = _template_args(tail)
                name = hit[0] + (f"<{', '.join(args)}>" if args else "")
                out[name] = dict.fromkeys(SASS_OPS, 0)
        elif name:
            op = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)(\.[A-Z0-9.]+)?", ln)
            if op:
                code = op.group(1) + ("4A" if (op.group(2) or "").startswith(".4A") else "")
                if code in out[name]:
                    out[name][code] += 1
    return out


K1_TC_KERNELS = ("k1_direct", "k1_strip", "k1_assembled", "k1_resident")


def _k1_sass() -> None:
    """Phase 2: K1's int8 and hybrid instantiations on the tensor cores, from
    the built library's SASS: IMMA in every one (the rows pass, and the int8
    cols pass), HMMA in the hybrid ones (its cols pass), no IDP4A (the
    per-lane dp4a the bodies ran before); with ptxas's registers and
    spills."""
    sass = _sass_counts(K1_TC_KERNELS)
    ptx = dict(_ptxas_lines(K1_TC_KERNELS))
    for name, c in sass.items():
        body = "int8" if name.split("<")[1].startswith("0") else "hybrid"
        print(f"phase 2 SASS {name} ({body}): IMMA {c['IMMA']}, HMMA {c['HMMA']}, IDP4A "
              f"{c['IDP4A']}; ptxas {ptx.get(name, 'not reported')}", flush=True)
        if c["IDP4A"] or not c["IMMA"] or (body == "hybrid" and not c["HMMA"]):
            raise RuntimeError(f"{name} ({body}) is not on the tensor cores: {c}")
    if len(sass) != 18:  # 4 forms x 2 bodies x 2 stores, and int8's pipelined pair
        raise RuntimeError(f"the SASS holds {len(sass)} K1 tensor-core instantiations, not "
                           f"18: {sorted(sass)}")


K2_KERNELS = ("fused_blur_f32_kernel", "fused_axis_kernel")


def _k2_sass() -> None:
    """Phase 1: K2 and its single-axis form on the tensor cores, from the
    built library's SASS: HMMA (the 3xTF32 band products) in each of the 12
    instantiations (K2, and the single-axis form on each axis, x two input
    types x two stores), and no per-tap FFMA loop (fewer FFMA than HMMA;
    the kernels ran one fmaf a tap before); with ptxas's registers and
    spills."""
    sass = _sass_counts(K2_KERNELS)
    ptx = dict(_ptxas_lines(K2_KERNELS))
    for name, c in sorted(sass.items()):
        print(f"phase 1 SASS {name}: HMMA {c['HMMA']}, FFMA {c['FFMA']}; ptxas "
              f"{ptx.get(name, 'not reported')}", flush=True)
        if not c["HMMA"] or c["FFMA"] >= c["HMMA"]:
            raise RuntimeError(f"{name} is not on the tensor cores: {c}")
    if len(sass) != 12:
        raise RuntimeError(f"the SASS holds {len(sass)} K2 instantiations, not 12: "
                           f"{sorted(sass)}")


def _band_flop(r: int, products: int = 3) -> float:
    """TF32 operations an output of one 3xTF32 pass needs: the function's
    2r + 1 taps in each product, three products for f32 input, two for
    uint8 (the kernels' band products do 8 S / (2r + 1) times as many, S =
    (2r + 15) // 8, ``csrc/fused_blur.cu``); a radius-0 axis is a copy."""
    return 2.0 * products * (2 * r + 1) if r else 0.0


def _crossover_sweep(frames) -> dict:
    """``blur_u8`` fused vs FFT_MXU and ``blur`` fused vs FFT_MXU (the
    fused engine as routed: K1 or K2, the two-pass split from the device's
    measured split radius), in turns (fused, fft, fft, fused) at each
    radius; uint8 on past r 598 (the split) until the fused engine has lost
    twice. Returns, per input type, the largest swept radius up to which the
    fused engine is at least as fast at every swept radius (600 for the
    float sweep where it wins to r 598)."""
    from blur_algorithms_tpu_torch import blur, blur_u8, make_plan

    x_u8 = torch.from_numpy(np.ascontiguousarray(np.moveaxis(frames, 1, -1))).cuda()
    x = torch.from_numpy(frames.astype(np.float32)).cuda()
    rows, best = [], {"u8": None, "f32": None}
    winning, losses = {"u8": True, "f32": True}, 0
    for sigma in (*SWEEP_SIGMAS, *SWEEP_SIGMAS_U8_WIDE):
        r = make_plan((H, W), sigma).row.support_radius
        line = {"r": r, "sigma": sigma}
        kinds = (("u8", blur_u8, x_u8), ("f32", blur, x))
        if sigma not in SWEEP_SIGMAS:
            if losses >= 2:
                break
            kinds = kinds[:1]
        for kind, fn, arg in kinds:
            t = {"fused": [], "fft_mxu": []}
            for engine in ("fused", "fft_mxu", "fft_mxu", "fused"):
                res = _time(fn, arg, sigma, engine, name=f"{kind} {engine} r={r}")
                t[engine].append(res.median_ms)
            fused, fft = (float(np.mean(t["fused"])), float(np.mean(t["fft_mxu"])))
            line[f"{kind}_fused_ms"], line[f"{kind}_fft_mxu_ms"] = fused, fft
            if fused <= fft and winning[kind]:
                best[kind] = r
            else:
                winning[kind] = False
            if kind == "u8" and fused > fft:
                losses += 1
        rows.append(line)
        print(f"phase 10 crossover r={r} (sigma {sigma}): " + "; ".join(
            f"{'uint8' if k == 'u8' else k} fused {line[f'{k}_fused_ms']:.4f} vs FFT_MXU "
            f"{line[f'{k}_fft_mxu_ms']:.4f} ms" for k in ("u8", "f32") if f"{k}_fused_ms" in line),
            flush=True)
    out = {"u8": best["u8"], "f32": 600 if winning["f32"] else best["f32"]}
    print(f"phase 10 crossover: fused at least as fast up to r={out} "
          f"(utils/hw.py auto_fused_max_radius_u8/_f32)", flush=True)
    return {"sweep": rows, "crossover": out}


def _slice3(frames) -> list[dict]:
    """Phases 8-10; returns the K3, K3f and K5 entries of the kernels line."""
    import torch.nn.functional as F

    from blur_algorithms_tpu_torch import blur, blur_u8, make_plan
    from blur_algorithms_tpu_torch.cuda_kernels import (
        fft4step,
        fused_blur,
        fused_dma,
        spectral_multiply,
    )
    from blur_algorithms_tpu_torch.ops import fft_conv
    from blur_algorithms_tpu_torch.ops.fft_mxu import transform_length
    from blur_algorithms_tpu_torch.ops.pad import reflect_101

    errs = _phase8(frames)
    counters = [fused_dma.blur_fused_u8_dma, fused_blur.blur_fused_f32,
                fft4step.fft_conv_rows, fft4step.fft_conv_rows_framed,
                spectral_multiply.spectral_multiply_2d]
    launched = _phase9(frames, counters)

    # ---- phase 10: times ----
    mp = BATCH * H * W / 1e6
    x = torch.from_numpy(frames.astype(np.float32)).cuda()
    plan = make_plan((H, W), SIGMA_U8_WIDE)
    rows = x.reshape(-1, W)
    cols = x.transpose(-1, -2).contiguous().reshape(-1, H)
    k3f_rows = _kernel_times(fft4step.fft_conv_rows_framed, rows,
                             transform_length(plan.row), plan.row, True,
                             f"K3f rows sigma={SIGMA_U8_WIDE}")
    k3f_cols = _kernel_times(fft4step.fft_conv_rows_framed, cols,
                             transform_length(plan.col), plan.col, True,
                             f"K3f cols sigma={SIGMA_U8_WIDE}")
    del cols
    plan = make_plan((H, W), SIGMA_F32_WIDE)
    k3_entries = []
    for axis_plan, t, label in ((plan.row, x, "rows"),
                                (plan.col, x.transpose(-1, -2), "cols")):
        r = axis_plan.support_radius
        length = axis_plan.dim + 4 * r
        n = max(256, 1 << (length - 1).bit_length())
        padded = F.pad(t.reshape(-1, axis_plan.dim), (2 * r, n - axis_plan.dim - 2 * r))
        k3_entries.append(_kernel_times(fft4step.fft_conv_rows, padded.contiguous(), n,
                                        axis_plan, False,
                                        f"K3 adjoint {label} sigma={SIGMA_F32_WIDE}"))
        del padded
    plan = make_plan((H, W), SIGMA)
    (bt, bb), (bl, br) = plan.col.border, plan.row.border
    spec = torch.fft.rfft2(reflect_101(x, [(bt, bb), (bl, br)])).contiguous()
    col = fft_conv._mirror_full(plan.col.spectrum, plan.fft_shape[0])
    fac = torch.from_numpy(col[:, None] * plan.row.spectrum[None, :]).cuda()
    t_k5 = _time(spectral_multiply.spectral_multiply_2d, spec, col, plan.row.spectrum,
                 name="K5 spectral_multiply")
    t_k5p = _time(spectral_multiply.spectral_multiply_2d_ref, spec, col,
                  plan.row.spectrum, name="K5 plain version")
    t_k5l = _time(torch.mul, spec, fac, name="K5 yardstick: torch.mul by the outer product")
    k5_bound, k5_by = _bound_ms(16 * spec.numel() + 4 * sum(fac.shape),
                                4 * spec.numel(), F32_FLOP_PER_S)
    print(f"phase 10 K5: spectrum {tuple(spec.shape)} complex64; bound "
          f"{k5_bound:.4f} ms ({k5_by})", flush=True)
    del spec, fac

    x_u8 = torch.from_numpy(np.ascontiguousarray(np.moveaxis(frames, 1, -1))).cuda()
    gt = torch.ones_like(x)

    def fwd_bwd(t):
        t = t.detach().requires_grad_()
        blur(t, SIGMA_F32_WIDE).backward(gt)
        return t.grad

    calls = [
        _time(blur_u8, x_u8, SIGMA_U8_WIDE, "fft_mxu",
              name=f"blur_u8 fft_mxu sigma={SIGMA_U8_WIDE}", mp=mp),
        _time(blur_u8, x_u8, SIGMA_U8_WIDE, name=f"blur_u8 AUTO sigma={SIGMA_U8_WIDE}", mp=mp),
        _time(blur, x, SIGMA_F32_WIDE, name=f"blur forward sigma={SIGMA_F32_WIDE}", mp=mp),
        _time(fwd_bwd, x, name=f"blur forward + backward sigma={SIGMA_F32_WIDE}", mp=mp),
    ]
    for res in (t_k5, t_k5p, t_k5l, *calls):
        print(f"phase 10 time: {res}", flush=True)
    del x, x_u8, gt
    torch.cuda.empty_cache()
    sweep = _crossover_sweep(frames)
    print("phase 10 sweep " + json.dumps(sweep), flush=True)

    k3f, k3 = _sum_axes(k3f_rows, k3f_cols), _sum_axes(*k3_entries)
    k5 = {"ms": t_k5.median_ms, "plain_ms": t_k5p.median_ms, "bound_ms": k5_bound,
          "bound_by": k5_by, "library_ms": t_k5l.median_ms}
    for label, d in ((f"K3 adjoint rows sigma={SIGMA_F32_WIDE}", k3_entries[0]),
                     (f"K3 adjoint cols sigma={SIGMA_F32_WIDE}", k3_entries[1]),
                     (f"K3 adjoint both axes sigma={SIGMA_F32_WIDE}", k3),
                     (f"K3f rows sigma={SIGMA_U8_WIDE}", k3f_rows),
                     (f"K3f cols sigma={SIGMA_U8_WIDE}", k3f_cols),
                     (f"K3f both axes sigma={SIGMA_U8_WIDE}", k3f),
                     ("K5 (library: torch.mul)", k5)):
        print(f"phase 10 {label}: kernel {d['ms']:.4f} ms, library {d['library_ms']:.4f} ms, "
              f"kernel / library {d['ms'] / d['library_ms']:.3f}, bound {d['bound_ms']:.4f} ms "
              f"({d['bound_by']}), share of bound {d['bound_ms'] / d['ms']:.1%}", flush=True)
    for name, line in _ptxas_lines(("fft_conv_rows_kernel", "spectral_multiply_kernel")):
        print(f"phase 10 ptxas {name}: {line}", flush=True)
    entry = lambda name, src, line, launches, d, err: {  # noqa: E731
        "name": name, "route": "cuda", "source": src,
        "replaces": line, "launches": launches, "max_abs_err": err,
        "ms": d["ms"], "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
        "bound_by": d["bound_by"], "library_ms": d["library_ms"],
    }
    src = "blur_algorithms_tpu_torch/csrc/fft4step.cu"
    return [
        entry("fft4step", src, "blur_algorithms_tpu/pallas_kernels/fft4step.py:138",
              launched["fft_conv_rows"], k3, max(errs["K3"], k3["err"])),
        entry("fft4step_framed", src, "blur_algorithms_tpu/pallas_kernels/fft4step.py:157",
              launched["fft_conv_rows_framed"], k3f, max(errs["K3f"], k3f["err"])),
        entry("spectral_multiply", "blur_algorithms_tpu_torch/csrc/spectral_multiply.cu",
              "blur_algorithms_tpu/pallas_kernels/spectral_multiply.py:30",
              launched["spectral_multiply_2d"], k5, errs["K5"]),
    ]


def _check(name: str, err: float, limit: float, line: str, phase: int = 11) -> float:
    print(f"phase {phase} {name} vs plain: {line} max_abs_err={err:.3e} limit={limit:.3e}",
          flush=True)
    if not err <= limit:
        raise RuntimeError(f"{name} disagrees with its plain version: {line}")
    return err


def _phase11() -> dict:
    """K4, the int8 split forms and K2's single-axis form against their
    plain versions; returns the worst error of each."""
    from blur_algorithms_tpu_torch import make_plan
    from blur_algorithms_tpu_torch.cuda_kernels import box_blur as k4
    from blur_algorithms_tpu_torch.cuda_kernels import fused_blur
    from blur_algorithms_tpu_torch.cuda_kernels import fused_split as fs

    errs = {"box_scan": 0.0, "rows": 0.0, "cols": 0.0, "axis": 0.0}
    u8, f32 = _case_frames(*HD, seed=300), _f32_planes(*HD, seed=301)
    f32_limit = 1e-3 * float(f32.abs().max()) / 255
    # K4: support (passes * r) 2, 8, 82, 330 and 1250 (clamped on the columns)
    for r, passes in BOX_CASES:
        for axis in (-1, -2):
            worst = {}
            for x, out_u8 in ((u8, False), (u8, True), (f32, False), (f32, True)):
                got = k4.box_blur_scan_axis(x, r, passes, axis, out_u8)
                want = k4.box_blur_scan_axis_ref(x, r, passes, axis, out_u8)
                torch.cuda.synchronize()
                err = float((got.double() - want.double()).abs().max())
                key = "uint8 out" if out_u8 else "f32 out"
                worst[key] = max(worst.get(key, 0.0), err)
                if not out_u8:
                    errs["box_scan"] = max(errs["box_scan"], err)
            _check("K4", worst["f32 out"], f32_limit,
                   f"{HD} r={r} passes={passes} axis={axis} (uint8 and f32 in, f32 out)")
            _check("K4", worst["uint8 out"], 1.0,
                   f"{HD} r={r} passes={passes} axis={axis} (uint8 and f32 in, uint8 out)")
    # the int8 split forms, bit-equal: row radius 2..1996
    for shape, sigma in SPLIT_CASES:
        plan = make_plan(shape, sigma)
        rows, cols = fused_blur._split_plans(plan)
        x = _case_frames(*shape, seed=302)
        e = fs.fused_split_rows_int8(x, rows, out_e32=True)
        y = fs.fused_split_rows_int8(x, rows, out_e32=False)
        got = fs.fused_split_cols_int8(e, cols, out_u8=True)
        got32 = fs.fused_split_cols_int8(e, cols, out_u8=False)
        checks = (
            ("fused_split_rows_int8 (int16 E)", e, fs.fused_split_rows_int8_ref(x, rows, True)),
            ("fused_split_rows_int8 (f32)", y, fs.fused_split_rows_int8_ref(x, rows, False)),
            ("fused_split_cols_int8 (uint8)", got, fs.fused_split_cols_int8_ref(e, cols, True)),
            ("fused_split_cols_int8 (f32)", got32, fs.fused_split_cols_int8_ref(e, cols, False)),
        )
        torch.cuda.synchronize()
        for name, a, b in checks:
            err = float((a.double() - b.double()).abs().max())
            errs["rows" if "rows" in name else "cols"] = max(
                errs["rows" if "rows" in name else "cols"], err)
            print(f"phase 11 {name} vs plain: {shape} sigma={sigma} "
                  f"r=({plan.col.support_radius}, {plan.row.support_radius}) "
                  f"equal={torch.equal(a, b)}", flush=True)
            if not torch.equal(a, b):
                raise RuntimeError(f"{name} is not bit-equal to its plain version")
    # K2's single-axis form: r up to 3994, both axes, f32 and uint8 in;
    # against the plain version in its float64 mode, whose f32 mode is
    # itself 1.01e-3 from the exact correlation on the (8400, 96) planes at
    # r 3994 (its 7989 roundings at 0..255 scale)
    for shape, sigma in AXIS_CASES:
        plan = make_plan(shape, sigma)
        for axis_plan in fused_blur._split_plans(plan):
            r = max(axis_plan.col.support_radius, axis_plan.row.support_radius)
            for x in (_f32_planes(*shape, seed=303), _case_frames(*shape, seed=304)):
                got = fused_blur.blur_fused_axis_f32(x, axis_plan)
                want = fused_blur.blur_fused_f32_ref(x.double(), axis_plan)
                plain32 = fused_blur.blur_fused_f32_ref(x, axis_plan)
                torch.cuda.synchronize()
                err = float((got.double() - want).abs().max())
                errs["axis"] = max(errs["axis"], err)
                _check("fused_blur_axis_f32", err, 1e-3 * float(x.float().abs().max()) / 255,
                       f"{shape} {'rows' if axis_plan.row.support_radius else 'cols'} "
                       f"r={r} {x.dtype} in (float64 mode; against the f32 mode "
                       f"{float((got - plain32).abs().max()):.3e}, the f32 mode against "
                       f"the float64 one {float((plain32.double() - want).abs().max()):.3e})")
                del plain32
    return errs


def _k1_bodies() -> dict:
    """K1's body and plain version for each rung it runs."""
    from blur_algorithms_tpu_torch.cuda_kernels import fused_dma

    return {"int8": (fused_dma.blur_fused_u8_dma, fused_dma.blur_fused_u8_dma_ref),
            "hybrid": (fused_dma.blur_fused_u8_hybrid, fused_dma.blur_fused_u8_hybrid_ref),
            "bf16": (fused_dma.blur_fused_u8_bf16, fused_dma.blur_fused_u8_bf16_ref)}


def _counters() -> list:
    from blur_algorithms_tpu_torch.cuda_kernels import (
        box_blur,
        fft4step,
        fused_blur,
        fused_dma,
        fused_split,
        spectral_multiply,
    )

    return [fused_dma.blur_fused_u8_dma, fused_blur.blur_fused_f32,
            fft4step.fft_conv_rows, fft4step.fft_conv_rows_framed,
            spectral_multiply.spectral_multiply_2d, box_blur.box_blur_scan_axis,
            fused_split.fused_split_rows_int8, fused_split.fused_split_cols_int8,
            fused_blur.blur_fused_axis_f32, fused_dma.blur_fused_u8_hybrid,
            fused_dma.blur_fused_u8_bf16, fused_split.fused_split_cols_hybrid]


def _pass2(plan, device) -> str:
    """The split's pass 2 wrapper that ``_blur_fused_split`` runs for this
    plan on this device: hybrid inside the certified region, else int8."""
    from blur_algorithms_tpu_torch.cuda_kernels import fused_blur

    ok = fused_blur._hybrid_cols_ok(plan, device)
    return "fused_split_cols_hybrid" if ok else "fused_split_cols_int8"


def _launched(counters, before: dict | None = None) -> dict:
    now = {c.__name__: c.launches for c in counters}
    return now if before is None else {k: now[k] - before[k] for k in now}


def _patch_check(out_hwc: torch.Tensor, img: np.ndarray, sigma: float, r: int,
                 c0: int, width: int) -> tuple[int, float]:
    """Columns [c0, c0 + width) of a full-height frame against the oracle on
    the crop [c0 - r, c0 + width + r) (the fused engines are local: the
    crop's own reflection does not reach the checked columns, except at the
    frame's edges, where it is the frame's)."""
    from blur_algorithms_tpu_torch import oracle

    lo, hi = max(0, c0 - r), min(img.shape[1], c0 + width + r)
    want = oracle.blur_u8(img[:, lo:hi], sigma)[:, c0 - lo : c0 - lo + width]
    got = out_hwc[:, c0 : c0 + width].cpu().numpy()
    d = np.abs(got.astype(int) - want.astype(int))
    return int(d.max()), float((d == 0).mean())


@functools.lru_cache(maxsize=1)
def _panorama() -> np.ndarray:
    """One (PANO_H, PANO_W, 3) uint8 frame from the benchmark's generator."""
    from blur_algorithms_tpu_torch.utils.frames import make_frames

    return np.ascontiguousarray(np.moveaxis(make_frames(1, PANO_H, PANO_W)[0], 0, -1))


def _phase12(frames, counters) -> dict:
    """The slice's paths at full width; returns the launches of each kernel
    on them."""
    from blur_algorithms_tpu_torch import (
        blur,
        blur_u8,
        box_blur,
        convolve_separable,
        make_plan,
        oracle,
    )
    from blur_algorithms_tpu_torch.api import Engine, _box_plan, _resolve_engine
    from blur_algorithms_tpu_torch.cuda_kernels import box_blur as k4
    from blur_algorithms_tpu_torch.ops.adjoint import blur_adjoint

    img = np.ascontiguousarray(np.moveaxis(frames, 1, -1))
    x_u8 = torch.from_numpy(img).cuda()
    x = torch.from_numpy(frames.astype(np.float32)).cuda()
    pano = _panorama()
    x_pano = torch.from_numpy(pano).cuda()
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    k1 = counters[0]

    radius = int(BOX_NSMOOTH * BOX_NSMOOTH)
    before = _launched(counters)
    out = box_blur(x_u8, BOX_NSMOOTH)
    torch.cuda.synchronize()
    ran = _launched(counters, before)
    d = np.abs(out[0].cpu().numpy().astype(int) - oracle.box_blur_u8(img[0], radius).astype(int))
    print(f"phase 12 main path: box_blur {tuple(x_u8.shape)} uint8 nsmooth={BOX_NSMOOTH} "
          f"(support {2 * radius}): launches {ran}; frame 0 vs float64 box oracle "
          f"max={int(d.max())} exact={float((d == 0).mean())}", flush=True)
    if ran["box_blur_scan_axis"] != 2 or ran[k1.__name__] or d.max() > 1:
        raise RuntimeError("box_blur on the uint8 batch did not run K4 twice within 1 count")
    del out

    out = box_blur(x, BOX_NSMOOTH)
    want = k4.box_blur_scan_axis_ref(k4.box_blur_scan_axis_ref(x, radius, 2, -1), radius, 2, -2)
    torch.cuda.synchronize()
    err = float((out - want).abs().max())
    limit = 1e-3 * float(x.abs().max()) / 255
    xg = x[0, :, :HD[0], :HD[1]].contiguous().requires_grad_()
    g = torch.from_numpy(np.random.default_rng(8).random(xg.shape, dtype=np.float32)).cuda()
    (box_blur(xg, BOX_NSMOOTH) * g).sum().backward()
    gwant = blur_adjoint(g, _box_plan(HD[0], HD[1], radius, 2, "auto"))
    torch.cuda.synchronize()
    gerr = float((xg.grad - gwant).abs().max())
    print(f"phase 12 main path: box_blur {tuple(x.shape)} f32 forward vs plain "
          f"max_abs_err={err:.3e} limit={limit:.3e}; backward at HD vs blur_adjoint(g) "
          f"max={gerr:.3e}", flush=True)
    if not err <= limit or not gerr <= 1e-6 * float(gwant.abs().max()):
        raise RuntimeError("box_blur on floats disagrees with its plain version or adjoint")
    del out, want, xg, g, gwant

    wide = make_plan((H, W), SIGMA_U8_WIDE)
    want_wide = oracle.blur_u8(img[0], SIGMA_U8_WIDE)
    # the split's pass 2 as routed; custom taps (no certified tap family)
    # keep the int8 pass 2
    calls = [("blur_u8 engine=fused", _pass2(wide, x_u8.device),
              lambda: blur_u8(x_u8, SIGMA_U8_WIDE, engine="fused"))]
    if calls[0][1] != "fused_split_cols_int8":
        calls.append(("convolve_separable engine=fused, the same taps",
                      "fused_split_cols_int8",
                      lambda: convolve_separable(x_u8, wide.row.taps, wide.col.taps,
                                                 engine="fused")))
    for label, pass2, call in calls:
        before = _launched(counters)
        out = call()
        torch.cuda.synchronize()
        ran = _launched(counters, before)
        d = np.abs(out[0].cpu().numpy().astype(int) - want_wide.astype(int))
        print(f"phase 12 main path: {label} {tuple(x_u8.shape)} sigma={SIGMA_U8_WIDE} "
              f"(r {wide.row.support_radius}): launches {ran}; frame 0 vs oracle "
              f"max={int(d.max())} exact={float((d == 0).mean())}", flush=True)
        if ran["fused_split_rows_int8"] != 1 or ran[pass2] != 1 or d.max() > 1:
            raise RuntimeError(f"{label} past r 600 did not run the int8 split's pass 1 "
                               f"and {pass2} within 1 count")
        del out

    plan = make_plan((PANO_H, PANO_W), SIGMA_U8_WIDE)
    eng = _resolve_engine("auto", plan, 1, x_pano.device, 3)
    before = _launched(counters)
    out = blur_u8(x_pano, SIGMA_U8_WIDE)
    torch.cuda.synchronize()
    ran = _launched(counters, before)
    r = plan.row.support_radius
    patches = [_patch_check(out, pano, SIGMA_U8_WIDE, r, c0, 512)
               for c0 in (0, PANO_W // 2 - 256, PANO_W - 512)]
    print(f"phase 12 main path: blur_u8 AUTO panorama {tuple(x_pano.shape)} "
          f"sigma={SIGMA_U8_WIDE} r={r} -> {eng.value}; launches {ran}; full-height "
          f"patches of 512 columns (left edge, middle, right edge) vs oracle "
          f"(max, exact) {patches}", flush=True)
    if (eng is not Engine.FUSED or ran["fused_split_rows_int8"] != 1
            or ran[_pass2(plan, x_pano.device)] != 1 or max(p[0] for p in patches) > 1):
        raise RuntimeError("the panorama did not run the int8 split within 1 count")
    del out, x_pano

    xg = x.clone().requires_grad_()
    g = torch.from_numpy(np.random.default_rng(9).random(x.shape, dtype=np.float32)).cuda()
    before = _launched(counters)
    y = blur(xg, SIGMA_F32_WIDE, engine="fused")
    torch.cuda.synchronize()
    ran = _launched(counters, before)
    (y * g).sum().backward()
    torch.cuda.synchronize()
    check = dict(_launched(counters))
    plan = make_plan((H, W), SIGMA_F32_WIDE)
    gwant = blur_adjoint(g, plan)
    ref0 = blur(x[0, :1], SIGMA_F32_WIDE, engine="fft_mxu")
    torch.cuda.synchronize()
    for c in counters:  # the checks' launches are not the path's
        c.launches = check[c.__name__]
    gerr = float((xg.grad - gwant).abs().max())
    d0 = float((y[0, 0].detach() - ref0[0]).abs().max())
    print(f"phase 12 main path: blur engine=fused {tuple(x.shape)} f32 "
          f"sigma={SIGMA_F32_WIDE} (r {plan.row.support_radius}) forward launches {ran}; plane 0 vs "
          f"FFT_MXU max={d0:.3e} limit={FFT_TOL}; x.grad vs blur_adjoint(g) "
          f"max={gerr:.3e}", flush=True)
    if ran["blur_fused_axis_f32"] != 2 or not d0 <= FFT_TOL:
        raise RuntimeError("blur fused past r 600 did not run the f32 split within 2e-2")
    if not gerr <= 1e-6 * float(gwant.abs().max()):
        raise RuntimeError(f"x.grad differs from blur_adjoint(g) by {gerr}")
    del xg, y, g, gwant

    before = _launched(counters)
    out = blur_u8(x_u8, SIGMA_CASCADE, engine="cascade")
    torch.cuda.synchronize()
    ran = _launched(counters, before)
    d = np.abs(out[0].cpu().numpy().astype(int)
               - oracle.blur_u8(img[0], SIGMA_CASCADE).astype(int))
    print(f"phase 12 main path: blur_u8 engine=cascade {tuple(x_u8.shape)} "
          f"sigma={SIGMA_CASCADE} (one step): launches {ran}; frame 0 vs "
          f"oracle max={int(d.max())} exact={float((d == 0).mean())}", flush=True)
    if ran["blur_fused_axis_f32"] != 2 or d.max() > 1:
        raise RuntimeError("the cascade did not run the f32 split within 1 count")
    launched = _launched(counters)
    print(f"phase 12 launches on the slice's paths: {launched}", flush=True)
    for name in ("box_blur_scan_axis", "fused_split_rows_int8", "fused_split_cols_int8",
                 "blur_fused_axis_f32"):
        if launched[name] < 1:
            raise RuntimeError(f"{name} was not launched on the main path")
    return launched


def _in_turns(label: str, fns: dict, *args) -> dict:
    """Each call timed in turns (a, b, ..., ..., b, a); the mean of the two
    medians of each."""
    t = {name: [] for name in fns}
    for name in (*fns, *reversed(fns)):
        t[name].append(_time(fns[name], *args, name=f"{label} {name}").median_ms)
    return {k: float(np.mean(v)) for k, v in t.items()}


def _sweeps(frames) -> dict:
    """Phase 13's two in-turn sweeps; returns the tables and the radii they
    set in ``utils/hw.py``."""
    from blur_algorithms_tpu_torch import blur, blur_u8, make_plan
    from blur_algorithms_tpu_torch.api import (
        Engine,
        _box_plan,
        _box_u8,
        _blur_planar,
        _u8_dma_precision,
    )
    from blur_algorithms_tpu_torch.cuda_kernels import fused_blur, fused_dma
    from blur_algorithms_tpu_torch.ops.layout import from_planar, to_planar
    from blur_algorithms_tpu_torch.utils.hw import device_spec

    x_u8 = torch.from_numpy(np.ascontiguousarray(np.moveaxis(frames, 1, -1))).cuda()
    x = torch.from_numpy(frames.astype(np.float32)).cuda()
    spec = device_spec(x.device)

    def k1(plan):  # K1 on the rung and in the form AUTO routes for the plan
        rung = _u8_dma_precision(plan, spec)
        return lambda t, p: fused_dma.blur_fused_u8_dma(t, p, precision=rung)

    box, fused_ok = [], {"u8": True, "f32": True}
    best = {"u8": None, "f32": None}
    for r in BOX_SWEEP_R:
        plan = _box_plan(H, W, r, 2, "auto")
        line = {"support": 2 * r}
        # the single fused kernels (K1, K2) against the box as routed to K4
        line.update({f"u8_{k}": v for k, v in _in_turns(
            f"box u8 support={2 * r}",
            {"fused": lambda t: from_planar(k1(plan)(to_planar(t, torch.uint8), plan)),
             "scan": lambda t: _box_u8(t, plan, Engine.BOX_SCAN)}, x_u8).items()})
        line.update({f"f32_{k}": v for k, v in _in_turns(
            f"box f32 support={2 * r}",
            {"fused": lambda t: fused_blur.blur_fused_f32(t, plan),
             "scan": lambda t: _blur_planar(t, plan, Engine.BOX_SCAN)}, x).items()})
        for kind in ("u8", "f32"):
            if line[f"{kind}_fused"] <= line[f"{kind}_scan"] and fused_ok[kind]:
                best[kind] = 2 * r
            else:
                fused_ok[kind] = False
        box.append(line)
        print(f"phase 13 box sweep support={2 * r}: uint8 K1 {line['u8_fused']:.4f} vs "
              f"K4 {line['u8_scan']:.4f} ms; f32 K2 {line['f32_fused']:.4f} vs K4 "
              f"{line['f32_scan']:.4f} ms", flush=True)
    box_cross = min((b or 0) for b in best.values())

    planar_u8 = x_u8.movedim(-1, -3).contiguous()
    # uint8 from r 1: K1 (AUTO's rung, the card's form) against the int8
    # split, gaussian and box taps; the uint8 split radius is where the split
    # wins from, at every larger swept radius, for both families
    split, u8_from = [], {}
    for family, plans in (("gaussian", [make_plan((H, W), s) for s in U8_SPLIT_SIGMAS]),
                          ("box", [_box_plan(H, W, r, 2, "auto") for r in U8_SPLIT_BOX_R])):
        wins = None
        for plan in plans:
            r = max(plan.row.support_radius, plan.col.support_radius)
            t = _in_turns(f"split u8 {family} r={r}", {
                "single": lambda t: k1(plan)(t, plan),
                "split": lambda t: fused_blur._blur_fused_split(t, plan, "int8", True)},
                planar_u8)
            wins = (wins or r) if t["split"] < t["single"] else None
            split.append({"taps": family, "r": r, **{f"u8_{k}": v for k, v in t.items()}})
            print(f"phase 13 uint8 split sweep {family} r={r}: K1 "
                  f"({_u8_dma_precision(plan, spec)}) {t['single']:.4f} vs int8 split "
                  f"{t['split']:.4f} ms", flush=True)
        u8_from[family] = wins
    # never winning under K1's domain: MAX_RADIUS + 1
    split_min_u8 = max(v or fused_blur.MAX_RADIUS + 1 for v in u8_from.values())
    wins_from = None
    for sigma in SPLIT_SWEEP_SIGMAS:
        plan = make_plan((H, W), sigma)
        r = plan.row.support_radius
        line = {"r": r}
        line.update({f"f32_{k}": v for k, v in _in_turns(
            f"split f32 r={r}",
            {"single": lambda t: fused_blur.blur_fused_f32(t, plan),
             "split": lambda t: fused_blur._blur_fused_split(t, plan, "bf16x3", False)},
            x).items()})
        wins_from = (wins_from or r) if line["f32_split"] < line["f32_single"] else None
        split.append(line)
        print(f"phase 13 split sweep r={r}: f32 K2 {line['f32_single']:.4f} vs "
              f"f32 split {line['f32_split']:.4f} ms", flush=True)
    split_min = wins_from
    for sigma in SPLIT_FFT_SIGMAS:
        r = make_plan((H, W), sigma).row.support_radius
        line = {"r": r}
        line.update({f"u8_{k}": v for k, v in _in_turns(
            f"split vs fft u8 r={r}",
            {"split": lambda t: blur_u8(t, sigma, "fused"),
             "fft_mxu": lambda t: blur_u8(t, sigma, "fft_mxu")}, x_u8).items()})
        line.update({f"f32_{k}": v for k, v in _in_turns(
            f"split vs fft f32 r={r}",
            {"split": lambda t: blur(t, sigma, "fused"),
             "fft_mxu": lambda t: blur(t, sigma, "fft_mxu")}, x).items()})
        split.append(line)
        print(f"phase 13 split vs FFT_MXU r={r}: uint8 split {line['u8_split']:.4f} vs "
              f"FFT_MXU {line['u8_fft_mxu']:.4f} ms; f32 split {line['f32_split']:.4f} vs "
              f"FFT_MXU {line['f32_fft_mxu']:.4f} ms", flush=True)
    out = {"box": box, "box_fused_best": best, "box_scan_crossover_radius": box_cross,
           "split": split, "fused_split_min_radius": split_min,
           "fused_split_min_radius_u8": split_min_u8}
    print(f"phase 13 sweeps set: box_scan_crossover_radius={box_cross} (largest "
          f"support at which the fused engine is at least as fast: {best}); "
          f"fused_split_min_radius={split_min} (the float sweep); "
          f"fused_split_min_radius_u8={split_min_u8} (the uint8 sweep from r 1, by taps: "
          f"{u8_from}) (utils/hw.py)", flush=True)
    return out


# The int8 cols pass and K4 before their redesigns (the cols pass on dp4a,
# K4's float64 block scan per 256 values and per-column walk), NVIDIA H100
# 80GB HBM3 at 700.00 W: not timed by this script, whose checkout holds
# only the current sources, but recorded in PERF.md (PR 10's table, column
# "earlier, in turns"), from probes/cols_int8_tc.py and probes/k4_variants.py
# timing the parent commit's sources in turns with these; printed as such,
# and kept out of the kernels line
EARLIER_COLS_MS = {
    "12x2160x3840 r 831": 15.3797, "3x1080x1920 r 831": 1.1010,
    "6x1080x3840 r 831 pre-padded": 4.0401,
    "12x2160x3840 r 49": 1.1780, "12x2160x3840 r 165": 3.4516,
}
EARLIER_K4_MS = {"rows u8->f32": 1.2348, "cols f32->u8": 1.4802, "rows f32": 1.2519,
                 "cols f32": 1.5363}
COLS_REPORT_SIGMAS = (15.0, 50.0, 250.0)  # r 49, 165, 831
SIGMA_INT8_PASS2 = (250.0, 0.9)  # column r 831, row r 2: under the hybrid floor


def _was(table: dict, key: str) -> str:
    was = table.get(key)
    if was is None:
        return "earlier kernel not measured"
    return f"earlier kernel {was:.4f} in turns, PERF.md's reading, not this run's"


def _cols_int8_report(planar: torch.Tensor, x_u8: torch.Tensor, counters) -> dict:
    """Phase 13: the int8 cols pass (uint8 out) on the batch at column r
    49, 165 and 831, at HD r 831 and on the pre-padded dp 2 x sp 2 shard at
    r 831: both stores held ``torch.equal`` to the plain version; time,
    earlier time (PERF.md's), bound and share; the split with the int8
    pass 2 against the hybrid pass 2 in turns at the same radii;
    ``blur_u8(engine="fused")`` at sigma (250, 0.9) (the int8 pass 2: row r
    2 under the hybrid floor) beside sigma 250 (the hybrid pass 2); ptxas.
    Returns the times by label."""
    from blur_algorithms_tpu_torch import blur_u8, make_plan
    from blur_algorithms_tpu_torch.cuda_kernels import fused_blur
    from blur_algorithms_tpu_torch.cuda_kernels import fused_split as fs
    from blur_algorithms_tpu_torch.ops.pad import reflect_101

    planes = planar.reshape(-1, H, W)
    hd = planes[:3, :HD[0], :HD[1]].contiguous()
    out = {}
    cases = [*((planes, s, False) for s in COLS_REPORT_SIGMAS), (hd, SIGMA_U8_WIDE, False),
             (planes[:6, :H // 2], SIGMA_U8_WIDE, True)]
    for x, sigma, pre in cases:
        n, h, w = x.shape
        plan = make_plan((h, w), sigma)
        rh = plan.col.support_radius
        _, cols = fused_blur._split_plans(plan)
        if pre:  # the top shard's rows with rh halo rows each side
            xp = reflect_101(planes[:6], [(rh, rh)], axes=[-2])[:, :h + 2 * rh].contiguous()
            rows = fused_blur._haloed_rows_plan(plan)
        else:
            xp, rows = x, fused_blur._split_plans(plan)[0]
        at = f"{n}x{h}x{w} r {rh}" + (" pre-padded" if pre else "")
        e = fs.fused_split_rows_int8(xp, rows)
        for out_u8 in (True, False):
            got = fs.fused_split_cols_int8(e, cols, out_u8, pre)
            equal = torch.equal(got, fs.fused_split_cols_int8_ref(e, cols, out_u8, pre))
            print(f"phase 13 int8 cols vs plain: {at} {'uint8' if out_u8 else 'f32'} out "
                  f"equal={equal}", flush=True)
            if not equal:
                raise RuntimeError(f"the int8 cols pass disagrees with its plain version at {at}")
            del got
        ms = _time(fs.fused_split_cols_int8, e, cols, True, pre, name=f"int8 cols {at}").median_ms
        outputs = n * h * w
        bound, by = _bound_ms(3 * outputs, 2 * outputs * 4 * (2 * rh + 1), INT8_OP_PER_S)
        print(f"phase 13 int8 cols {at}: {ms:.4f} ms ({_was(EARLIER_COLS_MS, at)}); "
              f"bound {bound:.4f} ms ({by}), share {bound / ms:.1%}; library: none", flush=True)
        out[at] = {"ms": ms, "bound": bound}
        del e, xp
    for sigma in COLS_REPORT_SIGMAS:
        plan = make_plan((H, W), sigma)
        rows, cols = fused_blur._split_plans(plan)
        r = plan.col.support_radius
        t = _in_turns(f"split r={r}", {
            "int8 pass 2": lambda u: fs.fused_split_cols_int8(fs.fused_split_rows_int8(u, rows),
                                                              cols),
            "hybrid pass 2": lambda u: fs.fused_split_cols_hybrid(
                fs.fused_split_rows_int8(u, rows), cols)}, planes)
        print(f"phase 13 split r={r} (both passes, uint8 out): int8 pass 2 "
              f"{t['int8 pass 2']:.4f} ms vs hybrid pass 2 {t['hybrid pass 2']:.4f} ms",
              flush=True)
        out[f"split r {r}"] = t
    plan = make_plan((H, W), SIGMA_INT8_PASS2)
    before = _launched(counters)
    blur_u8(x_u8, SIGMA_INT8_PASS2, engine="fused")
    torch.cuda.synchronize()
    ran = _launched(counters, before)
    if ran["fused_split_cols_int8"] != 1 or ran["fused_split_cols_hybrid"]:
        raise RuntimeError(f"blur_u8 fused at sigma {SIGMA_INT8_PASS2} did not run the int8 "
                           f"pass 2: {ran}")
    t = _in_turns("blur_u8 fused r 831", {
        "int8 pass 2": lambda u: blur_u8(u, SIGMA_INT8_PASS2, engine="fused"),
        "hybrid pass 2": lambda u: blur_u8(u, SIGMA_U8_WIDE, engine="fused")}, x_u8)
    print(f"phase 13 blur_u8 fused at column r {plan.col.support_radius}: sigma "
          f"{SIGMA_INT8_PASS2} (row r {plan.row.support_radius}, the int8 pass 2) "
          f"{t['int8 pass 2']:.4f} ms vs sigma {SIGMA_U8_WIDE} (the hybrid pass 2) "
          f"{t['hybrid pass 2']:.4f} ms", flush=True)
    out["blur_u8 fused r 831"] = t
    for name, line in _ptxas_lines(("split_cols_int8_kernel",)):
        print(f"phase 13 ptxas {name}: {line}", flush=True)
    for r in (49, 165, 831, 4096):
        print(f"phase 13 int8 cols dynamic shared memory at r {r}: "
              f"{fs.cols_smem_bytes(r)} bytes", flush=True)
    return out


def _slice4(frames) -> tuple[list[dict], dict]:
    """Phases 11-13; returns the entries of K4, the two int8 split forms and
    K2's single-axis form for the kernels line, and phase 12's launches."""
    import torch.nn.functional as F

    from blur_algorithms_tpu_torch import blur, blur_u8, box_blur, make_plan
    from blur_algorithms_tpu_torch.cuda_kernels import box_blur as k4
    from blur_algorithms_tpu_torch.cuda_kernels import fused_blur
    from blur_algorithms_tpu_torch.cuda_kernels import fused_split as fs

    errs = _phase11()
    counters = _counters()
    launched = _phase12(frames, counters)

    # ---- phase 13: times ----
    mp = BATCH * H * W / 1e6
    outputs = BATCH * 3 * H * W
    img = np.ascontiguousarray(np.moveaxis(frames, 1, -1))
    x_u8 = torch.from_numpy(img).cuda()
    planar_u8 = x_u8.movedim(-1, -3).contiguous()
    x = torch.from_numpy(frames.astype(np.float32)).cuda()
    hd_u8 = planar_u8[0, :, :HD[0], :HD[1]].contiguous()
    hd_f32 = x[0, :, :HD[0], :HD[1]].contiguous()
    radius = int(BOX_NSMOOTH * BOX_NSMOOTH)
    rows_f32 = k4.box_blur_scan_axis(planar_u8, radius, 2, -1)
    # K4 at the main path's shape against its plain version: rows uint8 ->
    # f32, columns f32 -> uint8 on the rows' output
    want = k4.box_blur_scan_axis_ref(planar_u8, radius, 2, -1)
    err = float((rows_f32.double() - want.double()).abs().max())
    errs["box_scan"] = max(errs["box_scan"], _check(
        "K4", err, 1e-3 * float(want.abs().max()) / 255,
        f"{tuple(planar_u8.shape)} r={radius} passes=2 axis=-1 (uint8 in, f32 out)", 13))
    got = k4.box_blur_scan_axis(rows_f32, radius, 2, -2, True)
    want = k4.box_blur_scan_axis_ref(rows_f32, radius, 2, -2, True)
    _check("K4", float((got.int() - want.int()).abs().max()), 1.0,
           f"{tuple(planar_u8.shape)} r={radius} passes=2 axis=-2 (f32 in, uint8 out)", 13)
    del got, want
    t_k4 = {
        "rows u8->f32": _time(k4.box_blur_scan_axis, planar_u8, radius, 2, -1,
                              name="K4 rows uint8 -> f32"),
        "cols f32->u8": _time(k4.box_blur_scan_axis, rows_f32, radius, 2, -2, True,
                              name="K4 cols f32 -> uint8"),
        "rows f32": _time(k4.box_blur_scan_axis, x, radius, 2, -1, name="K4 rows f32"),
        "cols f32": _time(k4.box_blur_scan_axis, x, radius, 2, -2, name="K4 cols f32"),
    }
    p_k4 = {
        "rows u8->f32": _time(k4.box_blur_scan_axis_ref, planar_u8, radius, 2, -1,
                              name="K4 plain rows uint8 -> f32"),
        "cols f32->u8": _time(k4.box_blur_scan_axis_ref, rows_f32, radius, 2, -2, True,
                              name="K4 plain cols f32 -> uint8"),
    }
    w = 2 * radius + 1

    def pool(t, axis):  # the yardstick: reflect pad + avg_pool2d, per pass
        for _ in range(2):
            if axis == -1:
                t = F.avg_pool2d(F.pad(t, (radius, radius, 0, 0), mode="reflect"), (1, w), 1)
            else:
                t = F.avg_pool2d(F.pad(t, (0, 0, radius, radius), mode="reflect"), (w, 1), 1)
        return t

    lib_k4 = {"rows": _time(pool, x, -1, name="K4 yardstick rows: reflect F.pad + avg_pool2d x2"),
              "cols": _time(pool, x, -2, name="K4 yardstick cols: reflect F.pad + avg_pool2d x2")}
    for res in (*t_k4.values(), *p_k4.values(), *lib_k4.values()):
        print(f"phase 13 time: {res}", flush=True)
    del rows_f32
    for key, res in t_k4.items():
        nbytes = {"rows u8->f32": 5, "cols f32->u8": 5}.get(key, 8) * outputs
        bound, by = _bound_ms(nbytes, 4 * outputs, F32_FLOP_PER_S)
        lib = lib_k4["rows" if key.startswith("rows") else "cols"].median_ms
        print(f"phase 13 K4 {key} (support {2 * radius}): {res.median_ms:.4f} ms "
              f"({_was(EARLIER_K4_MS, key)}); bound {bound:.4f} ms ({by}), share "
              f"{bound / res.median_ms:.1%}; yardstick (f32 reflect F.pad + avg_pool2d x2) "
              f"{lib:.4f} ms", flush=True)
    for name, line in _ptxas_lines(("box_rows_kernel", "box_lines_kernel")):
        print(f"phase 13 ptxas {name}: {line}", flush=True)
    print(f"phase 13 K4 dynamic shared memory at support {2 * radius}: rows kernel "
          f"{k4.smem_bytes(W, radius, 2, W)} bytes (span {W + 4 * radius}), lines kernel "
          f"{k4.smem_bytes(H, radius, 2, 0)} bytes (segments of "
          f"{k4._line_segment(H, radius, 2)})", flush=True)
    k4_ms = t_k4["rows u8->f32"].median_ms + t_k4["cols f32->u8"].median_ms
    k4_bound, k4_by = _bound_ms(10 * outputs, 8 * outputs, F32_FLOP_PER_S)
    print(f"phase 13 K4 uint8 box_blur (support {2 * radius}): {k4_ms:.4f} ms for both "
          f"axes; bound {k4_bound:.4f} ms ({k4_by}); f32 bound "
          f"{_bound_ms(16 * outputs, 8 * outputs, F32_FLOP_PER_S)[0]:.4f} ms", flush=True)

    plan = make_plan((H, W), SIGMA_U8_WIDE)
    rows, cols = fused_blur._split_plans(plan)
    e = fs.fused_split_rows_int8(planar_u8, rows)
    t_rows = _time(fs.fused_split_rows_int8, planar_u8, rows, name=f"int8 split rows (E out) r={plan.row.support_radius}")
    t_cols = _time(fs.fused_split_cols_int8, e, cols, name=f"int8 split cols (E in) r={plan.col.support_radius}")
    hd_plan = make_plan(HD, SIGMA_U8_WIDE)
    hd_rows, hd_cols = fused_blur._split_plans(hd_plan)
    hd_e = fs.fused_split_rows_int8(hd_u8, hd_rows)
    p_rows = _time(fs.fused_split_rows_int8_ref, hd_u8, hd_rows,
                   name=f"int8 split rows plain version at {HD}")
    p_cols = _time(fs.fused_split_cols_int8_ref, hd_e, hd_cols,
                   name=f"int8 split cols plain version at {HD}")
    k_rows_hd = _time(fs.fused_split_rows_int8, hd_u8, hd_rows, name=f"int8 split rows at {HD}")
    k_cols_hd = _time(fs.fused_split_cols_int8, hd_e, hd_cols, name=f"int8 split cols at {HD}")
    del e
    taps = 2 * plan.row.support_radius + 1
    b_rows = _bound_ms(3 * outputs, 2 * outputs * 2 * taps, INT8_OP_PER_S)
    b_cols = _bound_ms(3 * outputs, 2 * outputs * 4 * taps, INT8_OP_PER_S)
    cols_report = _cols_int8_report(planar_u8, x_u8, counters)

    plan = make_plan((H, W), SIGMA_F32_WIDE)
    rows4, cols4 = fused_blur._split_plans(plan)
    y = fused_blur.blur_fused_axis_f32(x, rows4)
    t_ax_rows = _time(fused_blur.blur_fused_axis_f32, x, rows4, name=f"f32 single-axis rows r={plan.row.support_radius}")
    t_ax_cols = _time(fused_blur.blur_fused_axis_f32, y, cols4, name=f"f32 single-axis cols r={plan.col.support_radius}")
    hd4 = make_plan(HD, SIGMA_F32_WIDE)
    hd_rows4, hd_cols4 = fused_blur._split_plans(hd4)
    p_ax = _time(lambda t: (fused_blur.blur_fused_f32_ref(t, hd_rows4),
                            fused_blur.blur_fused_f32_ref(t, hd_cols4)),
                 hd_f32, name=f"f32 single-axis plain version, both axes, at {HD}")
    k_ax_hd = _time(lambda t: (fused_blur.blur_fused_axis_f32(t, hd_rows4),
                               fused_blur.blur_fused_axis_f32(t, hd_cols4)),
                    hd_f32, name=f"f32 single-axis kernel, both axes, at {HD}")
    c = x.shape[1]
    wr = torch.from_numpy(plan.row.taps).cuda().view(1, 1, 1, -1).repeat(c, 1, 1, 1)
    wc = torch.from_numpy(plan.col.taps).cuda().view(1, 1, -1, 1).repeat(c, 1, 1, 1)
    rr = plan.row.support_radius
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        l_rows = _time(lambda t: F.conv2d(F.pad(t, (rr, rr, 0, 0), mode="reflect"), wr, groups=c),
                       x, name="f32 yardstick rows: reflect F.pad + depthwise conv2d (TF32 off)")
        l_cols = _time(lambda t: F.conv2d(F.pad(t, (0, 0, rr, rr), mode="reflect"), wc, groups=c),
                       y, name="f32 yardstick cols: reflect F.pad + depthwise conv2d (TF32 off)")
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    del y
    ax_bound = _bound_ms(2 * 8 * outputs, 2 * outputs * _band_flop(rr), TF32_FLOP_PER_S)
    for res in (t_rows, t_cols, k_rows_hd, k_cols_hd, p_rows, p_cols, t_ax_rows, t_ax_cols,
                k_ax_hd, p_ax, l_rows, l_cols):
        print(f"phase 13 time: {res}", flush=True)

    x_pano = torch.from_numpy(_panorama()).cuda()
    gt = torch.ones_like(x)

    def fwd_bwd(t):
        t = t.detach().requires_grad_()
        blur(t, SIGMA_F32_WIDE, "fused").backward(gt)
        return t.grad

    calls = [
        _time(box_blur, x_u8, BOX_NSMOOTH, name=f"box_blur uint8 nsmooth={BOX_NSMOOTH}", mp=mp),
        _time(box_blur, x, BOX_NSMOOTH, name=f"box_blur f32 nsmooth={BOX_NSMOOTH}", mp=mp),
        _time(blur_u8, x_u8, SIGMA_U8_WIDE, "fused",
              name=f"blur_u8 fused sigma={SIGMA_U8_WIDE}", mp=mp),
        _time(blur_u8, x_pano, SIGMA_U8_WIDE, name=f"blur_u8 AUTO panorama sigma={SIGMA_U8_WIDE}",
              mp=PANO_H * PANO_W / 1e6),
        _time(blur, x, SIGMA_F32_WIDE, "fused", name=f"blur fused forward sigma={SIGMA_F32_WIDE}",
              mp=mp),
        _time(fwd_bwd, x, name=f"blur fused forward + backward sigma={SIGMA_F32_WIDE}", mp=mp),
        _time(blur_u8, x_u8, SIGMA_CASCADE, "cascade",
              name=f"blur_u8 cascade sigma={SIGMA_CASCADE}", mp=mp),
    ]
    for res in calls:
        print(f"phase 13 time: {res}", flush=True)
    del x, x_u8, planar_u8, x_pano, gt
    torch.cuda.empty_cache()
    sweeps = _sweeps(frames)
    print("phase 13 sweep " + json.dumps(sweeps), flush=True)

    def entry(name, src, line, launches, ms, plain_ms, bound, err, library_ms, **extra):
        return {"name": name, "route": "cuda", "source": src, "replaces": line,
                "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms,
                **extra}

    hd = f"{HD[0]}x{HD[1]}x3"
    return [
        entry("box_scan", "blur_algorithms_tpu_torch/csrc/box_scan.cu",
              "blur_algorithms_tpu/pallas_kernels/box_blur_pallas.py:88",
              launched["box_blur_scan_axis"], k4_ms,
              p_k4["rows u8->f32"].median_ms + p_k4["cols f32->u8"].median_ms,
              (k4_bound, k4_by), errs["box_scan"],
              lib_k4["rows"].median_ms + lib_k4["cols"].median_ms,
              axes_ms={k: v.median_ms for k, v in t_k4.items()}),
        entry("fused_split_rows_int8", "blur_algorithms_tpu_torch/csrc/fused_split.cu",
              "blur_algorithms_tpu/pallas_kernels/fused_blur.py:218",
              launched["fused_split_rows_int8"], t_rows.median_ms, p_rows.median_ms,
              b_rows, errs["rows"], None, plain_at=hd, ms_at_plain_shape=k_rows_hd.median_ms),
        entry("fused_split_cols_int8", "blur_algorithms_tpu_torch/csrc/fused_split.cu",
              "blur_algorithms_tpu/pallas_kernels/fused_blur.py:218",
              launched["fused_split_cols_int8"], t_cols.median_ms, p_cols.median_ms,
              b_cols, errs["cols"], None, plain_at=hd, ms_at_plain_shape=k_cols_hd.median_ms,
              ms_by_shape={k: v["ms"] for k, v in cols_report.items() if "ms" in v}),
        entry("fused_blur_axis_f32", "blur_algorithms_tpu_torch/csrc/fused_blur.cu",
              "blur_algorithms_tpu/pallas_kernels/fused_blur.py:136",
              launched["blur_fused_axis_f32"], t_ax_rows.median_ms + t_ax_cols.median_ms,
              p_ax.median_ms, ax_bound, errs["axis"],
              l_rows.median_ms + l_cols.median_ms, plain_at=hd,
              ms_at_plain_shape=k_ax_hd.median_ms),
    ], launched


def _bound_mixed(nbytes: float, int8_ops: float, bf16_ops: float) -> tuple[float, str]:
    """Least time for work split between int8 and bf16 operations: bytes
    over the memory rate against the two operation times added."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = int8_ops / INT8_OP_PER_S + bf16_ops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _phase14_kernels(cases) -> dict:
    """K1's hybrid and bf16 bodies and the split's hybrid pass 2 against
    their plain versions, uint8 and f32 out; returns the worst errors."""
    from blur_algorithms_tpu_torch import make_plan
    from blur_algorithms_tpu_torch.cuda_kernels import fused_blur, fused_dma
    from blur_algorithms_tpu_torch.cuda_kernels import fused_split as fs

    errs = {"hybrid": 0.0, "bf16": 0.0, "split": 0.0}
    bodies = _k1_bodies()
    for k, ((h, w), sigma) in enumerate(cases):
        plan = make_plan((h, w), sigma)
        x = _case_frames(h, w, seed=400 + k)
        for rung in ("hybrid", "bf16"):
            body, ref_fn = bodies[rung]
            want = ref_fn(x, plan, out_u8=False)
            for out_u8 in (False, True):
                got = body(x, plan, out_u8)
                ref = fused_dma.store_u8_ref(want) if out_u8 else want
                label = (f"phase 14 K1 {rung} vs plain: {h}x{w} RGB sigma={sigma} "
                         f"r=({plan.col.support_radius}, {plan.row.support_radius})")
                if rung == "hybrid":  # tensor-core groups of 16 taps
                    errs[rung] = max(errs[rung], _check_hybrid(label, got, ref, out_u8))
                    continue
                torch.cuda.synchronize()
                err = float((got.double() - ref.double()).abs().max())
                errs[rung] = max(errs[rung], err)
                equal = torch.equal(got, ref)
                print(f"{label} {'uint8' if out_u8 else 'f32'} out equal={equal}", flush=True)
                if not equal:
                    raise RuntimeError(f"K1 {rung} disagrees with its plain version at "
                                       f"{(h, w, sigma)}")
    for shape, sigma in HYBRID_SPLIT_CASES:
        plan = make_plan(shape, sigma)
        rows, cols = fused_blur._split_plans(plan)
        e = fs.fused_split_rows_int8(_case_frames(*shape, seed=410), rows)
        want = fs.fused_split_cols_hybrid_ref(e, cols, out_u8=False)
        for out_u8 in (False, True):
            got = fs.fused_split_cols_hybrid(e, cols, out_u8)
            ref = fused_dma.store_u8_ref(want) if out_u8 else want
            errs["split"] = max(errs["split"], _check_hybrid(
                f"phase 14 fused_split_cols_hybrid vs plain: {shape} sigma={sigma} column "
                f"r={plan.col.support_radius}", got, ref, out_u8))
    return errs


def _check_hybrid(label: str, got: torch.Tensor, ref: torch.Tensor, out_u8: bool) -> float:
    """A hybrid body on the tensor cores (K1's, or the split's pass 2)
    against its plain version: the tensor cores add each output's taps in
    groups of 16, the plain version one by one, so within HYBRID_TOL at
    0..255 scale on the f32 store and 1 count on the uint8 store; prints the
    worst difference and the share of outputs that differ; returns the
    worst difference."""
    torch.cuda.synchronize()
    d = (got.double() - ref.double()).abs()
    err, share = float(d.max()), float((d > 0).double().mean())
    limit = 1.0 if out_u8 else HYBRID_TOL
    print(f"{label} {'uint8' if out_u8 else 'f32'} out max_abs_err={err:.3e} "
          f"(limit {limit:.0e}), share differing={share:.3e}", flush=True)
    if got.shape != ref.shape or got.dtype != ref.dtype or not err <= limit:
        raise RuntimeError(f"a hybrid body disagrees with its plain version: {label}")
    return err


# The split's passes on the CUDA cores (dp4a rows, f32 FMA pass 2), before
# their tensor-core kernels, NVIDIA H100 80GB HBM3 at 700 W: PERF.md's kernel
# table and, for the whole split at r 49 and 165, its routing sweeps (both
# from this script)
EARLIER_SPLIT_MS = {
    "rows 12x2160x3840 r 831": 6.0960, "rows 3x1080x1920 r 831": 0.4196,
    "hybrid 12x2160x3840 r 831": 11.5239, "hybrid 3x1080x1920 r 831": 0.8297,
    "split 12x2160x3840 r 49": 1.4126, "split 12x2160x3840 r 165": 3.9316,
    "hybrid pre-padded shard r 831": 2.9214,
}
SPLIT_REPORT_SIGMAS = (15.0, 50.0, 250.0)  # r 49, 165, 831


def _split_report(planar: torch.Tensor) -> dict:
    """Phase 14: the split's rows pass (int16 E out) and hybrid pass 2
    (uint8 out) on the batch at r 49, 165 and 831 and at HD r 831: each
    pass's time, the earlier time, its bound and share, the whole split and
    (pass 2) the bf16 depthwise ``conv2d`` yardstick; the registers, shared
    memory and spills of both kernels. Returns the times by label."""
    import torch.nn.functional as F

    from blur_algorithms_tpu_torch import make_plan
    from blur_algorithms_tpu_torch.cuda_kernels import fused_blur
    from blur_algorithms_tpu_torch.cuda_kernels import fused_split as fs

    hd = planar[0, :, :HD[0], :HD[1]].contiguous()
    out = {}
    for x, sigma in (*((planar, s) for s in SPLIT_REPORT_SIGMAS), (hd, SIGMA_U8_WIDE)):
        h, w = x.shape[-2:]
        n = x.numel() // (h * w)
        plan = make_plan((h, w), sigma)
        rows, cols = fused_blur._split_plans(plan)
        r = plan.row.support_radius
        at = f"{n}x{h}x{w} r {r}"
        xs = x.reshape(n, h, w)
        e = fs.fused_split_rows_int8(xs, rows)
        t_rows = _time(fs.fused_split_rows_int8, xs, rows, name=f"split rows {at}").median_ms
        t_hyb = _time(fs.fused_split_cols_hybrid, e, cols, name=f"split hybrid {at}").median_ms
        t_all = _time(fused_blur._blur_fused_split, xs, plan, "int8", True,
                      name=f"split {at}").median_ms
        wc = torch.from_numpy(cols.col.taps).cuda().to(torch.bfloat16).view(1, 1, -1, 1)
        wc = wc.repeat(3, 1, 1, 1)
        eb = e.reshape(-1, 3, h, w).to(torch.bfloat16)
        t_lib = _time(lambda u: F.conv2d(F.pad(u, (0, 0, r, r), mode="reflect"), wc, groups=3),
                      eb, name=f"pass 2 yardstick {at}: reflect F.pad + depthwise conv2d "
                      "in bf16").median_ms
        del e, eb
        outputs = n * h * w
        b_rows = _bound_ms(3 * outputs, 2 * outputs * 2 * (2 * r + 1), INT8_OP_PER_S)
        b_hyb = _bound_ms(3 * outputs, 2 * outputs * (2 * r + 1), BF16_FLOP_PER_S)
        for name, ms, (bound, by) in (("rows", t_rows, b_rows), ("hybrid", t_hyb, b_hyb)):
            was = EARLIER_SPLIT_MS.get(f"{name} {at}")
            print(f"phase 14 split {name} {at}: {ms:.4f} ms (earlier "
                  f"{'not measured' if was is None else f'{was:.4f}'}); bound {bound:.4f} ms "
                  f"({by}), share {bound / ms:.1%}"
                  + (f"; yardstick {t_lib:.4f} ms" if name == "hybrid" else ""), flush=True)
        was = EARLIER_SPLIT_MS.get(f"split {at}")
        print(f"phase 14 split (both passes, uint8 out) {at}: {t_all:.4f} ms (earlier "
              f"{'not measured' if was is None else f'{was:.4f}'})", flush=True)
        out[at] = {"rows": t_rows, "hybrid": t_hyb, "split": t_all, "yardstick": t_lib,
                   "rows_bound": b_rows[0], "hybrid_bound": b_hyb[0]}
    for name, line in _ptxas_lines(("split_rows_int8_kernel", "split_cols_hybrid_kernel")):
        print(f"phase 14 ptxas {name}: {line}", flush=True)
    for r in (49, 165, 831, 4096):
        print(f"phase 14 dynamic shared memory at r {r}: rows pass {fs.rows_smem_bytes(r)} "
              f"bytes, hybrid pass 2 {fs.hybrid_smem_bytes(r)} bytes", flush=True)
    return out


def _gate_points(spec) -> list[tuple[str, str, list]]:
    """(rung, tap family, grid) of the trimmed certification gate: the
    headline (sigma 10; box radius 16, support 32) and each routed floor,
    for every rung the device routes (the hybrid pin at the headline where
    none is routed)."""
    from blur_algorithms_tpu_torch import certify

    points = []
    for rung in ("hybrid", "bf16"):
        for kernel in ("gaussian", "box_fast"):
            floor = (spec.hybrid_min_radius_for(kernel) if rung == "hybrid"
                     else spec.bf16_min_radius)
            if floor is None:
                continue
            if kernel == "box_fast":
                grid = sorted({16, max(1, -(-floor // 2))})
            else:
                at = [s for s in certify.SIGMAS
                      if certify._plan(certify.DMA_HW, kernel, s).row.support_radius >= floor]
                grid = sorted({SIGMA, *at[:1]})
            points.append((rung, kernel, grid))
    return points or [("hybrid", "gaussian", [SIGMA])]


def _slice5(frames, k1_int8_ms: float, earlier: dict) -> list[dict]:
    """Phase 14; returns the entries of K1's hybrid and bf16 bodies and the
    split's hybrid pass 2 for the kernels line. ``earlier`` holds their
    launches on the earlier slices' paths (phase 3's AUTO, phase 12's
    split), added to those of their own paths."""
    import torch.nn.functional as F

    from blur_algorithms_tpu_torch import blur_u8, certify, make_plan, oracle
    from blur_algorithms_tpu_torch.api import _u8_dma_precision
    from blur_algorithms_tpu_torch.cuda_kernels import fused_blur, fused_dma
    from blur_algorithms_tpu_torch.cuda_kernels import fused_split as fs
    from blur_algorithms_tpu_torch.utils.hw import device_spec

    cases = [((1080, 1920), s) for s in (1.0, 3.0, 10.0, 50.0, 150.0, 180.0)]
    cases += [((1080, 1920), (5.0, 11.0)), (RAGGED, SIGMA)]
    errs = _phase14_kernels(cases)

    # ---- the slice's paths at full width, counts set to 0 first ----
    img = np.ascontiguousarray(np.moveaxis(frames, 1, -1))
    x = torch.from_numpy(img).cuda()
    planar = x.movedim(-1, -3).contiguous()
    plan = make_plan((H, W), SIGMA)
    spec = device_spec(x.device)
    want0 = oracle.blur_u8(img[0], SIGMA)
    counters = _counters()
    launched = {}
    # the hybrid pin; then AUTO on the card's spec with its hybrid floor
    # withdrawn and bf16 routed from its certified floor, as on a device
    # whose AUTO takes the bf16 rung (the card routes hybrid, and bf16 has
    # no route floor on it: it never wins on time)
    bf16_fields = {"hybrid_cert_min_radius": None, "bf16_route_min_radius": 0,
                   "fused_split_min_radius": None}  # K1 at sigma 10, not the split
    bf16_spec = dataclasses.replace(spec, **bf16_fields)
    for rung in ("hybrid", "bf16"):
        body, ref_fn = _k1_bodies()[rung]
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        if rung == "hybrid":
            what = "blur_u8(precision='hybrid')"
            out = blur_u8(x, SIGMA, precision="hybrid")
        else:
            what = (f"blur_u8 AUTO (bf16 routed from r {bf16_spec.bf16_min_radius}, no split "
                    "radius)")
            with _route_spec_as(x.device, **bf16_fields):
                out = blur_u8(x, SIGMA)
        torch.cuda.synchronize()
        ran = _launched(counters)
        launched[rung] = ran[body.__name__]
        ref = ref_fn(planar, plan).movedim(-3, -1)
        torch.cuda.synchronize()
        err = int((out.int() - ref.int()).abs().max())
        # hybrid: tensor-core groups of 16 taps, within 1 count of the plain
        # version's tap-by-tap sums; bf16: bit-equal
        held = err <= 1 if rung == "hybrid" else torch.equal(out, ref)
        d = np.abs(out[0].cpu().numpy().astype(int) - want0.astype(int))
        print(f"phase 14 main path: {what} {tuple(x.shape)} "
              f"sigma={SIGMA}: launches {ran}; vs plain version max_abs_err={err} "
              f"({'limit 1' if rung == 'hybrid' else 'equal'}: {held}); frame 0 vs oracle "
              f"max={int(d.max())} exact={float((d == 0).mean())}", flush=True)
        if launched[rung] != 1 or sum(ran.values()) != 1 or not held:
            raise RuntimeError(f"{what} did not run {body.__name__} alone, held to its "
                               "plain version")
        if d.max() > 1:
            raise RuntimeError(f"{what}: frame 0 is {int(d.max())} counts from the oracle")
        del out, ref
    # the split through AUTO where it runs under the fused/FFT crossover
    # (from fused_split_min_radius), and pinned "fused" past r 600: its
    # pass 2 is the hybrid one inside the certified region, else int8
    launched["split"] = 0
    for sigma, pin in (*((s, None) for s in AUTO_SPLIT_SIGMAS), (SIGMA_U8_WIDE, "fused")):
        p = make_plan((H, W), sigma)
        if not fused_blur._split_wins(p, 1, "int8", x.device):
            print(f"phase 14: the split does not run at sigma {sigma} on this device",
                  flush=True)
            continue
        pass2 = _pass2(p, x.device)
        for c in counters:
            c.launches = 0
        out = blur_u8(x, sigma) if pin is None else blur_u8(x, sigma, engine=pin)
        torch.cuda.synchronize()
        ran = _launched(counters)
        launched["split"] += ran["fused_split_cols_hybrid"]
        d = np.abs(out[0].cpu().numpy().astype(int) - oracle.blur_u8(img[0], sigma).astype(int))
        what = "AUTO" if pin is None else f"engine={pin}"
        print(f"phase 14 main path: blur_u8 {what} sigma={sigma} (r {p.row.support_radius}): "
              f"pass 2 {pass2}; launches {ran}; frame 0 vs oracle max={int(d.max())} "
              f"exact={float((d == 0).mean())}", flush=True)
        if (ran["fused_split_rows_int8"] != 1 or ran[pass2] != 1 or sum(ran.values()) != 2
                or d.max() > 1):
            raise RuntimeError(f"blur_u8 {what} sigma={sigma} did not run the split with "
                               f"{pass2} within 1 count")
        del out
    print(f"phase 14 AUTO rung at sigma {SIGMA}: {_u8_dma_precision(plan, spec)}; "
          f"floors: hybrid gaussian {spec.hybrid_min_radius_for('gaussian')}, box "
          f"{spec.hybrid_min_radius_for('box_fast')}; bf16 {spec.bf16_min_radius}; "
          f"split from r {spec.fused_split_min_radius}, its hybrid pass 2 ceilings "
          f"{spec.hybrid_split_cert_max_radius}, {spec.hybrid_split_cert_max_radius_box}",
          flush=True)

    # ---- the trimmed certification gate ----
    for rung, kernel, grid in _gate_points(spec):
        rows = certify.dma_sweep([rung], kernel, grid=grid, log=lambda line: None)[rung]
        for row in rows:
            print(f"phase 14 gate {rung} {kernel} x={row['x']} r={row['radius']}: max "
                  f"{row['max']} per pattern {row['per_pattern']}", flush=True)
            if row["max"] > 1:
                raise RuntimeError(f"the {rung} rung breaks the 1-count gate at {row}")
    # the split's pass 2 where AUTO runs it: the routed pass 2 of each
    grid = [s * certify.R_PER_SIGMA for s in AUTO_SPLIT_SIGMAS]
    for row in certify.split_sweep("gaussian", grid=grid, hw=certify.DMA_HW,
                                   log=lambda line: None):
        form = "hybrid" if spec.hybrid_split_cert_max_radius is not None else "int8"
        print(f"phase 14 gate split pass 2 gaussian x={row['x']} column r={row['radius']}: "
              f"max {row['max']} per pattern {row['per_pattern']}", flush=True)
        if row["max"][form] > 1:
            raise RuntimeError(f"the split's {form} pass 2 breaks the 1-count gate at {row}")

    # ---- times, in turns ----
    mp = BATCH * H * W / 1e6
    fns = {p: (lambda t, f=b: f(t, plan)) for p, (b, _) in _k1_bodies().items()}
    t = {p: [] for p in fns}
    for p in (*fns, *reversed(fns)):
        t[p].append(_time(fns[p], planar, name=f"K1 {p} sigma={SIGMA}", mp=mp).median_ms)
    t = {p: float(np.mean(v)) for p, v in t.items()}
    plain = {p: _time(_k1_bodies()[p][1], planar, plan, name=f"K1 {p} plain version").median_ms
             for p in ("hybrid", "bf16")}
    wide = make_plan((H, W), SIGMA_U8_WIDE)
    rows, cols = fused_blur._split_plans(wide)
    e = fs.fused_split_rows_int8(planar, rows)
    ts = _in_turns(f"split pass 2 r={wide.col.support_radius}",
                   {"int8": lambda u: fs.fused_split_cols_int8(u, cols),
                    "hybrid": lambda u: fs.fused_split_cols_hybrid(u, cols)}, e)
    hd_plan = make_plan(HD, SIGMA_U8_WIDE)
    hd_rows, hd_cols = fused_blur._split_plans(hd_plan)
    hd_e = fs.fused_split_rows_int8(planar[0, :, :HD[0], :HD[1]].contiguous(), hd_rows)
    split_plain = _time(fs.fused_split_cols_hybrid_ref, hd_e, hd_cols,
                        name=f"split hybrid pass 2 plain version at {HD}").median_ms
    split_hd = _time(fs.fused_split_cols_hybrid, hd_e, hd_cols,
                     name=f"split hybrid pass 2 at {HD}").median_ms
    # yardsticks the port never calls: depthwise conv2d in bf16
    c = 3
    xb = planar.reshape(-1, c, H, W).to(torch.bfloat16)
    rh, rw = plan.col.support_radius, plan.row.support_radius
    w_row = torch.from_numpy(plan.row.taps).cuda().to(torch.bfloat16).view(1, 1, 1, -1).repeat(c, 1, 1, 1)
    w_col = torch.from_numpy(plan.col.taps).cuda().to(torch.bfloat16).view(1, 1, -1, 1).repeat(c, 1, 1, 1)

    def lib_bf16(u):
        u = F.conv2d(F.pad(u, (rw, rw, rh, rh), mode="reflect"), w_row, groups=c)
        return F.conv2d(u, w_col, groups=c)

    lib_k1 = _time(lib_bf16, xb, name="K1 bf16 yardstick: reflect F.pad + 2 depthwise "
                   "conv2d in bf16").median_ms
    eb = e.reshape(-1, c, H, W).to(torch.bfloat16)
    rc = wide.col.support_radius
    wc = torch.from_numpy(wide.col.taps).cuda().to(torch.bfloat16).view(1, 1, -1, 1).repeat(c, 1, 1, 1)
    lib_split = _time(lambda u: F.conv2d(F.pad(u, (0, 0, rc, rc), mode="reflect"), wc, groups=c),
                      eb, name="split pass 2 yardstick: reflect F.pad + depthwise conv2d "
                      "along columns in bf16").median_ms
    del xb, eb, e, hd_e
    print(f"phase 14 times in turns at sigma {SIGMA} (ms): K1 {t}; plain {plain}; split "
          f"pass 2 at r {rc}: {ts}; hybrid pass 2 at {HD} {split_hd:.4f}, its plain "
          f"version {split_plain:.4f}; yardsticks K1 bf16 {lib_k1:.4f}, split pass 2 "
          f"{lib_split:.4f}; K1 int8 in phase 4 {k1_int8_ms:.4f}", flush=True)
    report = _split_report(planar)

    outputs = BATCH * 3 * H * W
    tr, tc = 2 * rw + 1, 2 * rh + 1
    # 1 byte in, 1 out; hybrid: two int8 digit products per rows tap, one
    # bf16 product per cols tap; bf16: one per tap on each axis (2 ops each)
    b_hybrid = _bound_mixed(2 * outputs, 2 * outputs * 2 * tr, 2 * outputs * tc)
    b_bf16 = _bound_mixed(2 * outputs, 0, 2 * outputs * (tr + tc))
    # int16 E in, 1 byte out; one bf16 product per cols tap
    b_split = _bound_mixed(3 * outputs, 0, 2 * outputs * (2 * rc + 1))
    print(f"phase 14 bounds (ms): K1 hybrid {b_hybrid}, K1 bf16 {b_bf16}, split hybrid "
          f"pass 2 at r {rc} {b_split}", flush=True)

    def entry(name, src, line, launches, ms, plain_ms, bound, err, library_ms, **extra):
        return {"name": name, "route": "cuda", "source": src, "replaces": line,
                "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms,
                **extra}

    src = "blur_algorithms_tpu_torch/csrc/fused_dma.cu"
    return [
        entry("fused_dma_hybrid", src, "blur_algorithms_tpu/pallas_kernels/fused_dma.py:1306",
              launched["hybrid"] + earlier.get("blur_fused_u8_hybrid", 0), t["hybrid"],
              plain["hybrid"], b_hybrid, errs["hybrid"], None, int8_ms_in_turns=t["int8"]),
        entry("fused_dma_bf16", src, "blur_algorithms_tpu/pallas_kernels/fused_dma.py:1415",
              launched["bf16"] + earlier.get("blur_fused_u8_bf16", 0), t["bf16"], plain["bf16"],
              b_bf16, errs["bf16"], lib_k1, int8_ms_in_turns=t["int8"]),
        entry("fused_split_cols_hybrid", "blur_algorithms_tpu_torch/csrc/fused_split.cu",
              "blur_algorithms_tpu/pallas_kernels/fused_blur.py:282",
              launched["split"] + earlier.get("fused_split_cols_hybrid", 0),
              ts["hybrid"], split_plain, b_split, errs["split"], lib_split,
              plain_at=f"{HD[0]}x{HD[1]}x3", ms_at_plain_shape=split_hd,
              int8_pass2_ms_in_turns=ts["int8"], split_report=report),
    ]



# phase 15: K1's staging forms against K1 direct, in turns, at support
# radius 6, 16, 32, 65, 99, 165, 248, 332, 448 and 598 on 3, 6 and 12
# planes of the 4K batch; the strip form, which no rule routes, on 12
# planes to r 99
FORM_SWEEP_SIGMAS = (2.1, 5.1, 10.0, 20.0, 30.0, 50.0, 75.0, 100.0, 135.0, 180.0)
FORM_SWEEP_PLANES = (3, 6, 12)
STRIP_SWEEP = (12, 99)  # planes, largest support radius
PIN_SIGMAS = (15.0, 100.0)  # phase 15: the int8 pin at r 49 and 332
_FORM_KW = {"strip": {"strip": True}, "assembled": {"direct": False},
            "pipelined": {"pipelined": True}, "resident": {"resident": True}}


def _routed(form: str, rung: str) -> list[str]:
    """The wrappers whose counts show that ``form`` ran on ``rung``."""
    if form == "direct":
        return [{"int8": "blur_fused_u8_dma", "hybrid": "blur_fused_u8_hybrid",
                 "bf16": "blur_fused_u8_bf16"}[rung]]
    return [f"blur_fused_u8_{form}",
            *(["assemble_padded"] if form in ("assembled", "pipelined") else [])]

# the JAX _align_geometry frames of test_band_fused.py's A5 cases:
# (h, w, rh, rw, orh, orw, hp, wp)
A5_JAX_CASES = ((96, 256, 4, 4, 8, 128, 112, 512), (100, 200, 7, 3, 8, 128, 160, 512),
                (9, 129, 8, 128, 8, 128, 32, 512), (70, 250, 1, 140, 8, 256, 88, 768),
                (256, 384, 130, 5, 136, 128, 528, 768))


def _form_wrappers() -> dict:
    """Each form's wrapper (its launch count), and A5's."""
    from blur_algorithms_tpu_torch.cuda_kernels import assemble, fused_dma

    return {"strip": fused_dma.blur_fused_u8_strip,
            "assembled": fused_dma.blur_fused_u8_assembled,
            "pipelined": fused_dma.blur_fused_u8_pipelined,
            "resident": fused_dma.blur_fused_u8_resident,
            "a5": assemble.assemble_padded}


def _phase15_equal(cases) -> dict:
    """Each form against K1 direct and the body's plain version, for every
    rung it serves where its block fits, uint8 and f32 out (int8's f32 store
    too); A5 against its
    plain version at the JAX geometries and the port's; returns the worst
    differences per form."""
    from blur_algorithms_tpu_torch import make_plan
    from blur_algorithms_tpu_torch.cuda_kernels import assemble, fused_dma

    errs = {f: 0.0 for f in (*_FORM_KW, "a5")}
    refs = {"int8": fused_dma.blur_fused_u8_dma_ref,
            "hybrid": fused_dma.blur_fused_u8_hybrid_ref,
            "bf16": fused_dma.blur_fused_u8_bf16_ref}
    for k, ((h, w), sigma) in enumerate(cases):
        plan = make_plan((h, w), sigma)
        x = _case_frames(h, w, seed=500 + k)
        for rung in fused_dma.RUNGS:
            for out_u8 in (True, False):
                want = refs[rung](x, plan, out_u8)
                direct = fused_dma.blur_fused_u8_dma(x, plan, precision=rung, out_u8=out_u8,
                                                     direct=True)
                served = []
                for form, kw in _FORM_KW.items():
                    if fused_dma.k1_geometry(form, rung, plan, 3, device=x.device) is None:
                        continue
                    got = fused_dma.blur_fused_u8_dma(x, plan, precision=rung, out_u8=out_u8,
                                                      **kw)
                    torch.cuda.synchronize()
                    err = float((got.double() - want.double()).abs().max())
                    errs[form] = max(errs[form], err)
                    # every form bit-equal to K1 direct; int8 and bf16 to the
                    # plain version too, hybrid (tensor-core groups of 16
                    # taps) within HYBRID_TOL / 1 count of it
                    near = (err <= (1 if out_u8 else HYBRID_TOL) if rung == "hybrid"
                            else torch.equal(got, want))
                    if not (near and torch.equal(got, direct)):
                        raise RuntimeError(f"K1 {form} {rung} differs from K1 direct or its "
                                           f"plain version at {(h, w, sigma)} by {err}")
                    served.append(form)
                print(f"phase 15 forms vs K1 direct (equal) and plain "
                      f"({'within tolerance' if rung == 'hybrid' else 'equal'}): {h}x{w} RGB "
                      f"sigma={sigma} r=({plan.col.support_radius}, {plan.row.support_radius}) "
                      f"{rung} {'uint8' if out_u8 else 'f32'} out: held for {served}",
                      flush=True)
    port_case = (*RAGGED, 33, 33, 33, 33, 1104, 1856)  # the plane at (rh, rw)
    for h, w, rh, rw, orh, orw, hp, wp in (*A5_JAX_CASES, port_case):
        x = _case_frames(h, w, seed=510)
        got = assemble.assemble_padded(x, rh, rw, orh, orw, hp, wp)
        want = assemble.assemble_padded_ref(x, rh, rw, orh, orw, hp, wp)
        torch.cuda.synchronize()
        errs["a5"] = max(errs["a5"], float((got.int() - want.int()).abs().max()))
        print(f"phase 15 A5 vs plain: {h}x{w} borders {(rh, rw)} at {(orh, orw)} in "
              f"{(hp, wp)}: equal={torch.equal(got, want)}", flush=True)
        if not torch.equal(got, want):
            raise RuntimeError(f"A5 differs from its plain version at {(h, w, rh, rw)}")
    return errs


@contextlib.contextmanager
def _k1_rule_as(device, **fields):
    """Route K1's forms by ``device``'s spec with ``fields`` replaced."""
    from blur_algorithms_tpu_torch.cuda_kernels import fused_dma

    saved = fused_dma.device_spec
    spec = dataclasses.replace(saved(device), **fields)
    fused_dma.device_spec = lambda device: spec
    try:
        yield spec
    finally:
        fused_dma.device_spec = saved


def _form_sweep(planar) -> list[dict]:
    """K1 direct against each form that fits (K1a with A5), in turns, per
    plane count, radius and rung; the rule ``utils/hw._MEASURED_K1_FORM``
    takes: the radii and plane counts where a form is faster."""
    from blur_algorithms_tpu_torch import make_plan
    from blur_algorithms_tpu_torch.cuda_kernels import fused_dma

    rows = []
    for planes in FORM_SWEEP_PLANES:
        x = planar.reshape(-1, H, W)[:planes]
        for sigma in FORM_SWEEP_SIGMAS:
            plan = make_plan((H, W), sigma)
            r = plan.row.support_radius
            for rung in ("hybrid", "int8"):
                fns = {"direct": lambda t, p=plan, g=rung: fused_dma.blur_fused_u8_dma(
                    t, p, precision=g, direct=True)}
                strip = planes == STRIP_SWEEP[0] and r <= STRIP_SWEEP[1]
                for form in ("strip", "assembled", "resident")[0 if strip else 1:]:
                    if fused_dma.k1_geometry(form, rung, plan, planes, device=x.device):
                        fns[form] = lambda t, p=plan, g=rung, kw=_FORM_KW[form]: (
                            fused_dma.blur_fused_u8_dma(t, p, precision=g, **kw))
                t = _in_turns(f"form sweep {planes} planes r={r} {rung}", fns, x)
                rows.append({"planes": planes, "r": r, "rung": rung, **t})
                print(f"phase 15 form sweep {planes} planes r={r} {rung} (ms): "
                      + ", ".join(f"{k} {v:.4f}" for k, v in t.items()), flush=True)
    return rows


def _k1_forms_from_sweep(rows: list[dict]) -> tuple:
    """The ``DeviceSpec.k1_forms`` table the sweep sets: per rung and plane
    count, the form fastest at each swept radius among K1 direct, K1a (with
    A5) and K1r, as steps where it changes (the strip form is not routed)."""
    table = []
    for rung in ("hybrid", "int8"):
        for planes in FORM_SWEEP_PLANES:
            steps, last = [], "direct"
            for row in rows:
                if (row["rung"], row["planes"]) != (rung, planes):
                    continue
                times = {f: row[f] for f in ("direct", "assembled", "resident") if f in row}
                best = min(times, key=times.get)
                if best != last:
                    steps.append((row["r"], best))
                    last = best
            if steps:
                table.append((rung, planes, tuple(steps)))
    return tuple(table)


def _slice6(frames) -> list[dict]:
    """Phase 15; returns the entries of K1s, K1a, its pipelined variant, A5
    and K1r for the kernels line."""
    import torch.nn.functional as F

    from blur_algorithms_tpu_torch import blur_u8, make_plan, oracle
    from blur_algorithms_tpu_torch.api import _u8_dma_precision
    from blur_algorithms_tpu_torch.cuda_kernels import assemble, fused_dma
    from blur_algorithms_tpu_torch.utils.hw import device_spec

    cases = [((1080, 1920), s) for s in (1.0, 3.0, 10.0, 50.0, 150.0, 180.0)]
    cases += [((1080, 1920), (5.0, 11.0)), (RAGGED, SIGMA)]
    errs = _phase15_equal(cases)

    # ---- the slice's paths at full width, counts set to 0 first ----
    img = np.ascontiguousarray(np.moveaxis(frames, 1, -1))
    x = torch.from_numpy(img).cuda()
    planar = x.movedim(-1, -3).contiguous()
    plan = make_plan((H, W), SIGMA)
    spec = device_spec(x.device)
    rung = _u8_dma_precision(plan, spec)
    want0 = oracle.blur_u8(img[0], SIGMA)
    wrappers = _form_wrappers()
    counters = [*_counters(), *wrappers.values()]
    refs = {"int8": fused_dma.blur_fused_u8_dma_ref,
            "hybrid": fused_dma.blur_fused_u8_hybrid_ref}
    ref = refs[rung](planar, plan).movedim(-3, -1)
    # hybrid: every form bit-equal to K1 direct, and within 1 count of the
    # plain version (tensor-core groups of 16 taps); int8: equal to plain
    direct = (fused_dma.blur_fused_u8_dma(planar, plan, precision=rung, direct=True)
              .movedim(-3, -1) if rung == "hybrid" else ref)
    launched = {}

    def drive(what, call, want, form_names, plain=None):
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        out = call()
        torch.cuda.synchronize()
        ran = _launched(counters)
        d = np.abs(out[0].cpu().numpy().astype(int) - want0.astype(int))
        equal = torch.equal(out, want)
        err = 0 if plain is None else int((out.int() - plain.int()).abs().max())
        print(f"phase 15 main path: {what} {tuple(x.shape)} sigma={SIGMA} rung {rung}: "
              f"launches {ran}; equal to "
              f"{'K1 direct' if plain is not None else 'the plain version'}={equal}"
              + ("" if plain is None else f", vs plain version max_abs_err={err} (limit 1)")
              + f"; frame 0 vs oracle max={int(d.max())} exact={float((d == 0).mean())}",
              flush=True)
        for name in form_names:
            launched[name] = launched.get(name, 0) + ran[name]
            if ran[name] != 1:
                raise RuntimeError(f"{what} launched {name} {ran[name]} times, not once")
        if not equal or err > 1 or d.max() > 1:
            raise RuntimeError(f"{what}: not held to K1 direct and its plain version, or "
                               f"frame 0 is {int(d.max())} counts from the oracle")

    # K1 on AUTO's rung as the card's form rule routes it (through the
    # rung's pin: the card's split radius covers sigma 10's r 32, where AUTO
    # splits); then each form the card's rule does not route at this call,
    # with the rule routing it, or, for the assembled forms, which no rule
    # routes, through the keyword
    geo = fused_dma._resolve_form(plan, rung, BATCH * 3, None, x.device, direct=None,
                                  strip=None, pipelined=False, resident=None)
    print(f"phase 15 K1's form rule at sigma {SIGMA}: rung {rung}, form {geo.form} {geo}; "
          f"the card's rule: {spec.k1_forms}", flush=True)
    pin = f"blur_u8(precision={rung!r})"
    plain = ref if rung == "hybrid" else None
    drive(pin, lambda: blur_u8(x, SIGMA, precision=rung), direct, _routed(geo.form, rung),
          plain)
    for form in ("assembled", "resident"):
        if geo.form != form:
            with _k1_rule_as(x.device, k1_forms=((rung, 1, ((0, form),)),)):
                drive(f"{pin} ({form} routed)", lambda: blur_u8(x, SIGMA, precision=rung),
                      direct, _routed(form, rung), plain)
    drive("blur_fused_u8_dma(strip=True)", lambda: fused_dma.blur_fused_u8_dma(
        planar, plan, precision=rung, strip=True).movedim(-3, -1), direct,
        _routed("strip", rung), plain)
    ref8 = fused_dma.blur_fused_u8_dma_ref(planar, plan).movedim(-3, -1)
    drive("blur_fused_u8_dma(pipelined=True)", lambda: fused_dma.blur_fused_u8_dma(
        planar, plan, pipelined=True).movedim(-3, -1), ref8,
        ["blur_fused_u8_pipelined", "assemble_padded"])
    del ref, ref8, direct
    # the repaired int8 pin past the split radius: K1's int8 body alone
    k1_int8 = ("blur_fused_u8_dma", *(f.__name__ for f in wrappers.values()))
    for sigma in PIN_SIGMAS:
        p = make_plan((H, W), sigma)
        pin_form = fused_dma._resolve_form(p, "int8", BATCH * 3, None, x.device, direct=None,
                                           strip=None, pipelined=False, resident=None).form
        for c in counters:
            c.launches = 0
        out = blur_u8(x, sigma, precision="int8")
        torch.cuda.synchronize()
        ran = _launched(counters)
        want = fused_dma.blur_fused_u8_dma_ref(planar, p).movedim(-3, -1)
        equal = torch.equal(out, want)
        del want
        d = np.abs(out[0].cpu().numpy().astype(int)
                   - oracle.blur_u8(img[0], sigma).astype(int))
        print(f"phase 15 main path: blur_u8(precision='int8') sigma={sigma} "
              f"(r {p.row.support_radius}): form {pin_form}, launches {ran}; equal to K1 "
              f"int8's plain version={equal}; frame 0 vs oracle max={int(d.max())}",
              flush=True)
        others = {k: v for k, v in ran.items() if k not in k1_int8 and v}
        if (any(ran[k] != 1 for k in _routed(pin_form, "int8")) or others or not equal
                or d.max() > 1 or ran["blur_fused_u8_hybrid"] or ran["blur_fused_u8_bf16"]):
            raise RuntimeError(f"the int8 pin at sigma {sigma} did not run K1's int8 body "
                               f"alone: {ran}")
        del out

    # ---- times, in turns ----
    sweep = _form_sweep(planar)
    mp = BATCH * H * W / 1e6
    geos = {f: fused_dma.k1_geometry(f, "int8" if f == "pipelined" else rung, plan,
                                     BATCH * 3, device=x.device)
            for f in ("assembled", "pipelined")}
    frame = assemble.assemble_padded(planar, plan.col.support_radius, plan.row.support_radius,
                                     plan.col.support_radius, plan.row.support_radius,
                                     geos["assembled"].hp, geos["assembled"].wp)
    pframe = assemble.assemble_padded(planar, plan.col.support_radius,
                                      plan.row.support_radius, plan.col.support_radius,
                                      plan.row.support_radius, geos["pipelined"].hp,
                                      geos["pipelined"].wp)
    rh, rw = plan.col.support_radius, plan.row.support_radius
    a5 = lambda t: assemble.assemble_padded(t, rh, rw, rh, rw, geos["assembled"].hp,
                                           geos["assembled"].wp)
    t = _in_turns(f"K1 forms sigma={SIGMA} {rung}", {
        "direct": lambda t_: fused_dma.blur_fused_u8_dma(t_, plan, precision=rung, direct=True),
        "strip": lambda t_: fused_dma.blur_fused_u8_strip(t_, plan, rung),
        "assembled": lambda t_: fused_dma.blur_fused_u8_assembled(frame, plan, rung),
        "assembled_a5": lambda t_: fused_dma.blur_fused_u8_dma(t_, plan, precision=rung,
                                                                direct=False),
        "a5": a5,
        "resident": lambda t_: fused_dma.blur_fused_u8_resident(t_, plan, rung)}, planar)
    tp = _in_turns(f"K1a int8 sigma={SIGMA}", {
        "assembled": lambda t_: fused_dma.blur_fused_u8_assembled(pframe, plan, "int8"),
        "pipelined": lambda t_: fused_dma.blur_fused_u8_pipelined(pframe, plan)}, planar)
    lib_a5 = None
    try:  # the yardstick, where F.pad's reflect mode takes uint8
        lib_a5 = _time(lambda t_: F.pad(t_, (rw, rw, rh, rh), mode="reflect"), planar,
                       name="A5 yardstick: F.pad reflect, uint8").median_ms
    except RuntimeError as err:
        print(f"phase 15 F.pad(mode='reflect') does not take uint8 here ({err}); timed on "
              "float32", flush=True)
        lib_a5 = _time(lambda t_: F.pad(t_, (rw, rw, rh, rh), mode="reflect"), planar.float(),
                       name="A5 yardstick: F.pad reflect, float32").median_ms
    plain = {
        "k1": _time(refs[rung], planar, plan, name=f"K1 {rung} plain version").median_ms,
        "padded": _time(lambda t_: fused_dma.blur_fused_u8_padded_ref(
            assemble.assemble_padded_ref(t_, rh, rw, rh, rw, geos["assembled"].hp,
                                         geos["assembled"].wp), plan, rh, rw, rung),
            planar, name="K1a plain: A5's plain version + blur_fused_u8_padded_ref").median_ms,
        "padded_int8": _time(lambda t_: fused_dma.blur_fused_u8_padded_ref(
            assemble.assemble_padded_ref(t_, rh, rw, rh, rw, geos["pipelined"].hp,
                                         geos["pipelined"].wp), plan, rh, rw, "int8"),
            planar, name="K1a int8 plain").median_ms,
        "a5": _time(lambda t_: assemble.assemble_padded_ref(
            t_, rh, rw, rh, rw, geos["assembled"].hp, geos["assembled"].wp), planar,
            name="A5 plain version").median_ms,
    }
    del frame, pframe
    print(f"phase 15 times in turns at sigma {SIGMA}, {BATCH * 3} planes (ms): {rung} {t}; "
          f"int8 {tp}; plain {plain}; A5 yardstick {lib_a5:.4f}; geometries {geos}",
          flush=True)
    print("phase 15 sweep " + json.dumps(sweep), flush=True)
    table = _k1_forms_from_sweep(sweep)
    print(f"phase 15 sweep sets k1_forms={table} (utils/hw._MEASURED_K1_FORM holds "
          f"{spec.k1_forms}; equal={table == spec.k1_forms})", flush=True)

    outputs = BATCH * 3 * H * W
    tr, tc = 2 * rw + 1, 2 * rh + 1
    frame_bytes = BATCH * 3 * geos["assembled"].hp * geos["assembled"].wp
    ops = ((2 * outputs * 2 * tr, 2 * outputs * tc) if rung == "hybrid"
           else (2 * outputs * (2 * tr + 4 * tc), 0))
    b_k1 = _bound_mixed(2 * outputs, *ops)
    b_k1a = _bound_mixed(outputs + frame_bytes, *ops)  # the frame in, the output out
    pipe_bytes = BATCH * 3 * geos["pipelined"].hp * geos["pipelined"].wp
    b_pipe = _bound_mixed(outputs + pipe_bytes, 2 * outputs * (2 * tr + 4 * tc), 0)
    b_a5 = _bound_mixed(outputs + frame_bytes, 0, 0)
    print(f"phase 15 bounds (ms): K1s and K1r {b_k1}, K1a {b_k1a} (with A5: "
          f"{_bound_mixed(2 * outputs + 2 * frame_bytes, *ops)}), K1a pipelined {b_pipe}, "
          f"A5 {b_a5}", flush=True)

    def entry(name, line, ms, plain_ms, bound, err, library_ms, **extra):
        return {"name": f"fused_dma_{name}", "route": "cuda",
                "source": "blur_algorithms_tpu_torch/csrc/fused_dma.cu",
                "replaces": f"blur_algorithms_tpu/pallas_kernels/fused_dma.py:{line}",
                "launches": launched[wrappers[name].__name__], "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms,
                **extra}

    return [
        entry("strip", 285, t["strip"], plain["k1"], b_k1, errs["strip"], None,
              rung=rung, direct_ms_in_turns=t["direct"]),
        entry("assembled", 223, t["assembled"], plain["padded"], b_k1a, errs["assembled"],
              None, rung=rung, direct_ms_in_turns=t["direct"],
              with_a5_ms=t["assembled_a5"]),
        entry("pipelined", 899, tp["pipelined"], plain["padded_int8"], b_pipe,
              errs["pipelined"], None, rung="int8", assembled_int8_ms_in_turns=tp["assembled"]),
        entry("a5", 1640, t["a5"], plain["a5"], b_a5, errs["a5"], lib_a5),
        entry("resident", 604, t["resident"], plain["k1"], b_k1, errs["resident"], None,
              rung=rung, direct_ms_in_turns=t["direct"]),
    ]


# phase 16: the sharded path on meshes of the one card repeated. Kernel
# checks on shards of HD frames (h_loc 540): A4 at column radius 1..598,
# K1a and K2 pre-padded at r 4..598 (sigma 1, 10, 50, 180), the single-axis
# and split pass 2 forms at column radius 1330 and 3994
A4_RADII = (1, 32, 332, 598)
HALO_SIGMAS = (1.0, 10.0, 50.0, 180.0)
HALO_AXIS_CASES = ((HD, 400.0, 540), ((8400, 96), 1200.0, 525))  # (frame, sigma, h_loc)
SHARD_MESHES = ((2, 2), (1, 4))  # blur_sharded_u8 at SIGMA_SHARD_K1
# K1a's sharded path: sigma 9 (r 29), under the card's uint8 split radius
# (r 82 on the H100)
SIGMA_SHARD_K1 = 9.0
# K2's sharded path: sigma 5 (r 15), under the card's float split radius (r
# 19 on the H100); from there AUTO takes the haloed f32 split
SIGMA_SHARD_K2 = 5.0
GATHER_SP, SIGMA_GATHER = 16, 50.0  # h_loc 135 < r 165 <= 165: the multi-hop gather
RAGGED_ROWS = 1001  # on sp 4: the pad-row fill
# blur_sharded f32, r 165 >= 49: the haloed split, with the card's float
# crossover (119 on the H100) raised to 165 for the call
SIGMA_SHARD_SPLIT = 50.0
# blur_sharded_u8 at r 514 with the card's uint8 crossover lowered to 165
# for the call (its value with the CUDA-core split): the distributed FFT.
# The card's own crossover (r 1920) lies past the column radius of any plan
# of 2160 rows, which is what the sharded path compares with it.
SIGMA_SHARD_FFT, SHARD_FFT_CROSSOVER = 155.0, 165
SIGMA_SHARD_E32 = 250.0  # blur_sharded_u8 under the card's crossover: the haloed int8 split


def _r16(n: int) -> int:
    return (n + 15) & ~15


@contextlib.contextmanager
def _route_spec_as(device, **fields):
    """Route the entry points, the fused engine and the sharded path by
    ``device``'s spec with ``fields`` replaced (K1's form rule and its
    shared-memory sizing keep the card's own)."""
    from blur_algorithms_tpu_torch import api
    from blur_algorithms_tpu_torch.cuda_kernels import fused_blur
    from blur_algorithms_tpu_torch.parallel import sharded

    mods = (api, fused_blur, sharded)
    saved = [m.device_spec for m in mods]
    spec = dataclasses.replace(saved[0](device), **fields)
    for m in mods:
        m.device_spec = lambda device: spec
    try:
        yield spec
    finally:
        for m, f in zip(mods, saved):
            m.device_spec = f


def _haloed_dma_plain(x, plan, rung, out_u8, geo):
    """K1a on caller rows' plain version on the card: A4's plain version,
    then ``blur_fused_u8_padded_ref``."""
    from blur_algorithms_tpu_torch.cuda_kernels import assemble, fused_dma

    rh, rw = plan.col.support_radius, plan.row.support_radius
    frame = assemble.assemble_padded_prepad_ref(x, rw, rw, geo.hp, geo.wp)
    return fused_dma.blur_fused_u8_padded_ref(frame, plan, rh, rw, rung, out_u8)


def _phase16_equal() -> dict:
    """Each per-shard kernel against its plain version on the card, on
    shards of random rows with halos; returns the worst differences."""
    from blur_algorithms_tpu_torch import make_plan
    from blur_algorithms_tpu_torch.cuda_kernels import assemble, fused_blur, fused_dma
    from blur_algorithms_tpu_torch.cuda_kernels import fused_split as fs
    from blur_algorithms_tpu_torch.parallel.sharded import _local_plan

    errs = {"a4": 0, "k1a": 0.0, "k2": 0.0, "k2_u8": 0, "axis": 0.0, "axis_u8": 0,
            "cols_int8": 0.0, "cols_hybrid": 0.0}
    h, w = HD[0] // 2, HD[1]
    for k, rw in enumerate(A4_RADII):
        x = _case_frames(h + 2 * rw, w, seed=600 + k)
        hp, wp = _r16(h + 2 * rw) + 16, _r16(w + 2 * rw)
        got = assemble.assemble_padded_prepad(x, rw, rw, hp, wp)
        want = assemble.assemble_padded_prepad_ref(x, rw, rw, hp, wp)
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        errs["a4"] = max(errs["a4"], int((got.int() - want.int()).abs().max()))
        print(f"phase 16 A4 vs plain: 3x{h + 2 * rw}x{w} rw={rw} in ({hp}, {wp}): "
              f"equal={equal}", flush=True)
        if not equal:
            raise RuntimeError(f"A4 differs from its plain version at rw {rw}")
    for k, sigma in enumerate(HALO_SIGMAS):
        plan = _local_plan(make_plan(HD, sigma), h, w)
        rh, rw = plan.col.support_radius, plan.row.support_radius
        x = _case_frames(h + 2 * rh, w, seed=610 + k)
        for rung in fused_dma.RUNGS:
            geo = fused_dma.k1_geometry("assembled", rung, plan, 3, device=x.device)
            if geo is None:  # K1a's block does not fit (bf16 at r 598)
                continue
            for out_u8 in (True, False):
                got = fused_dma.blur_fused_haloed_dma(x, plan, rung, out_u8=out_u8)
                want = _haloed_dma_plain(x, plan, rung, out_u8, geo)
                torch.cuda.synchronize()
                err = float((got.double() - want.double()).abs().max())
                errs["k1a"] = max(errs["k1a"], err)
                # hybrid: tensor-core groups of 16 taps, within HYBRID_TOL /
                # 1 count of the plain version; int8, bf16: bit-equal
                if not (err <= (1 if out_u8 else HYBRID_TOL) if rung == "hybrid"
                        else torch.equal(got, want)):
                    raise RuntimeError(f"K1a on caller rows ({rung}, out_u8={out_u8}) "
                                       f"differs from its plain version at sigma {sigma}")
        xf = _f32_planes(h + 2 * rh, w, seed=620 + k)
        got = fused_blur.blur_fused_f32(xf, plan, pre_padded_col=True)
        want = fused_blur.blur_fused_f32_ref(xf, plan, pre_padded_col=True)
        got8 = fused_blur.blur_fused_f32(x, plan, out_u8=True, pre_padded_col=True)
        want8 = fused_blur.blur_fused_f32_ref(x, plan, out_u8=True, pre_padded_col=True)
        torch.cuda.synchronize()
        e32, e8 = float((got - want).abs().max()), int((got8.int() - want8.int()).abs().max())
        errs["k2"], errs["k2_u8"] = max(errs["k2"], e32), max(errs["k2_u8"], e8)
        served = [g for g in fused_dma.RUNGS
                  if fused_dma.k1_geometry("assembled", g, plan, 3, device=x.device)]
        print(f"phase 16 K1a ({served}; uint8 and f32 out) and K2 pre-padded vs "
              f"plain: 3x{h + 2 * rh}x{w} sigma={sigma} r=({rh}, {rw}): K1a equal; K2 f32 "
              f"{e32:.3e}, uint8 {e8}", flush=True)
        if e32 > 1e-3 * float(xf.abs().max()) / 255 or e8 > 1:
            raise RuntimeError(f"K2 pre-padded differs from its plain version at sigma {sigma}")
    for k, (shape, sigma, h_loc) in enumerate(HALO_AXIS_CASES):
        plan = _local_plan(make_plan(shape, sigma), h_loc, shape[1])
        rh = plan.col.support_radius
        rows_h, (_, cols) = fused_blur._haloed_rows_plan(plan), fused_blur._split_plans(plan)
        x = _case_frames(h_loc + 2 * rh, shape[1], seed=630 + k)
        xf = _f32_planes(h_loc + 2 * rh, shape[1], seed=640 + k)
        # against the plain version in float64, as in phase 11 (r 960, 3994)
        got = fused_blur.blur_fused_axis_f32(xf, cols, pre_padded_col=True)
        want = fused_blur.blur_fused_f32_ref(xf.double(), cols, pre_padded_col=True)
        got8 = fused_blur.blur_fused_axis_f32(x, cols, out_u8=True, pre_padded_col=True)
        want8 = fused_blur.blur_fused_f32_ref(x.double(), cols, out_u8=True, pre_padded_col=True)
        torch.cuda.synchronize()
        ea = float((got.double() - want).abs().max())
        ea8 = int((got8.int() - want8.int()).abs().max())
        errs["axis"], errs["axis_u8"] = max(errs["axis"], ea), max(errs["axis_u8"], ea8)
        if ea > 1e-3 * float(xf.abs().max()) / 255 or ea8 > 1:
            raise RuntimeError(f"K2's single-axis form pre-padded differs at {shape, sigma}")
        e = fs.fused_split_rows_int8(x, rows_h, out_e32=True)
        for name, pass2, ref in (("cols_int8", fs.fused_split_cols_int8,
                                  fs.fused_split_cols_int8_ref),
                                 ("cols_hybrid", fs.fused_split_cols_hybrid,
                                  fs.fused_split_cols_hybrid_ref)):
            for out_u8 in (True, False):
                got = pass2(e, cols, out_u8=out_u8, pre_padded_col=True)
                want = ref(e, cols, out_u8=out_u8, pre_padded_col=True)
                if name == "cols_hybrid":
                    errs[name] = max(errs[name], _check_hybrid(
                        f"phase 16 pre-padded hybrid pass 2 vs plain: 3x{h_loc + 2 * rh}x"
                        f"{shape[1]} column r={rh}", got, want, out_u8))
                    continue
                torch.cuda.synchronize()
                errs[name] = max(errs[name], float((got.double() - want.double()).abs().max()))
                if not torch.equal(got, want):
                    raise RuntimeError(f"{name} pre-padded differs from its plain version "
                                       f"at {shape, sigma}")
        print(f"phase 16 pre-padded single-axis cols and split pass 2 vs plain: "
              f"3x{h_loc + 2 * rh}x{shape[1]} column r={rh}: single-axis f32 {ea:.3e}, "
              f"uint8 {ea8}; int8 pass 2 equal, hybrid pass 2 within {HYBRID_TOL}", flush=True)
        del e, x, xf
    return errs


def _phase16_paths(img, want0, counters, sharded_fft) -> dict:
    """The sharded path at full width on meshes of the one card repeated,
    counts set to 0 before each call; returns the launches per wrapper."""
    from blur_algorithms_tpu_torch import blur, blur_u8, make_plan, oracle
    from blur_algorithms_tpu_torch.api import _u8_dma_precision
    from blur_algorithms_tpu_torch.cuda_kernels import fused_blur, fused_dma
    from blur_algorithms_tpu_torch.parallel import (
        blur_fft_sharded_u8,
        blur_sharded,
        blur_sharded_u8,
        make_mesh,
    )
    from blur_algorithms_tpu_torch.parallel.sharded import _local_plan
    from blur_algorithms_tpu_torch.utils.hw import device_spec

    x = torch.from_numpy(img).cuda()
    dev = x.device
    planar = x.movedim(-1, -3).contiguous()
    launched: dict[str, int] = {}

    def mesh(dp, sp):
        return make_mesh(dp=dp, sp=sp, devices=[dev] * (dp * sp))

    def rung_of(plan, h_loc):
        return _u8_dma_precision(_local_plan(plan, h_loc, plan.shape[1]), device_spec(dev))

    def drive(what, call, expect: dict):
        """Run ``call`` with every count at 0; ``expect``: wrapper -> launches
        (None: at least one); any other wrapper launched fails."""
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        out = call()
        torch.cuda.synchronize()
        ran = {k: v for k, v in _launched(counters).items() if v}
        for name, n in ran.items():
            launched[name] = launched.get(name, 0) + n
        bad = {k: v for k, v in ran.items() if k not in expect}
        short = {k: ran.get(k, 0) for k, n in expect.items()
                 if ran.get(k, 0) != n and not (n is None and ran.get(k, 0) > 0)}
        print(f"phase 16 main path: {what}: launches {ran}", flush=True)
        if bad or short:
            raise RuntimeError(f"{what}: launched {ran}, expected {expect}")
        return out

    def check_u8(what, out, want, sigma=None, ref0=None):
        equal = torch.equal(out, want)
        line = f"phase 16 main path: {what}: torch.equal to the single-card call={equal}"
        d = None
        if ref0 is not None:
            d = np.abs(out[0].cpu().numpy().astype(int) - ref0.astype(int))
            line += f"; frame 0 vs oracle max={int(d.max())} exact={float((d == 0).mean())}"
        print(line, flush=True)
        if not equal or (d is not None and d.max() > 1):
            raise RuntimeError(f"{what}: not equal to the single-card call, or frame 0 is "
                               "past 1 count of the oracle")

    def k1a(shards):  # A4 and K1a once a shard, nothing else
        return {"assemble_padded_prepad": shards, "blur_fused_u8_assembled": shards}

    plan = make_plan((H, W), SIGMA_SHARD_K1)
    want9 = oracle.blur_u8(img[0], SIGMA_SHARD_K1)
    for dp, sp in SHARD_MESHES:
        rung = rung_of(plan, H // sp)
        out = drive(f"blur_sharded_u8 dp {dp} x sp {sp} sigma={SIGMA_SHARD_K1} (rung {rung})",
                    lambda: blur_sharded_u8(x, plan, mesh(dp, sp)), k1a(dp * sp))
        check_u8(f"blur_sharded_u8 dp {dp} x sp {sp}", out,
                 blur_u8(x, SIGMA_SHARD_K1, precision=rung), ref0=want9)
        del out
    # sigma 10 (r 32) on the card's split radius: each shard's haloed split
    p10 = make_plan((H, W), SIGMA)
    if fused_blur._split_wins(_local_plan(p10, H // 2, W), 1, "int8", dev):
        pass2 = _pass2(_local_plan(p10, H // 2, W), dev)
        out = drive(f"blur_sharded_u8 dp 2 x sp 2 sigma={SIGMA} -> haloed split, {pass2}",
                    lambda: blur_sharded_u8(x, p10, mesh(2, 2)),
                    {"fused_split_rows_int8": 4, pass2: 4})
        check_u8("blur_sharded_u8 dp 2 x sp 2 sigma 10 (haloed split)", out, blur_u8(x, SIGMA),
                 ref0=want0)
        del out
    # past the shard height: sp 16 (h_loc 135) at r 165, the multi-hop
    # gather; past the card's split radius each shard runs the haloed int8
    # split with the pass 2 one card runs, as blur_u8's AUTO does
    p50 = make_plan((H, W), SIGMA_GATHER)
    pass2 = _pass2(_local_plan(p50, H // GATHER_SP, W), dev)
    out = drive(f"blur_sharded_u8 dp 1 x sp {GATHER_SP} sigma={SIGMA_GATHER} "
                f"(r {p50.col.support_radius}) -> haloed split, {pass2}",
                lambda: blur_sharded_u8(x, p50, mesh(1, GATHER_SP)),
                {"fused_split_rows_int8": GATHER_SP, pass2: GATHER_SP})
    check_u8(f"blur_sharded_u8 sp {GATHER_SP} (multi-hop gather)", out,
             blur_u8(x, SIGMA_GATHER))
    del out
    # an indivisible height: 1001 rows on sp 4 (h_loc 251, 3 pad rows)
    xr = x[:, :RAGGED_ROWS].contiguous()
    pr = make_plan((RAGGED_ROWS, W), SIGMA_SHARD_K1)
    rung = rung_of(pr, -(-RAGGED_ROWS // 4))
    out = drive(f"blur_sharded_u8 {tuple(xr.shape)} dp 1 x sp 4 sigma={SIGMA_SHARD_K1}",
                lambda: blur_sharded_u8(xr, pr, mesh(1, 4)), k1a(4))
    check_u8("blur_sharded_u8 ragged 1001 rows on sp 4", out,
             blur_u8(xr, SIGMA_SHARD_K1, precision=rung))
    del out, xr
    # the int8 body's f32 store: the uint8 batch to float (blur_sharded's
    # default), on a spec whose ladder certifies no rung (so int8)
    with _route_spec_as(dev, hybrid_cert_min_radius=None, bf16_cert_min_radius=None):
        out = drive(f"blur_sharded uint8 -> f32 dp 2 x sp 2 sigma={SIGMA_SHARD_K1} (rung int8)",
                    lambda: blur_sharded(planar, plan, mesh(2, 2)), k1a(4))
    want = fused_dma.blur_fused_u8_dma_ref(planar, plan, out_u8=False)
    equal = torch.equal(out, want)
    print(f"phase 16 main path: K1a int8 f32 store through blur_sharded: torch.equal to K1 "
          f"int8's plain version={equal}", flush=True)
    if not equal:
        raise RuntimeError("blur_sharded uint8 -> f32 differs from K1 int8's f32 store")
    del out, want

    # float planes: K2 pre-padded at sigma 5, the haloed f32 split at sigma
    # 50 (the card's float crossover raised to r 165 for the call)
    xf = planar.float()
    for sigma, expect in ((SIGMA_SHARD_K2, {"blur_fused_f32": 4}),
                          (SIGMA_SHARD_SPLIT, {"blur_fused_axis_f32": 8})):
        p = make_plan((H, W), sigma)
        r = max(p.col.support_radius, p.row.support_radius)
        crossover = max(r, device_spec(dev).auto_fused_max_radius_f32)
        with _route_spec_as(dev, auto_fused_max_radius_f32=crossover):
            out = drive(f"blur_sharded f32 {tuple(xf.shape)} dp 2 x sp 2 sigma={sigma}",
                        lambda: blur_sharded(xf, p, mesh(2, 2)), expect)
            err = float((out - blur(xf, sigma)).abs().max())
        print(f"phase 16 main path: blur_sharded f32 sigma={sigma} vs single-card blur: "
              f"max_abs_err={err:.3e}", flush=True)
        if err > 1e-3 * float(xf.abs().max()) / 255:
            raise RuntimeError(f"blur_sharded f32 at sigma {sigma} is {err} from blur")
        del out
    del xf

    # the reroutes to the distributed FFT: no kernel runs
    sharded_fft.calls = 0
    with _route_spec_as(dev, auto_fused_max_radius_u8=SHARD_FFT_CROSSOVER):
        out = drive(f"blur_sharded_u8 dp 2 x sp 2 sigma={SIGMA_SHARD_FFT} "
                    f"(r {make_plan((H, W), SIGMA_SHARD_FFT).col.support_radius}, crossover "
                    f"{SHARD_FFT_CROSSOVER})",
                    lambda: blur_sharded_u8(x, make_plan((H, W), SIGMA_SHARD_FFT), mesh(2, 2)),
                    {})
    d = np.abs(out[0].cpu().numpy().astype(int)
               - oracle.blur_u8(img[0], SIGMA_SHARD_FFT).astype(int))
    print(f"phase 16 main path: rerouted to blur_fft_sharded {sharded_fft.calls} time(s); "
          f"frame 0 vs oracle max={int(d.max())} exact={float((d == 0).mean())}", flush=True)
    if sharded_fft.calls != 1 or d.max() > 1:
        raise RuntimeError(f"blur_sharded_u8 at sigma {SIGMA_SHARD_FFT} did not reroute, or "
                           "frame 0 is past 1 count of the oracle")
    out = drive(f"blur_fft_sharded_u8 dp 2 x sp 2 sigma={SIGMA_U8_WIDE}",
                lambda: blur_fft_sharded_u8(x, make_plan((H, W), SIGMA_U8_WIDE), mesh(2, 2)),
                {})
    d = np.abs(out[0].cpu().numpy().astype(int)
               - oracle.blur_u8(img[0], SIGMA_U8_WIDE).astype(int))
    print(f"phase 16 main path: blur_fft_sharded_u8 frame 0 vs oracle max={int(d.max())} "
          f"exact={float((d == 0).mean())}", flush=True)
    if d.max() > 1:
        raise RuntimeError("blur_fft_sharded_u8: frame 0 is past 1 count of the oracle")
    del out

    # the haloed int8 split (int8 rows over the halo rows, pass 2 on
    # pre-padded E) where the crossover keeps r 831 on the fused engine:
    # the hybrid pass 2 the card certified, then the int8 one
    pe = make_plan((H, W), SIGMA_SHARD_E32)
    crossover = max(pe.col.support_radius, device_spec(dev).auto_fused_max_radius_u8)
    for fields, pass2 in (({}, "fused_split_cols_hybrid"),
                          ({"hybrid_split_cert_max_radius": None}, "fused_split_cols_int8")):
        with _route_spec_as(dev, auto_fused_max_radius_u8=crossover, **fields):
            out = drive(f"blur_sharded_u8 dp 2 x sp 2 sigma={SIGMA_SHARD_E32} "
                        f"(r {pe.col.support_radius}, crossover {crossover}) -> {pass2}",
                        lambda: blur_sharded_u8(x, pe, mesh(2, 2)),
                        {"fused_split_rows_int8": 4, pass2: 4})
            want = blur_u8(x, SIGMA_SHARD_E32, engine="fused")
        check_u8(f"blur_sharded_u8 haloed int8 split, {pass2}", out, want)
        del out, want
    return launched


def _slice7(frames, want0) -> list[dict]:
    """Phase 16; returns the entries of A4, K1a on caller rows, K2's
    pre-padded forms and the split's pre-padded pass 2 for the kernels
    line."""
    import torch.nn.functional as F

    from blur_algorithms_tpu_torch import blur, blur_u8, make_plan
    from blur_algorithms_tpu_torch.api import _u8_dma_precision
    from blur_algorithms_tpu_torch.cuda_kernels import assemble, fused_blur, fused_dma
    from blur_algorithms_tpu_torch.cuda_kernels import fused_split as fs
    from blur_algorithms_tpu_torch.ops.pad import reflect_101
    from blur_algorithms_tpu_torch.parallel import (
        blur_sharded,
        blur_sharded_u8,
        make_mesh,
        sharded,
    )
    from blur_algorithms_tpu_torch.parallel.sharded import _local_plan
    from blur_algorithms_tpu_torch.utils.hw import device_spec

    errs = _phase16_equal()
    img = np.ascontiguousarray(np.moveaxis(frames, 1, -1))
    counters = [*_counters(), *_form_wrappers().values(), assemble.assemble_padded_prepad]
    real_fft = sharded.blur_fft_sharded

    def sharded_fft(*a, **k):
        sharded_fft.calls += 1
        return real_fft(*a, **k)

    sharded.blur_fft_sharded = sharded_fft
    try:
        launched = _phase16_paths(img, want0, counters, sharded_fft)
    finally:
        sharded.blur_fft_sharded = real_fft
    print(f"phase 16 launches on the sharded path: {launched}", flush=True)

    # ---- times: one dp 2 x sp 2 shard of the batch at sigma 9 ----
    x = torch.from_numpy(img).cuda()
    planar = x.movedim(-1, -3).contiguous()
    plan = make_plan((H, W), SIGMA_SHARD_K1)
    local = _local_plan(plan, H // 2, W)
    rh, rw = local.col.support_radius, local.row.support_radius
    rung = _u8_dma_precision(local, device_spec(x.device))
    top = planar[: BATCH // 2, :, : H // 2]  # the top shard of dp 2 x sp 2

    def haloed(r):  # the top shard with its r halo rows each side
        return reflect_101(top, [(r, r)], axes=[-2]).contiguous()

    hx = haloed(rh)  # (2, 3, 1144, 3840)
    planes, hs = hx.shape[0] * hx.shape[1], hx.shape[2]
    geo = fused_dma.k1_geometry("assembled", rung, local, planes, device=x.device)
    frame = assemble.assemble_padded_prepad(hx, rw, rw, geo.hp, geo.wp)
    t = {
        "a4": _time(assemble.assemble_padded_prepad, hx, rw, rw, geo.hp, geo.wp,
                    name="A4 on a dp 2 x sp 2 shard").median_ms,
        "k1a": _time(fused_dma.blur_fused_u8_assembled, frame, local, rung,
                     name=f"K1a {rung} on A4's frame").median_ms,
        "a4_plain": _time(assemble.assemble_padded_prepad_ref, hx, rw, rw, geo.hp, geo.wp,
                          name="A4 plain version").median_ms,
        "k1a_plain": _time(fused_dma.blur_fused_u8_padded_ref, frame, local, rh, rw, rung,
                           name=f"K1a {rung} plain version on A4's frame").median_ms,
    }
    pad_w, pad_h = geo.wp - W - 2 * rw, geo.hp - hs
    try:  # the yardstick: F.pad's reflect on the columns, then a zero pad
        t["a4_lib"] = _time(lambda u: F.pad(F.pad(u, (rw, rw, 0, 0), mode="reflect"),
                                            (0, pad_w, 0, pad_h)), hx,
                            name="A4 yardstick: F.pad reflect columns + zero pad, uint8"
                            ).median_ms
    except RuntimeError as err:
        print(f"phase 16 F.pad(mode='reflect') does not take uint8 here ({err}); timed on "
              "float32", flush=True)
        t["a4_lib"] = _time(lambda u: F.pad(F.pad(u, (rw, rw, 0, 0), mode="reflect"),
                                            (0, pad_w, 0, pad_h)), hx.float(),
                            name="A4 yardstick: F.pad reflect columns + zero pad, float32"
                            ).median_ms
    def hold(key, what, got, want, limit=None):
        """Kernel against its plain version on the main path's shard:
        ``torch.equal``, or within ``limit``; worst difference into errs."""
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max())
        ok = torch.equal(got, want) if limit is None else err <= limit
        errs[key] = max(errs[key], err if isinstance(errs[key], float) else int(err))
        print(f"phase 16 {what} vs plain on the main path's dp 2 x sp 2 shard, out "
              f"{tuple(got.shape)}: "
              f"max_abs_err={err:.3e} "
              + ("equal" if limit is None else f"limit={limit:.3e}"), flush=True)
        if not ok:
            raise RuntimeError(f"{what} differs from its plain version on the main path's "
                               "shard")

    hold("a4", "A4", frame, assemble.assemble_padded_prepad_ref(hx, rw, rw, geo.hp, geo.wp))
    for out_u8 in (True, False):
        hold("k1a", f"K1a {rung} (out_u8={out_u8}) on A4's frame",
             fused_dma.blur_fused_u8_assembled(frame, local, rung, out_u8),
             fused_dma.blur_fused_u8_padded_ref(frame, local, rh, rw, rung, out_u8),
             None if rung != "hybrid" else 1 if out_u8 else HYBRID_TOL)
    del frame
    meshes = {(dp, sp): make_mesh(dp=dp, sp=sp, devices=[x.device] * (dp * sp))
              for dp, sp in (*SHARD_MESHES, (1, GATHER_SP))}
    mesh22 = meshes[2, 2]
    t_path = _in_turns(f"blur_u8 vs blur_sharded_u8 dp 2 x sp 2 sigma={SIGMA_SHARD_K1}", {
        "single": lambda u: blur_u8(u, SIGMA_SHARD_K1),
        "sharded": lambda u: blur_sharded_u8(u, plan, mesh22)}, x)
    t_path["sharded_dp1_sp4"] = _time(lambda u: blur_sharded_u8(u, plan, meshes[1, 4]), x,
                                      name=f"blur_sharded_u8 dp 1 x sp 4 "
                                      f"sigma={SIGMA_SHARD_K1}").median_ms
    p50 = make_plan((H, W), SIGMA_GATHER)
    t_gather = _in_turns(f"blur_u8 vs blur_sharded_u8 sp {GATHER_SP} sigma={SIGMA_GATHER}", {
        "single": lambda u: blur_u8(u, SIGMA_GATHER),
        "sharded": lambda u: blur_sharded_u8(u, p50, meshes[1, GATHER_SP])}, x)
    plan2 = make_plan((H, W), SIGMA_SHARD_K2)
    t_float = _in_turns(f"blur vs blur_sharded f32 dp 2 x sp 2 sigma={SIGMA_SHARD_K2}", {
        "single": lambda u: blur(u, SIGMA_SHARD_K2),
        "sharded": lambda u: blur_sharded(u, plan2, mesh22)}, planar.float())
    # where blur_sharded_u8's time goes on dp 2 x sp 2: the layout copies,
    # the cut into blocks, the halo exchange, the shards' steps, the gather
    blocks = sharded._blocks(planar, mesh22)
    halo = [sharded._haloed_row(row, mesh22.devices[i], rh, H // 2, 0, H)
            for i, row in enumerate(blocks)]

    def steps(rows):
        return [[fused_blur.blur_fused_haloed(u, local, rung, out_u8=True) for u in row]
                for row in rows]

    outs = steps(halo)
    t_parts = {
        "layout": _time(lambda u: u.movedim(-1, -3).contiguous().movedim(-3, -1).contiguous(),
                        x, name="the two layout copies").median_ms,
        "cut": _time(sharded._blocks, planar, mesh22, name="cut into 2 x 2 blocks").median_ms,
        "halo": _time(lambda bl: [sharded._haloed_row(row, mesh22.devices[i], rh, H // 2, 0, H)
                                  for i, row in enumerate(bl)], blocks,
                      name="halo exchange").median_ms,
        "steps": _time(steps, halo, name="the four shards' A4 + K1a").median_ms,
        "gather": _time(sharded._gather, outs, x.device, name="gather").median_ms,
    }
    del blocks, halo, outs

    # K2 pre-padded on the float shard at sigma 5; its yardstick: reflect
    # the columns, two depthwise conv2d (TF32 off), rows valid
    local2 = _local_plan(make_plan((H, W), SIGMA_SHARD_K2), H // 2, W)
    rh2, rw2 = local2.col.support_radius, local2.row.support_radius
    hf = haloed(rh2).float()
    hs2 = hf.shape[2]
    c = 3
    w_row = torch.from_numpy(local2.row.taps).cuda().view(1, 1, 1, -1).repeat(c, 1, 1, 1)
    w_col = torch.from_numpy(local2.col.taps).cuda().view(1, 1, -1, 1).repeat(c, 1, 1, 1)

    def lib_k2(u):
        u = F.conv2d(F.pad(u, (rw2, rw2, 0, 0), mode="reflect"), w_row, groups=c)
        return F.conv2d(u, w_col, groups=c)

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        t["k2"] = _time(fused_blur.blur_fused_f32, hf, local2, False, True,
                        name="K2 pre-padded on the float shard").median_ms
        t["k2_plain"] = _time(fused_blur.blur_fused_f32_ref, hf, local2, False, True,
                              name="K2 pre-padded plain version").median_ms
        t["k2_lib"] = _time(lib_k2, hf, name="K2 pre-padded yardstick: column reflect + 2 "
                            "depthwise conv2d").median_ms
        k2_limit = 1e-3 * float(hf.abs().max()) / 255  # phase 5's
        hold("k2", "K2 pre-padded f32", fused_blur.blur_fused_f32(hf, local2, False, True),
             fused_blur.blur_fused_f32_ref(hf, local2, False, True), k2_limit)
        # the single-axis cols pass of the sigma 50 haloed split
        p50 = _local_plan(make_plan((H, W), SIGMA_SHARD_SPLIT), H // 2, W)
        r50 = p50.col.support_radius
        _, cols50 = fused_blur._split_plans(p50)
        hy = haloed(r50).float()
        wc50 = torch.from_numpy(p50.col.taps).cuda().view(1, 1, -1, 1).repeat(c, 1, 1, 1)
        t["axis"] = _time(fused_blur.blur_fused_axis_f32, hy, cols50, False, True,
                          name=f"K2 single-axis cols pre-padded r={r50}").median_ms
        t["axis_plain"] = _time(fused_blur.blur_fused_f32_ref, hy, cols50, False, True,
                                name="single-axis cols pre-padded plain version").median_ms
        t["axis_lib"] = _time(lambda u: F.conv2d(u, wc50, groups=c), hy,
                              name="single-axis yardstick: depthwise conv2d along columns"
                              ).median_ms
        hold("axis", f"K2 single-axis cols pre-padded r={r50}",
             fused_blur.blur_fused_axis_f32(hy, cols50, False, True),
             fused_blur.blur_fused_f32_ref(hy, cols50, False, True),
             1e-3 * float(hy.abs().max()) / 255)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    del hf, hy

    # the split's pass 2 on pre-padded E, sigma 250 (r 831)
    pe = _local_plan(make_plan((H, W), SIGMA_SHARD_E32), H // 2, W)
    re_ = pe.col.support_radius
    _, cols_e = fused_blur._split_plans(pe)
    he = haloed(re_)
    e = fs.fused_split_rows_int8(he, fused_blur._haloed_rows_plan(pe))
    tp2 = _in_turns(f"split pass 2 pre-padded r={re_}", {
        "int8": lambda u: fs.fused_split_cols_int8(u, cols_e, pre_padded_col=True),
        "hybrid": lambda u: fs.fused_split_cols_hybrid(u, cols_e, pre_padded_col=True)}, e)
    t["cols_int8_plain"] = _time(fs.fused_split_cols_int8_ref, e, cols_e, True, True,
                                 name="int8 pass 2 pre-padded plain version").median_ms
    t["cols_hybrid_plain"] = _time(fs.fused_split_cols_hybrid_ref, e, cols_e, True, True,
                                   name="hybrid pass 2 pre-padded plain version").median_ms
    for name, pass2, ref in (("cols_int8", fs.fused_split_cols_int8, fs.fused_split_cols_int8_ref),
                             ("cols_hybrid", fs.fused_split_cols_hybrid,
                              fs.fused_split_cols_hybrid_ref)):
        for out_u8 in (True, False):
            got, want = pass2(e, cols_e, out_u8, True), ref(e, cols_e, out_u8, True)
            if name == "cols_hybrid":
                errs[name] = max(errs[name], _check_hybrid(
                    f"phase 16 split hybrid pass 2 pre-padded r={re_} vs plain on the main "
                    f"path's dp 2 x sp 2 shard", got, want, out_u8))
            else:
                hold(name, f"split {name[5:]} pass 2 pre-padded r={re_} (out_u8={out_u8})",
                     got, want)
    eb = e.to(torch.bfloat16)
    wce = torch.from_numpy(pe.col.taps).cuda().to(torch.bfloat16).view(1, 1, -1, 1)
    t["cols_lib"] = _time(lambda u: F.conv2d(u, wce.repeat(c, 1, 1, 1), groups=c), eb,
                          name="pass 2 yardstick: depthwise conv2d along columns in bf16"
                          ).median_ms
    del e, eb, he, hx
    print(f"phase 16 times (ms): {t}; blur_u8 vs blur_sharded_u8 in turns {t_path}; at "
          f"sigma {SIGMA_GATHER} on sp {GATHER_SP} {t_gather}; blur vs blur_sharded f32 "
          f"{t_float}; blur_sharded_u8 dp 2 x sp 2 in parts {t_parts}; split pass 2 "
          f"pre-padded in turns {tp2}", flush=True)

    outputs = planes * (H // 2) * W
    tr, tc = 2 * rw + 1, 2 * rh + 1
    frame_bytes = planes * geo.hp * geo.wp
    b_a4 = _bound_ms(planes * hs * W + frame_bytes, 0, F32_FLOP_PER_S)
    ops = ((2 * outputs * 2 * tr, 2 * outputs * tc) if rung == "hybrid"
           else (2 * outputs * (2 * tr + 4 * tc), 0))
    b_k1a = _bound_mixed(outputs + frame_bytes, *ops)
    # K2: f32 in and out; its 3xTF32 band products, the rows pass over every
    # halo row, the cols pass per output
    b_k2 = _bound_ms(4 * (planes * hs2 * W + outputs),
                     planes * hs2 * W * _band_flop(rw2) + outputs * _band_flop(rh2),
                     TF32_FLOP_PER_S)
    b_axis = _bound_ms(4 * (planes * (H // 2 + 2 * r50) * W + outputs),
                       outputs * _band_flop(r50), TF32_FLOP_PER_S)
    te = 2 * re_ + 1
    e_bytes = 2 * planes * (H // 2 + 2 * re_) * W
    b_int8 = _bound_ms(e_bytes + outputs, 2 * outputs * 4 * te, INT8_OP_PER_S)
    b_hyb = _bound_mixed(e_bytes + outputs, 0, 2 * outputs * te)
    print(f"phase 16 bounds (ms): A4 {b_a4}, K1a {b_k1a}, K2 pre-padded {b_k2}, single-axis "
          f"cols pre-padded {b_axis}, pass 2 int8 {b_int8}, hybrid {b_hyb}", flush=True)

    def entry(name, src, line, launches, ms, plain_ms, bound, err, library_ms, **extra):
        return {"name": name, "route": "cuda", "source": f"blur_algorithms_tpu_torch/csrc/{src}",
                "replaces": f"blur_algorithms_tpu/pallas_kernels/{line}",
                "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms,
                **extra}

    shard = f"{BATCH // 2}x3x{H // 2}x{W} shard"
    return [
        entry("assemble_prepad", "fused_dma.cu", "fused_dma.py:1708",
              launched.get("assemble_padded_prepad", 0), t["a4"], t["a4_plain"], b_a4,
              errs["a4"], t["a4_lib"], at=shard, kernel="assemble_padded_kernel (A5's)"),
        entry("fused_dma_assembled_prepadded", "fused_dma.cu", "fused_dma.py:223",
              launched.get("blur_fused_u8_assembled", 0), t["k1a"], t["k1a_plain"], b_k1a,
              errs["k1a"], None, at=shard, rung=rung,
              sharded_u8_ms_in_turns=t_path["sharded"], blur_u8_ms_in_turns=t_path["single"],
              sharded_u8_dp1_sp4_ms=t_path["sharded_dp1_sp4"],
              sharded_u8_sp16_sigma50_ms_in_turns=t_gather["sharded"],
              blur_u8_sigma50_ms_in_turns=t_gather["single"], sharded_u8_parts_ms=t_parts),
        entry("fused_blur_f32_prepadded", "fused_blur.cu", "fused_blur.py:136",
              launched.get("blur_fused_f32", 0), t["k2"], t["k2_plain"], b_k2,
              max(errs["k2"], errs["k2_u8"]), t["k2_lib"], at=f"{shard}, sigma {SIGMA_SHARD_K2}",
              max_abs_err_u8=errs["k2_u8"], sharded_f32_ms_in_turns=t_float["sharded"],
              blur_f32_ms_in_turns=t_float["single"]),
        entry("fused_blur_axis_f32_prepadded", "fused_blur.cu", "fused_blur.py:136",
              launched.get("blur_fused_axis_f32", 0), t["axis"], t["axis_plain"], b_axis,
              errs["axis"], t["axis_lib"], at=f"{shard}, column r {r50}",
              launches_are="rows over the halo rows and pre-padded cols, one each a shard"),
        entry("fused_split_cols_int8_prepadded", "fused_split.cu", "fused_blur.py:218",
              launched.get("fused_split_cols_int8", 0), tp2["int8"], t["cols_int8_plain"],
              b_int8, errs["cols_int8"], None, at=f"{shard}, column r {re_}"),
        entry("fused_split_cols_hybrid_prepadded", "fused_split.cu", "fused_blur.py:282",
              launched.get("fused_split_cols_hybrid", 0), tp2["hybrid"],
              t["cols_hybrid_plain"], b_hyb, errs["cols_hybrid"], t["cols_lib"],
              at=f"{shard}, column r {re_}"),
    ]


# ---- phase 17: the probes B1-B3 (benchmarks/, the JAX package's last
# pallas_call sites), built into their own library while phases 2-16 run ----
PROBE_B3_SIGMA = 10.0  # K1's loaders at the tile k1_geometry picks for blur_u8 here


def _probe_build_start() -> tuple:
    """Start building the probes' library beside phase 1's build; the
    thread's failure is raised by ``_probe_build_wait``."""
    import threading

    from blur_algorithms_tpu_torch.utils import build

    failed: list = []

    def run():
        try:
            build.load_probe_library()
        except Exception as e:  # noqa: BLE001 - re-raised in phase 17
            failed.append(e)

    t = threading.Thread(target=run, name="probe-build")
    t.start()
    return t, failed


def _probe_build_wait(started: tuple) -> None:
    from blur_algorithms_tpu_torch.utils import build

    t0 = time.perf_counter()
    thread, failed = started
    thread.join()
    if failed:
        raise RuntimeError(f"the probes' library did not build: {failed[0]}") from failed[0]
    rec = build.last_probe_build
    print(f"phase 17 build: {rec['library']} (built now: {rec['built']}) in "
          f"{rec['seconds']:.2f} s beside phases 1-16, {time.perf_counter() - t0:.2f} s waited "
          f"here", flush=True)
    lines = _ptxas_lines(("mma_chain_kernel", "fft_ablation_kernel", "fetch_window_cp_async",
                          "fetch_window_tma", "fetch_k1_direct", "fetch_k1_assembled"),
                         rec["log"])
    for name, line in lines:
        print(f"phase 17 ptxas {name}: {line}", flush=True)
    # mask 0 is the production body: the same code as K3/K3f's kernels
    prod = dict(_ptxas_lines(("fft_conv_rows_kernel",)))
    twins = 0
    for name, line in lines:
        if name.startswith("fft_ablation_kernel") and name.endswith(", 0>"):
            twin = name.replace("fft_ablation_kernel", "fft_conv_rows_kernel")[:-4] + ">"
            print(f"phase 17 ptxas {name} == {twin}: {line == prod.get(twin)}", flush=True)
            if line != prod.get(twin):
                raise RuntimeError(f"{name} (mask 0) does not compile to {twin}: {line} against "
                                   f"{prod.get(twin)}")
            twins += 1
    if twins != 4:
        raise RuntimeError(f"the probes' build holds {twins} mask-0 kernels, not 4")


def _probe_wrappers() -> dict:
    """The probes' wrappers whose ``launches`` count, by kernels-line name;
    B1's and B3's count by path or form."""
    from blur_algorithms_tpu_torch.benchmarks import dma_fetch_rate as b3
    from blur_algorithms_tpu_torch.benchmarks import fft_mxu_ablation as b2
    from blur_algorithms_tpu_torch.benchmarks import mxu_dot_rate as b1

    return {**{f"mma_rate_{p}": (b1.chain, p) for p in b1.PATHS},
            "fft_ablation": (b2.conv_rows_ablation, None),
            **{f"fetch_rate_{f}": (b3.fetch_windows, f) for f in b3.fetch_windows.launches},
            **{f"fetch_rate_k1_{f}": (b3.fetch_k1, f) for f in b3.fetch_k1.launches}}


def _probe_counts(zero: bool = False) -> dict:
    """Each probe kernel's launches (set to 0 first with ``zero``)."""
    out = {}
    for name, (fn, key) in _probe_wrappers().items():
        if zero:
            if key is None:
                fn.launches = 0
            else:
                fn.launches[key] = 0
        out[name] = fn.launches if key is None else fn.launches[key]
    return out


def _run_probe(module, argv: list[str], what: str) -> list[dict]:
    """The probe's entry point as ``python -m`` runs it on the card (its
    ``main``), with its JSON lines captured, printed and returned."""
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    if rc:
        raise RuntimeError(f"{what} exited {rc}")
    recs = [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    print(f"phase 17 {what}: {len(recs)} records in {time.perf_counter() - t0:.1f} s", flush=True)
    if not recs:
        raise RuntimeError(f"{what} printed no record")
    return recs


def _b1_phase(dev) -> list[dict]:
    """B1: both paths against the plain chain at every shape and in the
    launches the rates time, the probe's entry point (the rates and the
    launches), and the kernels-line entries (one chained product of the
    cube)."""
    from blur_algorithms_tpu_torch.benchmarks import mxu_dot_rate as b1
    from blur_algorithms_tpu_torch.utils import timing

    errs = {p: 0.0 for p in b1.PATHS}

    def hold(got, want, a, rhs, dtype, path, what):
        diff = (got.double() - want.double()).abs()
        ok = (torch.equal(got, want) if dtype == "int8"
              else bool((diff <= b1.bf16_bound(a, rhs, want)).all()))
        errs[path] = max(errs[path], float(diff.max()))
        print(f"phase 17 B1 {path} vs plain: {what} "
              f"{'equal' if dtype == 'int8' else 'within bf16_bound'}={ok} "
              f"max_abs_err={float(diff.max()):.3e}", flush=True)
        if not ok:
            raise RuntimeError(f"B1 {path} disagrees with its plain version: {what}")

    for m, k, n, label in b1.SHAPES:
        for dtype in ("int8", "bf16"):
            a, b = (t.to(dev) for t in b1.operands(m, k, n, dtype, seed=17))
            inner, steps = (3, 2) if dtype == "int8" else (1, 1)
            want = b1.chain_ref(a, b, inner)
            for path in b1.PATHS:
                got = b1.chain(a, b, inner, steps, path=path)
                torch.cuda.synchronize()
                hold(got, want, a, b, dtype, path,
                     f"{dtype} m={m} k={k} n={n} inner={inner} steps={steps}")
    # the launches the rates time: filling the card, streamed and resident
    # (on the rhs the resident stages stand for), at the cube (n = k) and
    # the narrowest cols band (n < k; m and k padded)
    for m, k, n, label in (b1.SHAPES[0], b1.SHAPES[5]):
        for dtype in ("int8", "bf16"):
            a, b = (t.to(dev) for t in b1.operands(m, k, n, dtype, seed=18))
            inner = 3 if dtype == "int8" else 1
            for resident in (False, True):
                rhs = b1.resident_rhs(b) if resident else b
                want = b1.chain_ref(a, rhs, inner)
                for path in b1.PATHS:
                    got = b1.chain(a, b, inner, 2, path=path, resident=resident, copies=True)
                    torch.cuda.synchronize()
                    hold(got, want, a, rhs, dtype, path,
                         f"{dtype} m={m} k={k} n={n} inner={inner} steps=2, filling the card, "
                         f"{'resident' if resident else 'streamed'}")
    # the probe's path: its entry point, every count at 0 just before
    _probe_counts(zero=True)
    recs = _run_probe(b1, [], "B1 mxu_dot_rate.main()")
    launched = {p: b1.chain.launches[p] for p in b1.PATHS}
    print(f"phase 17 B1 path launches: {launched}", flush=True)
    if min(launched.values()) < 1:
        raise RuntimeError(f"B1's entry point did not launch both paths: {launched}")
    tops = {(r["dtype"], r["label"], r["path"] + ("_resident" if r["resident"] else "")):
            r["tops"] for r in recs}
    rates = []
    for dtype in ("int8", "bf16"):
        for m, k, n, label in b1.SHAPES:
            a, b = (t.to(dev) for t in b1.operands(m, k, n, dtype))
            lib = ((lambda a=a, b=b: torch._int_mm(a, b)) if dtype == "int8"
                   else (lambda a=a, b=b: a @ b))
            t_lib = timing.time_cuda(lib, iters=10, warmup=2).median_ms
            row = {"dtype": dtype, "shape": [m, k, n], "label": label,
                   "library_tops": 2 * m * k * n / t_lib / 1e9}
            for path in b1.PATHS:
                for resident in ("", "_resident"):
                    row[f"{path}{resident}_tops"] = tops[dtype, label, path + resident]
            rates.append(row)
            peak = b1.PEAK_OPS[dtype] / 1e12
            print(f"phase 17 B1 rate {dtype} {label} (m={m} k={k} n={n}), TOP/s and share of "
                  f"the published {peak:.0f}: " + "; ".join(
                      f"{key[:-5]} {v:.1f} ({v / peak:.1%})" for key, v in row.items()
                      if key.endswith("_tops")), flush=True)
    print("phase 17 B1 rates " + json.dumps(rates), flush=True)

    m, k, n, label = b1.SHAPES[0]
    a, b = (t.to(dev) for t in b1.operands(m, k, n, "int8"))
    t_plain = _time(b1.chain_ref, a, b, 1, name="B1 plain version (cube, one product)")
    t_lib = _time(torch._int_mm, a, b, name="B1 yardstick torch._int_mm (cube)")
    bound = _bound_ms(m * k + k * n + 4 * m * k, 2 * m * k * n, INT8_OP_PER_S)
    out = []
    for path in b1.PATHS:
        launch = b1.prepare(a, b, 1, path=path, copies=False)  # operands laid out once
        t = _time(launch, name=f"B1 {path} (cube, one product, a block a panel)")
        for res in (t, t_plain, t_lib):
            print(f"phase 17 time: {res}", flush=True)
        out.append({
            "name": f"mma_rate_{path}", "route": "cuda",
            "source": "blur_algorithms_tpu_torch/csrc/probes/mma_rate.cu",
            "replaces": "benchmarks/mxu_dot_rate.py:61", "launches": launched[path],
            "max_abs_err": errs[path], "ms": t.median_ms, "plain_ms": t_plain.median_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": t_lib.median_ms,
            "at": f"int8 {m}x{k}x{n}, one product, one block a 64-row panel",
            "rates_tops": {f"{r['dtype']} {r['label']}": r[f"{path}_tops"] for r in rates},
            "resident_rates_tops": {f"{r['dtype']} {r['label']}": r[f"{path}_resident_tops"]
                                    for r in rates}})
    return out


def _b2_phase(dev) -> dict:
    """B2: full against K3's and K3f's production kernels at every cell,
    then the probe's entry point (ms per mode) at the JAX probe's default
    and at the 4K cells; the kernels-line entry at the default."""
    from blur_algorithms_tpu_torch.benchmarks import fft_mxu_ablation as b2
    from blur_algorithms_tpu_torch.cuda_kernels import fft4step
    from blur_algorithms_tpu_torch.ops.fft_mxu import _conv_rows_einsum

    gen = torch.Generator(device=dev).manual_seed(17)
    err, entry = 0.0, None
    for label, nrows, n, ax, framed in [b2.jax_default(), *b2.cells()]:
        x = torch.randn((nrows, ax.dim if framed else n), generator=gen, device=dev)
        prod = (fft4step.fft_conv_rows_framed if framed else fft4step.fft_conv_rows)(x, n, ax)
        full = b2.conv_rows_ablation(x, n, ax, "full", framed)
        torch.cuda.synchronize()
        equal = torch.equal(full, prod)
        err = max(err, float((full - prod).abs().max()))
        print(f"phase 17 B2 full vs {'K3f' if framed else 'K3'}: {label}, {nrows} rows, n={n}: "
              f"equal={equal}", flush=True)
        if not equal:
            raise RuntimeError(f"B2's full mode differs from the production kernel at {label}")
        del full, prod
        if entry is None:  # the JAX probe's default cell
            t_plain = _time(_conv_rows_einsum, x, n, ax, name="B2 plain version (K3's)")
            rows, lib = _fft_yardstick(x, ax, n, False)
            t_lib = _time(lib, rows, name="B2 yardstick cuFFT rfft -> multiply -> irfft")
            nbytes, ops = _fft_work(nrows, n, 4 * n, not ax.symmetric)
            bound = _bound_ms(nbytes, ops, F32_FLOP_PER_S)
            entry = {"name": "fft_ablation", "route": "cuda",
                     "source": "blur_algorithms_tpu_torch/csrc/probes/fft_ablation.cu",
                     "replaces": "benchmarks/fft_mxu_ablation.py:125",
                     "plain_ms": t_plain.median_ms, "bound_ms": bound[0], "bound_by": bound[1],
                     "library_ms": t_lib.median_ms, "at": f"{label} (mode full)"}
            del rows
        del x
        torch.cuda.empty_cache()
    # the probe's path: its entry point at its default and at the cells,
    # every count at 0 just before
    _probe_counts(zero=True)
    recs = (_run_probe(b2, [], "B2 fft_mxu_ablation.main()")
            + _run_probe(b2, ["--cells"], "B2 fft_mxu_ablation.main(--cells)"))
    launched = b2.conv_rows_ablation.launches
    print(f"phase 17 B2 path launches: {launched}", flush=True)
    if launched < 1:
        raise RuntimeError("B2's entry point launched no kernel")
    table: dict = {}
    for r in recs:
        if r["ms"] is not None:
            table.setdefault(r["cell"], {})[r["mode"]] = r["ms"]
    for label, row in table.items():
        print(f"phase 17 B2 {label}: " + "; ".join(
            f"{mode} {ms:.4f} ms ({ms - row['full']:+.4f})" for mode, ms in row.items())
            + f"; 1dot: {b2.ONE_DOT}", flush=True)
    print("phase 17 B2 modes " + json.dumps(table), flush=True)
    default = b2.jax_default()[0]
    return {**entry, "launches": launched, "max_abs_err": err, "ms": table[default]["full"],
            "modes_ms": table}


def _b3_phase(dev) -> list[dict]:
    """B3: every loader's store against its plain version, then GB/s and the
    read amplification; one kernels-line entry a loader."""
    from blur_algorithms_tpu_torch import make_plan
    from blur_algorithms_tpu_torch.benchmarks import dma_fetch_rate as b3
    from blur_algorithms_tpu_torch.cuda_kernels.assemble import assemble_padded

    rng = np.random.default_rng(17)
    frame = torch.from_numpy(rng.integers(0, 256, (b3.BC, b3.HP, b3.WP), dtype=np.uint8)).to(dev)
    planar = torch.from_numpy(rng.integers(0, 256, (BATCH * 3, H, W), dtype=np.uint8)).to(dev)
    plan = make_plan((H, W), PROBE_B3_SIGMA)
    jobs = [("windowed", "cp.async", lambda: b3.fetch_windows(frame),
             lambda: b3.fetch_windows_ref(frame), b3.window_bytes(), frame),
            ("windowed_tma", "TMA", lambda: b3.fetch_windows(frame, tma=True),
             lambda: b3.fetch_windows_ref(frame), b3.window_bytes(), frame),
            ("strip", "cp.async", lambda: b3.fetch_windows(frame, strip=True),
             lambda: b3.fetch_windows_ref(frame, True), b3.window_bytes(b3.WP, 1, rows=b3.HP),
             frame)]
    for form in ("direct", "assembled"):
        lo = b3.k1_loader(plan, form, dev)
        padded = (assemble_padded(planar, lo.rh, lo.rw, lo.rh, lo.rw, lo.xh, lo.xw)
                  if lo.slots else None)
        jobs.append((f"k1_{form}", f"K1 {form} th={lo.th} tw={lo.tw} smem={lo.smem}",
                     lambda lo=lo, padded=padded: b3.fetch_k1(planar, lo, padded),
                     lambda lo=lo, padded=padded: b3.fetch_k1_ref(planar, lo, padded),
                     b3.k1_bytes(H, W, lo, BATCH * 3), planar))
    checked = {}
    for name, how, fn, ref, fetched, src in jobs:
        got, want = fn(), ref()
        torch.cuda.synchronize()
        checked[name] = int((got.int() - want.int()).abs().max())
        if not torch.equal(got, want):
            raise RuntimeError(f"B3 {name} stores differ from their plain version")
    # the probe's path: its entry point, every count at 0 just before
    _probe_counts(zero=True)
    _run_probe(b3, [], "B3 dma_fetch_rate.main()")
    launched = {name: n for name, n in _probe_counts().items() if name.startswith("fetch_rate")}
    print(f"phase 17 B3 path launches: {launched}", flush=True)
    if min(launched.values()) < 1:
        raise RuntimeError(f"B3's entry point did not launch every loader: {launched}")
    out = []
    for name, how, fn, ref, fetched, src in jobs:
        t = _time(fn, name=f"B3 {name} ({how})")
        t_plain = _time(ref, name=f"B3 {name} plain version")
        dst = torch.empty_like(src)
        t_lib = _time(dst.copy_, src, name="B3 yardstick copy_ of the frame")
        del dst
        bound = _bound_ms(src.numel() + 1024 * src.shape[0], 0, INT8_OP_PER_S)
        ms = t.median_ms
        print(f"phase 17 B3 {name} ({how}): equal to plain=True; {ms:.4f} ms, fetched "
              f"{fetched / 1e6:.1f} MB at {fetched / ms / 1e6:.1f} GB/s "
              f"({fetched / (ms * 1e-3) / HBM_BYTES_PER_S:.1%} of 3.35 TB/s), "
              f"frame {src.numel() / 1e6:.1f} MB at {src.numel() / ms / 1e6:.1f} GB/s, read "
              f"amplification {fetched / src.numel():.3f}; copy_ of the frame "
              f"{t_lib.median_ms:.4f} ms; bound {bound[0]:.4f} ms", flush=True)
        out.append({"name": f"fetch_rate_{name}", "route": "cuda",
                    "source": "blur_algorithms_tpu_torch/csrc/probes/fetch_rate.cu",
                    "replaces": "benchmarks/dma_fetch_rate.py:73" if name != "strip"
                    else "benchmarks/dma_fetch_rate.py:85",
                    "launches": launched[f"fetch_rate_{name}"],
                    "max_abs_err": checked[name], "ms": ms, "plain_ms": t_plain.median_ms,
                    "bound_ms": bound[0], "bound_by": bound[1], "library_ms": t_lib.median_ms,
                    "fetched_gbps": fetched / ms / 1e6, "frame_gbps": src.numel() / ms / 1e6,
                    "read_amplification": fetched / src.numel(), "loader": how})
    return out


def _slice11(probe_build) -> list[dict]:
    """Phase 17: the probes B1-B3 on the card; returns their kernels-line
    entries, each probe's launches counted over its entry point's run (no
    route of the blur runs a probe: main checks that its counts stay 0 over
    phases 3-16)."""
    t0 = time.perf_counter()
    _probe_build_wait(probe_build)
    dev = torch.device("cuda")
    entries = [*_b1_phase(dev), _b2_phase(dev), *_b3_phase(dev)]
    print(f"phase 17: {time.perf_counter() - t0:.1f} s", flush=True)
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")

    from blur_algorithms_tpu_torch import blur_u8, make_plan, oracle
    from blur_algorithms_tpu_torch.api import _u8_dma_precision
    from blur_algorithms_tpu_torch.cuda_kernels import fused_blur, fused_dma
    from blur_algorithms_tpu_torch.utils import build, timing
    from blur_algorithms_tpu_torch.utils.frames import make_frames
    from blur_algorithms_tpu_torch.utils.hw import device_spec

    # ---- phase 1: the card, then the kernel build ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    probe_build = _probe_build_start()  # phase 17's library, beside this one
    build.load_library()
    ptxas = [ln.strip() for ln in build.last_build["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"phase 1 build: {build.last_build['library']} "
          f"(built now: {build.last_build['built']}) in "
          f"{time.perf_counter() - t0:.2f} s; ptxas: {' | '.join(ptxas)}",
          flush=True)
    _k2_sass()

    # ---- phase 2: K1 against its plain version on the card ----
    cases = [((1080, 1920), s) for s in (1.0, 3.0, 10.0, 50.0, 150.0, 180.0)]
    cases += [((1080, 1920), (5.0, 11.0)), ((1001, 1777), SIGMA)]
    max_err = 0
    for k, ((h, w), sigma) in enumerate(cases):
        plan = make_plan((h, w), sigma)
        x = _case_frames(h, w, seed=k)
        got = fused_dma.blur_fused_u8_dma(x, plan, direct=True)
        want = fused_dma.blur_fused_u8_dma_ref(x, plan)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        max_err = max(max_err, err)
        equal = torch.equal(got, want)
        print(f"phase 2 K1 vs plain: {h}x{w} RGB sigma={sigma} "
              f"r=({plan.col.support_radius}, {plan.row.support_radius}) "
              f"equal={equal} max_abs_err={err}", flush=True)
        if not equal:
            raise RuntimeError(f"K1 disagrees with its plain version at {(h, w, sigma)}")
    _k1_sass()

    # ---- phase 3: the main path at bench.py's size ----
    _probe_counts(zero=True)  # read before phase 17: no route runs a probe
    frames = make_frames(BATCH, H, W)  # (B, C, H, W) uint8
    img = np.ascontiguousarray(np.moveaxis(frames, 1, -1))
    x = torch.from_numpy(img).cuda()
    plan = make_plan((H, W), SIGMA)
    planar = x.movedim(-1, -3).contiguous()
    want0 = oracle.blur_u8(img[0], SIGMA)
    rung = _u8_dma_precision(plan, device_spec(x.device))
    bodies = _k1_bodies()
    # K1 on the rung AUTO routes, through AUTO where K1 serves sigma 10, or
    # through that rung's pin where the card's split radius covers sigma 10's
    # r 32 (AUTO's split is checked after); where the rung is not int8, the
    # int8 pin is K1 int8's path
    split_at_sigma = fused_blur._split_wins(plan, 1, "int8", x.device)
    launched = {}
    for prec in dict.fromkeys((rung, "int8")):
        body, ref_fn = bodies[prec]
        torch.cuda.synchronize()
        for c in (*(b for b, _ in bodies.values()), fused_blur.blur_fused_f32):
            c.launches = 0
        auto = prec == rung and not split_at_sigma
        out = blur_u8(x, SIGMA) if auto else blur_u8(x, SIGMA, precision=prec)
        torch.cuda.synchronize()
        launched[prec] = body.launches
        others = {b.__name__: b.launches for b, _ in bodies.values() if b is not body}
        if body.launches < 1 or any(others.values()) or fused_blur.blur_fused_f32.launches:
            raise RuntimeError(f"blur_u8 ({prec}) launched {body.__name__} {body.launches} "
                               f"times, the others {others}, K2 "
                               f"{fused_blur.blur_fused_f32.launches}")
        if out.shape != x.shape or out.dtype != torch.uint8 or out.device != x.device:
            raise RuntimeError(f"blur_u8 returned {out.shape} {out.dtype} {out.device}")
        ref = ref_fn(planar, plan).movedim(-3, -1)
        torch.cuda.synchronize()
        err = int((out.int() - ref.int()).abs().max())
        if prec == "int8":
            max_err = max(max_err, err)
        # int8 and bf16 bit-equal to the plain version; hybrid (tensor-core
        # groups of 16 taps against tap-by-tap sums) within 1 count
        if not (err <= 1 if prec == "hybrid" else torch.equal(out, ref)):
            raise RuntimeError(f"blur_u8 ({prec}) differs from the plain version by {err}")
        d = np.abs(out[0].cpu().numpy().astype(int) - want0.astype(int))
        what = "AUTO" if auto else f"precision='{prec}'"
        print(f"phase 3 main path: blur_u8 {what} {tuple(x.shape)} sigma={SIGMA}: rung {prec}, "
              f"{body.__name__} launches={body.launches}, vs plain version max_abs_err={err} "
              f"({'limit 1' if prec == 'hybrid' else 'equal'}), "
              f"frame 0 vs oracle max={int(d.max())} exact={float((d == 0).mean())}",
              flush=True)
        if d.max() > 1:
            raise RuntimeError(f"frame 0 is {int(d.max())} counts from the oracle")
        del out, ref
    launches = launched["int8"]
    if split_at_sigma:  # AUTO at sigma 10: the split, its pass 2 as the card routes it
        from blur_algorithms_tpu_torch.cuda_kernels import fused_split

        pass2 = _pass2(plan, x.device)
        split = (fused_split.fused_split_rows_int8, fused_split.fused_split_cols_hybrid,
                 fused_split.fused_split_cols_int8)
        torch.cuda.synchronize()
        for c in (*(b for b, _ in bodies.values()), fused_blur.blur_fused_f32, *split):
            c.launches = 0
        out = blur_u8(x, SIGMA)
        torch.cuda.synchronize()
        ran = {c.__name__: c.launches for c in (*(b for b, _ in bodies.values()),
                                                fused_blur.blur_fused_f32, *split)}
        d = np.abs(out[0].cpu().numpy().astype(int) - want0.astype(int))
        print(f"phase 3 main path: blur_u8 AUTO {tuple(x.shape)} sigma={SIGMA} (r "
              f"{plan.row.support_radius}, from the card's split radius "
              f"{device_spec(x.device).fused_split_min_radius}): launches {ran}; frame 0 vs "
              f"oracle max={int(d.max())} exact={float((d == 0).mean())}", flush=True)
        if ({k: v for k, v in ran.items() if v} != {"fused_split_rows_int8": 1, pass2: 1}
                or out.shape != x.shape or out.dtype != torch.uint8 or d.max() > 1):
            raise RuntimeError(f"blur_u8 AUTO at sigma {SIGMA} did not run the split's two "
                               f"passes alone within 1 count: {ran}")
        del out

    # ---- phase 4: times ----
    mp = BATCH * H * W / 1e6
    k1 = timing.time_cuda(lambda t, p: fused_dma.blur_fused_u8_dma(t, p, direct=True),
                          planar, plan, iters=ITERS, name="K1 fused_dma int8",
                          megapixels=mp)
    plain = timing.time_cuda(fused_dma.blur_fused_u8_dma_ref, planar, plan,
                             iters=ITERS, name="plain version", megapixels=mp)
    whole = timing.time_cuda(blur_u8, x, SIGMA, iters=ITERS,
                             name="blur_u8 AUTO (with layout copies)", megapixels=mp)
    for res in (k1, plain, whole):
        print(f"phase 4 time: {res}", flush=True)

    k2 = _slice2(frames, make_plan, oracle, fused_blur, fused_dma, timing)
    fft_kernels = _slice3(frames)
    slice4_kernels, split_launched = _slice4(frames)
    auto_launched = {bodies[p][0].__name__: n for p, n in launched.items() if p != "int8"}
    slice5_kernels = _slice5(frames, k1.median_ms, {**split_launched, **auto_launched})
    slice6_kernels = _slice6(frames)
    slice7_kernels = _slice7(frames, want0)
    on_blur = _probe_counts()  # set to 0 before phase 3
    print(f"phase 17 probe launches over the blur's paths (phases 3-16): {on_blur}", flush=True)
    if any(on_blur.values()):
        raise RuntimeError(f"a route of the blur launched a probe's kernel: {on_blur}")
    slice11_kernels = _slice11(probe_build)

    outputs = BATCH * 3 * H * W
    taps = 2 * plan.col.support_radius + 1 + 2 * plan.row.support_radius + 1
    # K1: 1 byte in and out per pixel; exact int8 products: 2 digit
    # products per rows tap, 4 per cols tap, 2 operations each
    k1_bound, k1_by = _bound_ms(
        2 * outputs,
        2 * outputs * (2 * (2 * plan.row.support_radius + 1)
                       + 4 * (2 * plan.col.support_radius + 1)),
        INT8_OP_PER_S,
    )
    print(f"phase 7 bounds: K1 {k1_bound:.4f} ms ({k1_by}), "
          f"K2 {k2['bound_ms']:.4f} ms ({k2['bound_by']}); "
          f"{outputs} outputs, {taps} taps per output", flush=True)
    print(json.dumps({"kernels": [{
        "name": "fused_dma_int8",
        "route": "cuda",
        "source": "blur_algorithms_tpu_torch/csrc/fused_dma.cu",
        "replaces": "blur_algorithms_tpu/pallas_kernels/fused_dma.py:1023",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k1.median_ms,
        "plain_ms": plain.median_ms,
        "bound_ms": k1_bound,
        "bound_by": k1_by,
        "library_ms": None,
    }, k2, *fft_kernels, *slice4_kernels, *slice5_kernels, *slice6_kernels,
        *slice7_kernels, *slice11_kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
