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
   on a 2160x15360 panorama at sigma 250 (r 831, under the card's uint8
   crossover) runs the split, three full-height patches of 512 columns within 1 count of
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
14. K1's hybrid and bf16 bodies against their plain versions as phase 2
   (the hybrid within 2e-2 / 1 count; bf16, on the tensor cores since this
   slice, within ``fused_dma.bf16_bound`` on the f32 store and 1 count on
   the uint8 store, printing how many outputs pass the simpler 2e-2 + max
   |c| and the SASS count of HMMA and FFMA in its instantiations, phase 2)
   and the split's hybrid pass 2 at column radius
   332, 831 and 1996, uint8 and f32 out (within 2e-2, 1 count, printing
   the worst difference and the share that differs); at batch 4 RGB 4K sigma 10,
   ``blur_u8(precision="hybrid")`` and ``blur_u8`` AUTO on the card's spec
   with bf16 routed in place of hybrid and no split radius (counts set to 0 first: that body
   alone, within 1 count of its plain version, frame 0 within 1 count);
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
   variant, rows-resident K1r) against K1 direct (``torch.equal``) and the
   body's plain version (``torch.equal``; hybrid within 2e-2 / 1 count,
   bf16 within ``bf16_bound`` / 1 count), on phase 2's cases for every rung each serves
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
   A4 at column radius 1, 32, 332 and 598 and on the timed shard's row
   segments in three layouts (the top and bottom shards of dp 2 x sp 2 and
   an interior block, as ``HaloedRows`` views), K1a on A4's frame (int8, hybrid
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
   x sp 2 shard at sigma 9 (K2 pre-padded at 5; A4 per call and as CUDA
   graph replays in turns with the parent's launch, A5's kernel with no row
   border), the plain versions, the ``F.pad`` and ``conv2d``
   yardsticks, the sharded calls against the single-card ones in turns,
   and ``blur_sharded_u8``'s time in parts (the cut, the halo exchange
   and the steps each in turns with the parent's copies: the cut copied,
   the halos concatenated, the steps on one buffer a shard);
17. the probes B1-B3 (the JAX package's ``benchmarks/`` kernels; their
   library, ``csrc/probes/``, built beside phase 1's, its ptxas lines
   printed here, each mask-0 ablation kernel held to its K3/K3f twin's
   registers and spills, and the SASS count of HGMMA / IGMMA, UTMALDG and
   HMMA / IMMA in B1's instantiations): B1's chain
   (``benchmarks.mxu_dot_rate``, one 64-row panel a thread-block cluster;
   one chain a CTA a tile, the launch filling the card clusters of one CTA
   on every tile of its panel)
   by ``mma.sync`` and by ``wgmma`` ``torch.equal`` to its plain version at
   the nine shapes in int8 (``inner`` 3, ``steps`` 2) and within
   ``bf16_bound`` in bf16 (``inner`` 1), streamed and resident (against the
   plain chain on ``resident_rhs``), one chain and the launch filling the
   card (what the rates time); one product of the cube on one chain on
   each path, its cluster size and grid, beside ``torch._int_mm`` (also
   as CUDA graph replays); B2 (``fft_mxu_ablation``): ``full``
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
   before phase 17;
18. K3 and K3f's cluster form (n 32768, 65536, 131072: a thread-block
   cluster of n / cluster_segment(n) CTAs a pair of rows) against the plain version,
   symmetric and asymmetric taps, odd row counts, within 2e-2 at 0..255
   scale, with ptxas's registers and spills (PR 16's design of it too, the
   yardstick in the probes' library) and ``cudaOccupancyMaxActiveClusters``
   for each C; then, counts set to 0 before
   each call (launches and ``cluster_launches``): ``blur`` AUTO forward +
   backward on the (4, 3, 2160, 15360) panorama at sigma 400 (K3f's
   cluster form on the rows forward, K3's in the adjoint; ``x.grad`` equal
   to ``blur_adjoint(g)``, the adjoint identity to 1e-5 relative);
   ``blur_u8(engine="fft_mxu")`` on one 24000x14500 RGB frame (made on the
   card, ``utils/frames.make_frames_on``) at sigma 900 (K3f's cluster form
   on both axes, within 1 count of ``"fft_tiles"``); ``blur_u8`` AUTO on 4
   such frames at sigma 1500 (r 4992: past the split's reach and FFT_MXU's
   byte budget, so the MXU streamer, one K3f launch a strip at n 32768 and
   65536, never the whole-frame path; frame 0 within 1 count of the
   single-frame ``"fft_mxu"``) and ``"fft_stream"`` on one frame against
   ``"fft_tiles"``; times (CUDA events, median of 5): K3's cluster form on
   the panorama's adjoint rows, K3f's on the giant frame's 72000 rows of
   14500 (n 32768) and on one streamed column strip (12288 rows of 24000,
   n 65536: clusters of 8) beside their plain versions, bounds and cuFFT, each also
   in turns with PR 16's design of the cluster form (median of 20 a turn),
   the three calls, and AUTO against ``"fused"`` on the sigma 900 frame;
19. the front end on 4K frames (frame 0 of ``make_frames`` as a 2160x3840
   PPM), counts set to 0 first: the CLI (``cli.main``, as ``python -m
   blur_algorithms_tpu_torch`` runs it) with ``auto 10`` (K1), ``4 6``
   (the box, K4), ``deriche 40`` (K2's single-axis form on its 511-tap
   bands) and ``1 10`` (conv, cuDNN), each output file within 1 count of
   ``oracle.blur_u8`` or the box oracle; ``BlurPipeline.stream`` over four
   PPM paths of 2160x3840, 1997x3001, 1080x1920 and 720x1280 (bucketed,
   padded on the host, copied from page-locked memory on a side stream),
   twice, each output ``torch.equal`` to the exact-shape ``blur_u8`` where
   both shapes route alike, frames/s and buckets; the HTTP server
   (``examples/serve.py``, ``serve(port=0)`` warmed up at 4K) answering 8
   POSTs of the PPM at sigma 10 from 2 client threads, a box request and a
   Deriche request, each within 1 count of its oracle, with the p50 / max
   request ms and ``/healthz``; ``unsharp_mask`` on the 4 RGB 4K frames at
   sigma 2 and ``channel_smooth`` rgb (5, 5, 7) against K2's plain version
   on the card, within 1 count. K1, K2, K2's single-axis form and K4 must
   each have launched over the phase;
20. K3 and K3f past transform length 131072: the wide cluster form at n
   262144 (persistent clusters of 16 CTAs, a non-portable size: a radix-16
   pass over stride 16384 into the segments over distributed shared
   memory, the one-block body on each, the adjoint pass back; one read and
   one write of the rows, no scratch) and the staged form past it (first
   passes over the segments of 16384 through a scratch buffer in device
   memory, the segments through the one-block body, the passes' adjoints)
   against the plain version at n 262144, 524288 and 1048576 (the staged
   form's one first-pass digit of 32, two of 8), symmetric and asymmetric
   taps, odd row counts, within 2e-2 at 0..255 scale (beside a float64
   ``torch.fft`` correlation at 1048576), each form past 2^31 elements,
   with ptxas's registers and spills and the clusters the card places at
   once at n 32768, 65536, 131072 and 262144
   (``cudaOccupancyMaxActiveClusters``); n 262144 also as a card that
   places no cluster of 16 runs it (the occupancy patched to 0, so
   ``fft4step._form`` routes it to the staged form before the launch),
   against the plain version and the wide form on the same rows (a card
   that places none runs the staged form on every path below, says so,
   and checks the wide form nowhere); then, counts set to
   0 before each call (launches, ``cluster_launches``, ``staged_launches``):
   ``blur_u8`` AUTO on one 2160x140000 RGB frame at sigma 900 (whole-frame
   FFT_MXU under its byte budget: K3f's wide form on the rows at n 262144,
   the one-block K3f on the columns; within 1 count of ``"fft_tiles"``),
   timed beside ``"fused"``; AUTO on 4 such frames (the MXU streamer: one
   cluster launch a row strip, never the whole-frame path; frame 0 within 1
   count of the single-frame call); ``blur`` AUTO forward + backward on (1,
   3, 2160, 131072) f32 at sigma 400 (K3f's wide form on the rows forward,
   K3's on the adjoint's rows) and on one 1400x262000 plane (the staged
   form: K3f on the rows forward, K3 on the adjoint's rows, both n
   524288); ``x.grad`` equal to ``blur_adjoint(g)``, the adjoint identity
   to 1e-5 relative; times (CUDA events, median of 5 for the calls; the
   kernels as phase 10) of K3f's wide form on the frame's 6480 rows and
   K3's on the adjoint's rows, each also in turns with the copying staged form
   there (B2's ``staged_yardstick``), and of the staged form on the 1400
   rows, beside their plain versions, the bytes bound and cuFFT. The staged
   route at n 262144 (the occupancy patched to 0) drives ``blur_u8`` AUTO on
   the frame and on the 4 frames (the streamer), and ``blur`` forward +
   backward on the f32 batch, each with the staged form's launches alone at
   262144 and within 1 count (uint8) or 2e-2 of the wide form's output;
   K3f on the frame's rows, K3 on the adjoint's rows, the ``blur_u8`` call
   and the ``blur`` call are timed in turns with the wide form.

The line before the last is a JSON object describing each kernel; the last
is ``{"ok": true, "device": {...}}``. Run from the repository root:

    python3 chip_smoke.py

It exits non-zero, printing no result, where no CUDA device is available.
"""

from __future__ import annotations

import contextlib
import ctypes
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
# phase 12: a panorama AUTO keeps on the split at sigma 250 (r 831, under the
# card's uint8 crossover; FFT_MXU would take K3f's cluster form, n 32768);
# phase 18: its float backward
PANO_H, PANO_W = 2160, 15360
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


def _kernel_times(entry, rows, n, axis_plan, framed: bool, label: str,
                  phase: int = 10) -> dict:
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
        print(f"phase {phase} time: {res}", flush=True)
    nbytes, ops = _fft_work(rows.shape[0], n, 4 * rows.shape[1], not axis_plan.symmetric)
    bound, by = _bound_ms(nbytes, ops, F32_FLOP_PER_S)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"phase {phase} {label}: {rows.shape[0]} rows x {rows.shape[1]}, n={n}, "
          f"vs plain max_abs_err={err:.3e}; bound {bound:.4f} ms ({by}: "
          f"{nbytes / 1e9:.3f} GB, {bytes_ms:.4f} ms of bytes; {ops / 1e9:.2f} GFLOP)",
          flush=True)
    return {"ms": t_k.median_ms, "plain_ms": t_p.median_ms, "library_ms": t_l.median_ms,
            "bound_ms": bound, "bound_by": by, "err": err, "bytes": nbytes, "ops": ops,
            "bytes_ms": bytes_ms}


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


SASS_OPS = ("IMMA", "HMMA", "IDP4A", "FFMA", "HGMMA", "IGMMA", "UTMALDG")


def _sass_counts(kernels, library: str | None = None) -> dict[str, dict[str, int]]:
    """Instruction counts of ``SASS_OPS`` in the kernel library's SASS
    (``cuobjdump -sass``; the probes' ``library`` where given), per entry
    function whose name holds one of ``kernels``, keyed as ``_ptxas_lines``
    keys them (name<template arguments>): what shows whether a body runs on
    the tensor cores (IMMA, HMMA; HGMMA, IGMMA for wgmma) or on ``__dp4a``
    (IDP.4A), and whether it loads by TMA (UTMALDG)."""
    import shutil

    from blur_algorithms_tpu_torch.utils import build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", library or build.last_build["library"]],
                          capture_output=True, text=True, check=True, timeout=300).stdout
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
    """Phase 2: K1's instantiations on the tensor cores, from the built
    library's SASS: IMMA in every int8 and hybrid one (the rows pass, and
    the int8 cols pass), HMMA in the hybrid ones (its cols pass), HMMA and
    no IMMA in the bf16 ones (both passes; their FFMA count printed: the
    products are HMMA, so fewer FFMA than HMMA), no IDP4A (the per-lane
    dp4a the bodies ran before); with ptxas's registers and spills."""
    sass = _sass_counts(K1_TC_KERNELS)
    ptx = dict(_ptxas_lines(K1_TC_KERNELS))
    for name, c in sass.items():
        body = {"0": "int8", "1": "hybrid", "2": "bf16"}[name.split("<")[1][0]]
        print(f"phase 2 SASS {name} ({body}): IMMA {c['IMMA']}, HMMA {c['HMMA']}, FFMA "
              f"{c['FFMA']}, IDP4A {c['IDP4A']}; ptxas {ptx.get(name, 'not reported')}",
              flush=True)
        if body == "bf16":
            on_tc = c["HMMA"] and not c["IMMA"] and c["FFMA"] < c["HMMA"]
        else:
            on_tc = c["IMMA"] and (body == "int8" or c["HMMA"])
        if c["IDP4A"] or not on_tc:
            raise RuntimeError(f"{name} ({body}) is not on the tensor cores: {c}")
    if len(sass) != 24:  # 3 forms x 3 bodies x 2 stores, K1r's 2 x 2, int8's pipelined 2
        raise RuntimeError(f"the SASS holds {len(sass)} K1 tensor-core instantiations, not "
                           f"24: {sorted(sass)}")


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


def _graph(fn, calls: int = 1):
    """``calls`` calls of ``fn`` captured in one CUDA graph: its replay, the
    device's time with no host work between launches. The replay holds
    ``fn`` and the tensors it reads (entering a capture empties the
    allocator's cache)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return lambda graph=graph, fn=fn: graph.replay()


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
                errs[rung] = max(errs[rung], _check_bf16(label, got, ref, out_u8, x, plan))
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


def _check_bf16(label: str, got: torch.Tensor, ref: torch.Tensor, out_u8: bool, x, plan,
                bound: torch.Tensor | None = None) -> float:
    """K1's bf16 body on the tensor cores against its plain version: within
    ``fused_dma.bf16_bound`` (``bound`` where given: K1a's on a frame) on
    the f32 store, 1 count on the uint8 store; prints the worst difference,
    its share of the bound, and how many outputs lie past the simpler bound
    2e-2 + max |c_col| (one rows value near a rounding boundary at most);
    returns the worst difference."""
    from blur_algorithms_tpu_torch.cuda_kernels import fused_dma

    torch.cuda.synchronize()
    d = (got.double() - ref.double()).abs()
    err = float(d.max())
    if out_u8:
        held, how = err <= 1, "limit 1"
    else:
        bound = fused_dma.bf16_bound(x, plan) if bound is None else bound
        simple = fused_dma.COLS_TOL + float(np.abs(fused_dma.bf16_operands(plan).c_col).max())
        held = bool((d <= bound).all())
        how = (f"worst share of bf16_bound {float((d / bound).max()):.3f}, outputs past "
               f"2e-2 + max|c| ({simple:.4f}): {int((d > simple).sum())} of {d.numel()}")
        del bound
    print(f"{label} {'uint8' if out_u8 else 'f32'} out max_abs_err={err:.3e} ({how}), share "
          f"differing={float((d > 0).double().mean()):.3e}: held={held}", flush=True)
    if got.shape != ref.shape or got.dtype != ref.dtype or not held:
        raise RuntimeError(f"K1's bf16 body disagrees with its plain version: {label}")
    return err


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
        # both on tensor-core groups of 16 taps: within 1 count of the plain
        # version's tap-by-tap sums
        held = err <= 1
        d = np.abs(out[0].cpu().numpy().astype(int) - want0.astype(int))
        print(f"phase 14 main path: {what} {tuple(x.shape)} "
              f"sigma={SIGMA}: launches {ran}; vs plain version max_abs_err={err} "
              f"(limit 1: {held}); frame 0 vs oracle "
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
        bound = fused_dma.bf16_bound(x, plan)
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
                    # every form bit-equal to K1 direct; int8 to the plain
                    # version too, hybrid (tensor-core groups of 16 taps)
                    # within HYBRID_TOL / 1 count of it, bf16 within
                    # bf16_bound / 1 count
                    if rung == "int8":
                        near = torch.equal(got, want)
                    elif rung == "hybrid" or out_u8:
                        near = err <= (1 if out_u8 else HYBRID_TOL)
                    else:
                        near = bool(((got.double() - want.double()).abs() <= bound).all())
                    if not (near and torch.equal(got, direct)):
                        raise RuntimeError(f"K1 {form} {rung} differs from K1 direct or its "
                                           f"plain version at {(h, w, sigma)} by {err}")
                    served.append(form)
                print(f"phase 15 forms vs K1 direct (equal) and plain "
                      f"({'equal' if rung == 'int8' else 'within tolerance'}): {h}x{w} RGB "
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
                # 1 count of the plain version; bf16 within its bound / 1
                # count; int8: bit-equal
                if rung == "int8":
                    held = torch.equal(got, want)
                elif rung == "hybrid" or out_u8:
                    held = err <= (1 if out_u8 else HYBRID_TOL)
                else:
                    frame = assemble.assemble_padded_prepad_ref(x, rw, rw, geo.hp, geo.wp)
                    bound = fused_dma.bf16_bound_padded(frame, plan, rh, rw)
                    held = bool(((got.double() - want.double()).abs() <= bound).all())
                    del frame, bound
                if not held:
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
              f"plain: 3x{h + 2 * rh}x{w} sigma={sigma} r=({rh}, {rw}): K1a held; K2 f32 "
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

    # the main path's shard as A4 gets it: the top shard of dp 2 x sp 2 as
    # views (its top halo the block's rows 1..r reversed, its bottom halo
    # the next shard's first r rows); the bottom shard; an interior block of
    # the same height between two neighbours' rows
    mesh22 = make_mesh(dp=2, sp=2, devices=[x.device] * 4)
    halo0 = sharded._haloed_row(sharded._blocks(planar, mesh22)[0],
                                mesh22.devices[0], rh, H // 2, 0, H)
    q = H // 4
    layouts = {"top": halo0[0], "bottom": halo0[1],
               "interior": assemble.HaloedRows(planar[: BATCH // 2, :, q - rh : q],
                                               planar[: BATCH // 2, :, q : q + H // 2],
                                               planar[: BATCH // 2, :, q + H // 2 :
                                                      q + H // 2 + rh])}
    hx = layouts["top"].cat()  # (2, 3, 1138, 3840), the rows as one buffer
    planes, hs = hx.shape[0] * hx.shape[1], hx.shape[2]
    geo = fused_dma.k1_geometry("assembled", rung, local, planes, device=x.device)
    frame = assemble.assemble_padded_prepad(layouts["top"], rw, rw, geo.hp, geo.wp)
    for name, rows in layouts.items():
        got = assemble.assemble_padded_prepad(rows, rw, rw, geo.hp, geo.wp)
        want = assemble.assemble_padded_prepad_rows_ref(rows, rw, rw, geo.hp, geo.wp)
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        print(f"phase 16 A4 on the {name} shard's row segments {tuple(rows.shape)} -> "
              f"({geo.hp}, {geo.wp}) vs plain: equal={equal}", flush=True)
        if not equal:
            raise RuntimeError(f"A4 differs from its plain version on the {name} shard")
        del got, want
    # A4 against the parent's launch (A5's kernel with no row border, on the
    # rows as one buffer), per call and as CUDA graph replays, in turns
    top_rows = layouts["top"]
    a4_fns = {"parent": lambda: assemble.assemble_padded(hx, 0, rw, 0, rw, geo.hp, geo.wp),
              "a4": lambda: assemble.assemble_padded_prepad(top_rows, rw, rw, geo.hp, geo.wp)}
    a4_call = _in_turns("A4 per call on the dp 2 x sp 2 shard", a4_fns)
    a4_graph = _in_turns("A4 as a CUDA graph replay", {k: _graph(f) for k, f in a4_fns.items()})
    t = {
        "a4": a4_call["a4"],
        "k1a": _time(fused_dma.blur_fused_u8_assembled, frame, local, rung,
                     name=f"K1a {rung} on A4's frame").median_ms,
        "a4_plain": _time(assemble.assemble_padded_prepad_rows_ref, top_rows, rw, rw, geo.hp,
                          geo.wp, name="A4 plain version").median_ms,
        "k1a_plain": _time(fused_dma.blur_fused_u8_padded_ref, frame, local, rh, rw, rung,
                           name=f"K1a {rung} plain version on A4's frame").median_ms,
    }
    print(f"phase 16 A4 (ms, in turns with the parent's launch): per call {a4_call}, as "
          f"CUDA graph replays {a4_graph}", flush=True)
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
    t_path = _in_turns(f"blur_u8 vs blur_sharded_u8 dp 2 x sp 2 sigma={SIGMA_SHARD_K1}", {
        "single": lambda u: blur_u8(u, SIGMA_SHARD_K1),
        "sharded": lambda u: blur_sharded_u8(u, plan, meshes[2, 2])}, x)
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
    # the cut into blocks (views), the halo exchange (views), the shards'
    # steps (A4 reading the views, K1a), the gather; beside them, in turns,
    # the parent's way: the cut copied, the halos concatenated, the steps
    # on one buffer a shard
    blocks = sharded._blocks(planar, mesh22)
    halo = [sharded._haloed_row(row, mesh22.devices[i], rh, H // 2, 0, H)
            for i, row in enumerate(blocks)]

    def halo_cat(bl):
        return [[u.cat() for u in sharded._haloed_row(row, mesh22.devices[i], rh, H // 2, 0, H)]
                for i, row in enumerate(bl)]

    def steps(rows):
        return [[fused_blur.blur_fused_haloed(u, local, rung, out_u8=True) for u in row]
                for row in rows]

    def cut_copied():  # the parent's cut: each block a contiguous copy
        return [[b.contiguous() for b in row] for row in sharded._blocks(planar, mesh22)]

    outs = steps(halo)
    copied = cut_copied()
    catted = halo_cat(copied)
    t_parts = {
        "layout": _time(lambda u: u.movedim(-1, -3).contiguous().movedim(-3, -1).contiguous(),
                        x, name="the two layout copies").median_ms,
        **{f"cut{k}": v for k, v in _in_turns("cut into 2 x 2 blocks", {
            "": lambda: sharded._blocks(planar, mesh22), "_copied": cut_copied}).items()},
        **{f"halo{k}": v for k, v in _in_turns("halo exchange", {
            "": lambda: [sharded._haloed_row(row, mesh22.devices[i], rh, H // 2, 0, H)
                         for i, row in enumerate(blocks)],
            "_concatenated": lambda: halo_cat(copied)}).items()},
        **{f"steps{k}": v for k, v in _in_turns("the four shards' A4 + K1a", {
            "": lambda: steps(halo), "_on_one_buffer": lambda: steps(catted)}).items()},
        "gather": _time(sharded._gather, outs, x.device, name="gather").median_ms,
    }
    del copied, catted
    del blocks, halo, outs, layouts, top_rows, halo0, a4_fns

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
              errs["a4"], t["a4_lib"], at=f"{shard}, the top shard's row segments",
              kernel="assemble_rows_kernel", graph_ms=a4_graph["a4"],
              parent_launch_ms_in_turns=a4_call["parent"],
              parent_launch_graph_ms_in_turns=a4_graph["parent"]),
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
    # B1: wgmma (HGMMA, IGMMA) or mma.sync (HMMA, IMMA) fed by TMA (UTMALDG)
    sass = _sass_counts(("mma_chain_kernel",), library=rec["library"])
    for name, c in sorted(sass.items()):
        wgmma = name.split("<")[1].startswith("true")
        products = c["HGMMA"] + c["IGMMA"] if wgmma else c["HMMA"] + c["IMMA"]
        print(f"phase 17 SASS {name} ({'wgmma' if wgmma else 'mma.sync'}): HGMMA {c['HGMMA']}, "
              f"IGMMA {c['IGMMA']}, HMMA {c['HMMA']}, IMMA {c['IMMA']}, UTMALDG "
              f"{c['UTMALDG']}", flush=True)
        if not products or not c["UTMALDG"]:
            raise RuntimeError(f"B1's {name} is not fed by TMA into its instruction: {c}")
    if len(sass) != 8:
        raise RuntimeError(f"the probes' build holds {len(sass)} B1 kernels, not 8")


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

    # every shape, streamed and resident (on the rhs the resident stages
    # stand for), one chain (one cluster a panel) and the launch filling the
    # card (the rates')
    for m, k, n, label in b1.SHAPES:
        for dtype in ("int8", "bf16"):
            a, b = (t.to(dev) for t in b1.operands(m, k, n, dtype, seed=17))
            inner, steps = (3, 2) if dtype == "int8" else (1, 1)
            for resident in (False, True):
                rhs = b1.resident_rhs(b) if resident else b
                want = b1.chain_ref(a, rhs, inner)
                for copies in (False, True):
                    for path in b1.PATHS:
                        launch = b1.prepare(a, b, inner, steps, path=path, resident=resident,
                                            copies=copies)
                        got = launch()
                        torch.cuda.synchronize()
                        hold(got, want, a, rhs, dtype, path,
                             f"{dtype} m={m} k={k} n={n} inner={inner} steps={steps}, "
                             f"{'resident' if resident else 'streamed'}, "
                             f"{'filling the card' if copies else 'one chain'} "
                             f"({launch.grid // launch.cluster} clusters of {launch.cluster})")
    # the probe's path: its entry point, every count at 0 just before
    _probe_counts(zero=True)
    recs = _run_probe(b1, [], "B1 mxu_dot_rate.main()")
    launched = {p: b1.chain.launches[p] for p in b1.PATHS}
    print(f"phase 17 B1 path launches: {launched}", flush=True)
    if min(launched.values()) < 1:
        raise RuntimeError(f"B1's entry point did not launch both paths: {launched}")
    tops = {(r["dtype"], r["label"], r["path"] + ("_resident" if r["resident"] else "")):
            r["tops"] for r in recs}
    clusters = {(r["dtype"], r["label"]): r["cluster"] for r in recs}
    rates = []
    for dtype in ("int8", "bf16"):
        for m, k, n, label in b1.SHAPES:
            a, b = (t.to(dev) for t in b1.operands(m, k, n, dtype))
            lib = ((lambda a=a, b=b: torch._int_mm(a, b)) if dtype == "int8"
                   else (lambda a=a, b=b: a @ b))
            t_lib = timing.time_cuda(lib, iters=10, warmup=2).median_ms
            row = {"dtype": dtype, "shape": [m, k, n], "label": label,
                   "cluster": clusters[dtype, label], "library_tops": 2 * m * k * n / t_lib / 1e9}
            for path in b1.PATHS:
                for resident in ("", "_resident"):
                    row[f"{path}{resident}_tops"] = tops[dtype, label, path + resident]
            rates.append(row)
            peak = b1.PEAK_OPS[dtype] / 1e12
            print(f"phase 17 B1 rate {dtype} {label} (m={m} k={k} n={n}, clusters of "
                  f"{row['cluster']}), TOP/s and share of "
                  f"the published {peak:.0f}: " + "; ".join(
                      f"{key[:-5]} {v:.1f} ({v / peak:.1%})" for key, v in row.items()
                      if key.endswith("_tops")), flush=True)
    print("phase 17 B1 rates " + json.dumps(rates), flush=True)

    def graph_ms(fn) -> float:
        """The call captured in a CUDA graph and replayed: the device's time
        with no host work between launches (the per-call times include the
        wrapper's, which at ~0.04 ms is most of them here)."""
        return timing.time_cuda(_graph(fn), iters=ITERS, warmup=2).median_ms

    m, k, n, label = b1.SHAPES[0]
    a, b = (t.to(dev) for t in b1.operands(m, k, n, "int8"))
    t_plain = _time(b1.chain_ref, a, b, 1, name="B1 plain version (cube, one product)")
    t_lib = _time(torch._int_mm, a, b, name="B1 yardstick torch._int_mm (cube)")
    g_lib = graph_ms(lambda: torch._int_mm(a, b))
    bound = _bound_ms(m * k + k * n + 4 * m * k, 2 * m * k * n, INT8_OP_PER_S)
    out = []
    for path in b1.PATHS:
        launch = b1.prepare(a, b, 1, path=path, copies=False)  # operands laid out once
        t = _time(launch, name=f"B1 {path} (cube, one product, one chain)")
        for res in (t, t_plain, t_lib):
            print(f"phase 17 time: {res}", flush=True)
        g = graph_ms(launch)
        print(f"phase 17 B1 {path} one chain at the cube: clusters of {launch.cluster} CTAs, "
              f"grid {launch.grid} CTAs ({launch.grid // launch.cluster} clusters), "
              f"{t.median_ms:.4f} ms against torch._int_mm {t_lib.median_ms:.4f} ms; as CUDA "
              f"graph replays {g:.4f} against {g_lib:.4f} ms", flush=True)
        if launch.grid < 128:
            raise RuntimeError(f"B1's one chain at the cube is {launch.grid} CTAs, not 128")
        out.append({
            "name": f"mma_rate_{path}", "route": "cuda",
            "source": "blur_algorithms_tpu_torch/csrc/probes/mma_rate.cu",
            "replaces": "benchmarks/mxu_dot_rate.py:61", "launches": launched[path],
            "max_abs_err": errs[path], "ms": t.median_ms, "plain_ms": t_plain.median_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": t_lib.median_ms,
            "at": f"int8 {m}x{k}x{n}, one product, one chain ({launch.grid // launch.cluster} "
                  f"clusters of {launch.cluster} CTAs)", "cluster": launch.cluster,
            "grid": launch.grid, "graph_ms": g, "library_graph_ms": g_lib,
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


# phase 18: K3/K3f's cluster form (n 32768, 65536, 131072) against the plain
# version, then the slice's paths on giant frames (the JAX benchmarks'
# 24000x14500) and the panorama's backward
CLUSTER_CASES = ((32768, 801), (65536, 2661), (131072, 8001))  # (n, taps)
GIANT_H, GIANT_W = 24000, 14500
SIGMA_GIANT, SIGMA_STREAMED = 900.0, 1500.0  # r 2995 (n 32768); r 4992 (n 32768, 65536)
GIANT_ITERS = 5


def _cluster_counts(fft4step, form: str = "cluster") -> dict:
    """K3's and K3f's launches, and those of their ``form`` ("cluster" or
    "staged")."""
    return {f"{c.__name__}{tag}": getattr(c, attr)
            for c in (fft4step.fft_conv_rows, fft4step.fft_conv_rows_framed)
            for tag, attr in (("", "launches"), (f" {form}", f"{form}_launches"))}


def _zero_cluster_counts(fft4step) -> None:
    """Every K3 / K3f count to 0, of each form."""
    for c in (fft4step.fft_conv_rows, fft4step.fft_conv_rows_framed):
        c.launches = c.cluster_launches = c.staged_launches = 0


def _phase18_kernels() -> dict:
    """(a) K3 and K3f's cluster form against the plain version at n 32768,
    65536 and 131072: symmetric and asymmetric taps, odd row counts."""
    from blur_algorithms_tpu_torch import make_custom_plan
    from blur_algorithms_tpu_torch.cuda_kernels import fft4step
    from blur_algorithms_tpu_torch.ops.fft_mxu import _conv_rows_einsum, transform_length

    errs = {"K3": 0.0, "K3f": 0.0}
    for n, width in CLUSTER_CASES:
        dim = n // 2 + 1001  # K3f: dim + 2 pad past n / 2, so the transform is n
        for asym in (False, True):
            plan = make_custom_plan((8, n), _wide_taps(width, asym), [1.0])
            rows = torch.from_numpy(
                (np.random.default_rng(n).random((9, n)) * 255).astype(np.float32)).cuda()
            got = fft4step.fft_conv_rows(rows, n, plan.row)
            want = _conv_rows_einsum(rows, n, plan.row)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            errs["K3"] = max(errs["K3"], err)
            print(f"phase 18 K3 cluster form vs plain: 9 rows n={n} "
                  f"(C={n // fft4step.cluster_segment(n)}) "
                  f"taps={width} {'asymmetric' if asym else 'symmetric'} "
                  f"max_abs_err={err:.3e} limit={FFT_TOL}", flush=True)
            if not err <= FFT_TOL:
                raise RuntimeError(f"K3's cluster form disagrees with its plain version at {n}")
            plan = make_custom_plan((8, dim), _wide_taps(width, asym), [1.0])
            nf = transform_length(plan.row)
            rows = torch.from_numpy(
                (np.random.default_rng(dim).random((7, dim)) * 255).astype(np.float32)).cuda()
            got = fft4step.fft_conv_rows_framed(rows, nf, plan.row)
            want = fft4step.fft_conv_rows_framed_ref(rows, nf, plan.row)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            errs["K3f"] = max(errs["K3f"], err)
            print(f"phase 18 K3f cluster form vs plain: 7 rows dim={dim} n={nf} taps={width} "
                  f"{'asymmetric' if asym else 'symmetric'} max_abs_err={err:.3e} "
                  f"limit={FFT_TOL}", flush=True)
            if nf != n or not err <= FFT_TOL:
                raise RuntimeError(f"K3f's cluster form at {nf} (want {n}) disagrees with "
                                   "its plain version")
    from blur_algorithms_tpu_torch.utils import build

    # registers and spills of every instantiation, the current kernel's and
    # PR 16's (the yardstick in the probes' library, built for phase 17)
    for name, line in (_ptxas_lines(("fft_conv_rows_cluster_kernel",))
                       + _ptxas_lines(("fft_cluster_pr16_kernel",),
                                      build.last_probe_build.get("log", ""))):
        print(f"phase 18 ptxas {name}: {line}", flush=True)
    plib = build.load_probe_library()
    for n, _ in CLUSTER_CASES:
        for framed in (False, True):
            old = ctypes.c_int(-1)
            rc = plib.fft_cluster_ablation_occupancy(0, n, int(framed), ctypes.byref(old))
            if rc:
                raise RuntimeError(f"PR 16's occupancy query failed: CUDA error {rc}")
            cur = fft4step.cluster_occupancy(n, framed)
            c, c16 = n // fft4step.cluster_segment(n), n // fft4step.BODY_N
            print(f"phase 18 cudaOccupancyMaxActiveClusters n={n} {'K3f' if framed else 'K3'}: "
                  f"{cur} clusters of {c} ({cur * c} CTAs of "
                  f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs); PR 16's "
                  f"kernel {old.value} of {c16}", flush=True)
    print(f"phase 18 worst: K3 cluster form max_abs_err={errs['K3']:.3e}, K3f "
          f"{errs['K3f']:.3e} (limit {FFT_TOL})", flush=True)
    return errs


def _against_pr16(entry, rows, n, axis_plan, framed: bool, label: str) -> dict:
    """The cluster form against PR 16's design of it (B2's yardstick, never
    a path), in turns on the same rows: the two outputs' largest difference
    and each one's time."""
    from blur_algorithms_tpu_torch.benchmarks import fft_mxu_ablation as b2

    got = entry(rows, n, axis_plan)
    old = b2.cluster_ablation(rows, n, axis_plan, "pr16", framed)
    torch.cuda.synchronize()
    diff = float((got - old).abs().max())
    del got, old
    t = _in_turns(label, {"current": lambda: entry(rows, n, axis_plan),
                          "pr16": lambda: b2.cluster_ablation(rows, n, axis_plan, "pr16",
                                                              framed)})
    print(f"phase 18 {label} in turns with PR 16's kernel: current {t['current']:.4f} ms, "
          f"PR 16 {t['pr16']:.4f} ms ({t['current'] / t['pr16']:.3f}x); outputs differ by "
          f"{diff:.3e} (limit {FFT_TOL})", flush=True)
    if not diff <= FFT_TOL:
        raise RuntimeError(f"the cluster form and PR 16's differ by {diff} at {label}")
    return {"current_ms": t["current"], "pr16_ms": t["pr16"]}


def _giant_u8(batch: int) -> torch.Tensor:
    """(batch, GIANT_H, GIANT_W, 3) uint8 frames made on the card."""
    from blur_algorithms_tpu_torch.utils.frames import make_frames_on

    return make_frames_on("cuda", batch, GIANT_H, GIANT_W).movedim(1, -1).contiguous()


def _slice16() -> list[dict]:
    """Phase 18; returns the kernels-line entries of K3's and K3f's cluster
    form."""
    from blur_algorithms_tpu_torch import api, blur, blur_u8, make_plan
    from blur_algorithms_tpu_torch.cuda_kernels import fft4step
    from blur_algorithms_tpu_torch.ops.adjoint import blur_adjoint
    from blur_algorithms_tpu_torch.ops.fft_mxu import transform_length
    from blur_algorithms_tpu_torch.utils import timing
    from blur_algorithms_tpu_torch.utils.frames import make_frames_on

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    k3, k3f = fft4step.fft_conv_rows, fft4step.fft_conv_rows_framed
    errs = _phase18_kernels()
    launched = {"K3": 0, "K3f": 0}

    # (b) the panorama's backward: blur AUTO forward + backward at sigma 400
    x = make_frames_on("cuda", BATCH, PANO_H, PANO_W).float()
    plan = make_plan((PANO_H, PANO_W), SIGMA_F32_WIDE)
    g = torch.rand(x.shape, generator=torch.Generator(x.device).manual_seed(18),
                   device=x.device)
    xg = x.clone().requires_grad_()
    torch.cuda.synchronize()
    _zero_cluster_counts(fft4step)
    y = blur(xg, SIGMA_F32_WIDE)
    torch.cuda.synchronize()
    fwd = _cluster_counts(fft4step)
    _zero_cluster_counts(fft4step)
    (y * g).sum().backward()
    torch.cuda.synchronize()
    bwd = _cluster_counts(fft4step)
    launched["K3"] += bwd["fft_conv_rows cluster"]
    launched["K3f"] += fwd["fft_conv_rows_framed cluster"]
    want = blur_adjoint(g, plan)  # a check: its launches are not the path's
    torch.cuda.synchronize()
    gerr = float((xg.grad - want).abs().max())
    lhs = float((y.detach().double() * g.double()).sum())
    rhs = float((x.double() * xg.grad.double()).sum())
    rel = abs(lhs - rhs) / abs(lhs)
    r = plan.row.support_radius
    n_adj = max(256, 1 << (PANO_W + 4 * r - 1).bit_length())  # the adjoint's rows
    print(f"phase 18 main path: blur AUTO forward + backward {tuple(x.shape)} f32 "
          f"sigma={SIGMA_F32_WIDE} r={r} (rows n {transform_length(plan.row)}; adjoint "
          f"rows n {n_adj}): forward launches "
          f"{fwd}, backward {bwd}; x.grad vs blur_adjoint(g) max={gerr:.3e}; adjoint "
          f"identity <Ax, g> {lhs:.9e} vs <x, A^T g> {rhs:.9e}, relative {rel:.3e} "
          "limit 1e-5", flush=True)
    if (fwd["fft_conv_rows_framed"] != 2 or fwd["fft_conv_rows_framed cluster"] != 1
            or fwd["fft_conv_rows"] or bwd["fft_conv_rows"] != 2
            or bwd["fft_conv_rows cluster"] != 1 or bwd["fft_conv_rows_framed"]):
        raise RuntimeError(f"the panorama's blur launched {fwd} forward, {bwd} backward")
    if not gerr <= 1e-6 * float(want.abs().max()) or not rel <= 1e-5:
        raise RuntimeError(f"x.grad differs from blur_adjoint(g) by {gerr}, or the adjoint "
                           f"identity is off by {rel}")
    del y, g, want

    def pano_fwd_bwd(t):
        t = t.detach().requires_grad_()
        blur(t, SIGMA_F32_WIDE).backward(torch.ones_like(t))
        return t.grad

    t_pano = timing.time_cuda(pano_fwd_bwd, x, iters=GIANT_ITERS, warmup=1,
                              name=f"blur AUTO forward + backward panorama sigma={SIGMA_F32_WIDE}",
                              megapixels=BATCH * PANO_H * PANO_W / 1e6)
    # K3's cluster form alone on the adjoint's rows (12 planes x 15360 + 4 r
    # -> 32768)
    padded = torch.nn.functional.pad(x.reshape(-1, PANO_W), (2 * r, n_adj - PANO_W - 2 * r))
    del xg, x
    torch.cuda.empty_cache()
    padded = padded.contiguous()
    k3_d = _kernel_times(k3, padded, n_adj, plan.row, False,
                         f"K3 cluster form adjoint rows sigma={SIGMA_F32_WIDE}", 18)
    k3_d["in_turns"] = _against_pr16(k3, padded, n_adj, plan.row, False,
                                     f"K3 cluster form adjoint rows sigma={SIGMA_F32_WIDE}")
    del padded
    torch.cuda.empty_cache()

    # (c) the main path: blur_u8 fft_mxu on one giant frame at sigma 900
    img = _giant_u8(1)
    plan = make_plan((GIANT_H, GIANT_W), SIGMA_GIANT)
    torch.cuda.synchronize()
    _zero_cluster_counts(fft4step)
    out = blur_u8(img, SIGMA_GIANT, engine="fft_mxu")
    torch.cuda.synchronize()
    ran = _cluster_counts(fft4step)
    launched["K3f"] += ran["fft_conv_rows_framed cluster"]
    ref = blur_u8(img, SIGMA_GIANT, engine="fft_tiles")
    d = (out.int() - ref.int()).abs()
    dmax, exact = int(d.max()), float((d == 0).float().mean())
    print(f"phase 18 main path: blur_u8 engine=fft_mxu {tuple(img.shape)} sigma={SIGMA_GIANT} "
          f"r={plan.row.support_radius} (n {transform_length(plan.row)}, "
          f"{transform_length(plan.col)}): launches {ran}; vs fft_tiles (torch.fft) "
          f"max={dmax} exact={exact}", flush=True)
    if ran["fft_conv_rows_framed cluster"] != 2 or ran["fft_conv_rows_framed"] != 2 or dmax > 1:
        raise RuntimeError(f"blur_u8 fft_mxu at sigma {SIGMA_GIANT}: {ran}, {dmax} counts "
                           "from fft_tiles")
    del out, ref, d
    eng = api._resolve_engine("auto", plan, 1, img.device, 3)
    t_giant = {
        "fft_mxu": timing.time_cuda(blur_u8, img, SIGMA_GIANT, "fft_mxu", iters=GIANT_ITERS,
                                    warmup=1, name=f"blur_u8 fft_mxu giant sigma={SIGMA_GIANT}",
                                    megapixels=GIANT_H * GIANT_W / 1e6),
        "auto": timing.time_cuda(blur_u8, img, SIGMA_GIANT, iters=GIANT_ITERS, warmup=1,
                                 name=f"blur_u8 AUTO ({eng.value}) giant sigma={SIGMA_GIANT}",
                                 megapixels=GIANT_H * GIANT_W / 1e6),
        "fused": timing.time_cuda(blur_u8, img, SIGMA_GIANT, "fused", iters=GIANT_ITERS,
                                  warmup=1, name=f"blur_u8 fused giant sigma={SIGMA_GIANT}",
                                  megapixels=GIANT_H * GIANT_W / 1e6),
    }
    # K3f's cluster form alone on the giant frame's row axis: 72000 rows of
    # 14500, n 32768
    rows = img[0].movedim(-1, 0).reshape(-1, GIANT_W).float()
    del img
    torch.cuda.empty_cache()
    k3f_d = _kernel_times(k3f, rows, transform_length(plan.row), plan.row, True,
                          f"K3f cluster form giant rows sigma={SIGMA_GIANT}", 18)
    k3f_d["in_turns"] = _against_pr16(k3f, rows, transform_length(plan.row), plan.row, True,
                                      f"K3f cluster form giant rows sigma={SIGMA_GIANT}")
    del rows
    torch.cuda.empty_cache()

    # (d) the streamed path: blur_u8 AUTO on 4 giant frames at sigma 1500
    img = _giant_u8(BATCH)
    plan = make_plan((GIANT_H, GIANT_W), SIGMA_STREAMED)
    spec = api.device_spec(img.device)
    eng = api._resolve_engine("auto", plan, 1, img.device, BATCH * 3)
    streams = api._fft_mxu_streams(plan, BATCH * 3, spec)
    lengths, whole = [], []
    launch_n, whole_fn = fft4step._launch, api.blur_fft_mxu_cuda
    fft4step._launch = lambda entry, rows, n, *a: lengths.append(n) or launch_n(entry, rows, n, *a)
    api.blur_fft_mxu_cuda = lambda *a: whole.append(1) or whole_fn(*a)
    try:
        torch.cuda.synchronize()
        _zero_cluster_counts(fft4step)
        out = blur_u8(img, SIGMA_STREAMED)
        torch.cuda.synchronize()
        ran = _cluster_counts(fft4step)
    finally:
        fft4step._launch, api.blur_fft_mxu_cuda = launch_n, whole_fn
    launched["K3f"] += ran["fft_conv_rows_framed cluster"]
    strips = -(-GIANT_H // 1024) + -(-GIANT_W // 1024)
    tally = {n: lengths.count(n) for n in sorted(set(lengths))}
    one = blur_u8(img[:1], SIGMA_STREAMED, engine="fft_mxu")  # one frame: whole-frame
    d = (out[:1].int() - one.int()).abs()
    dmax, exact = int(d.max()), float((d == 0).float().mean())
    del one, d
    print(f"phase 18 main path: blur_u8 AUTO {tuple(img.shape)} sigma={SIGMA_STREAMED} "
          f"r={plan.col.support_radius} -> {eng.value} (streams: {streams}, whole-frame "
          f"estimate {transform_length(plan.row)}/{transform_length(plan.col)}"
          f" lengths, {api.estimate_bytes(plan, BATCH * 3)} bytes against the budget "
          f"{spec.fft_mxu_byte_budget}); launches {ran}, by length {tally}, whole-frame "
          f"calls {len(whole)}; frame 0 vs single-frame fft_mxu max={dmax} exact={exact}",
          flush=True)
    if (eng is not api.Engine.FFT_MXU or not streams or whole
            or ran["fft_conv_rows_framed cluster"] != strips or ran["fft_conv_rows"]
            or set(tally) != {transform_length(plan.row), transform_length(plan.col)}
            or dmax > 1):
        raise RuntimeError(f"blur_u8 AUTO at sigma {SIGMA_STREAMED} did not stream through "
                           f"K3f's cluster form within 1 count: {ran}, {tally}, {len(whole)}")
    del out
    t_streamed = timing.time_cuda(blur_u8, img, SIGMA_STREAMED, iters=GIANT_ITERS, warmup=1,
                                  name=f"blur_u8 AUTO streamed 4 giant frames sigma={SIGMA_STREAMED}",
                                  megapixels=BATCH * GIANT_H * GIANT_W / 1e6)
    # K3f's cluster form alone on one column strip of the streamer (1024
    # columns of each of the 12 planes: 12288 rows of 24000, n 65536; clusters of
    # 8 CTAs of 8192, PR 16's kernel 4 of 16384)
    rows = img[:, :, :1024, :].permute(0, 3, 2, 1).reshape(-1, GIANT_H).float().contiguous()
    nc = transform_length(plan.col)
    label = f"K3f cluster form streamed column strip sigma={SIGMA_STREAMED}"
    strip_d = _kernel_times(k3f, rows, nc, plan.col, True, label, 18)
    strip_d["in_turns"] = _against_pr16(k3f, rows, nc, plan.col, True, label)
    del rows
    torch.cuda.empty_cache()
    one = img[:1]
    del img
    torch.cuda.empty_cache()
    out = blur_u8(one, SIGMA_GIANT, engine="fft_stream")
    ref = blur_u8(one, SIGMA_GIANT, engine="fft_tiles")
    d = (out.int() - ref.int()).abs()
    print(f"phase 18 main path: blur_u8 engine=fft_stream {tuple(one.shape)} "
          f"sigma={SIGMA_GIANT} vs fft_tiles max={int(d.max())} "
          f"exact={float((d == 0).float().mean())}", flush=True)
    if int(d.max()) > 1:
        raise RuntimeError("the fft_stream engine is past 1 count of fft_tiles")
    del out, ref, d, one
    torch.cuda.empty_cache()

    for res in (t_pano, *t_giant.values(), t_streamed):
        print(f"phase 18 time: {res}", flush=True)
    print(f"phase 18 launches of the cluster form on the slice's paths: {launched}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, n in launched.items():
        if n < 1:
            raise RuntimeError(f"{name}'s cluster form was not launched on the main path")
    entry = lambda name, line, n, d, err, **more: {  # noqa: E731
        "name": name, "route": "cuda", "source": "blur_algorithms_tpu_torch/csrc/fft4step.cu",
        "replaces": line, "launches": n, "max_abs_err": err, "ms": d["ms"],
        "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"], "bound_by": d["bound_by"],
        "library_ms": d["library_ms"], "in_turns_with_pr16": d["in_turns"], **more,
    }
    strip = {k: strip_d[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                     "in_turns")}
    return [
        entry("fft4step_cluster", "blur_algorithms_tpu/pallas_kernels/fft4step.py:138",
              launched["K3"], k3_d, max(errs["K3"], k3_d["err"])),
        entry("fft4step_framed_cluster", "blur_algorithms_tpu/pallas_kernels/fft4step.py:157",
              launched["K3f"], k3f_d, max(errs["K3f"], k3f_d["err"], strip_d["err"]),
              column_strip_c4=strip),
    ]


# phase 19: the front end (CLI, directory streaming, server, filters) on 4K
STREAM_SHAPES = ((2160, 3840), (1997, 3001), (1080, 1920), (720, 1280))
CLI_CASES = (("auto", "10"), ("4", "6"), ("deriche", "40"), ("1", "10"))
SERVE_POSTS, SERVE_CLIENTS = 8, 2


def _counts_k1_k2_k4() -> dict:
    """Phase 19's launch counts: K1 (any body), K2, its single-axis form, K4."""
    from blur_algorithms_tpu_torch.cuda_kernels import box_blur, fused_blur

    return {"K1": sum(b.launches for b, _ in _k1_bodies().values()),
            "K2": fused_blur.blur_fused_f32.launches,
            "K2 single-axis": fused_blur.blur_fused_axis_f32.launches,
            "K4": box_blur.box_blur_scan_axis.launches}


def _vs(got: np.ndarray, want: np.ndarray, label: str, smi: str, limit: int = 1) -> None:
    d = np.abs(got.astype(int) - want.astype(int))
    print(f"phase 19 {label}: max {int(d.max())} counts, exact fraction "
          f"{float((d == 0).mean())} ({smi})", flush=True)
    if got.shape != want.shape or d.max() > limit:
        raise RuntimeError(f"{label}: {int(d.max())} counts from its reference "
                           f"(shape {got.shape} vs {want.shape})")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _slice18(smi: str, device: str = "cuda") -> None:
    """Phase 19: the CLI, directory streaming, the HTTP server and the
    filters on the card at 4K, each output against the oracle or the plain
    version; K1, K2 (and its single-axis form) and K4 must each launch.
    (``device="cpu"`` with smaller ``H``, ``W`` and ``STREAM_SHAPES``
    rehearses the phase on the plain versions, where nothing launches.)"""
    import statistics
    import tempfile
    import threading
    import urllib.request

    from blur_algorithms_tpu_torch import blur_u8, cli, make_plan, oracle
    from blur_algorithms_tpu_torch.api import _route, _u8_dma_precision, _plan_for
    from blur_algorithms_tpu_torch.cuda_kernels import fused_blur
    from blur_algorithms_tpu_torch.examples import serve as serve_mod
    from blur_algorithms_tpu_torch.models import BlurPipeline, channel_smooth, unsharp_mask
    from blur_algorithms_tpu_torch.ops.layout import round_to_u8
    from blur_algorithms_tpu_torch.utils import io
    from blur_algorithms_tpu_torch.utils.frames import make_frames
    from blur_algorithms_tpu_torch.utils.hw import device_spec

    t_phase = time.perf_counter()
    dev = torch.device(device)
    _sync(dev)
    for c in (*_counters(), *(b for b, _ in _k1_bodies().values())):
        c.launches = 0
    frames = make_frames(BATCH, H, W)
    img = np.ascontiguousarray(np.moveaxis(frames[0], 0, -1))
    want = {"10": oracle.blur_u8(img, 10.0), "40": oracle.blur_u8(img, 40.0),
            "box": oracle.box_blur_u8(img, 36)}
    with tempfile.TemporaryDirectory() as tmp:
        src = f"{tmp}/frame.ppm"
        io.write_image(src, img)
        # ---- the CLI, as ``python -m blur_algorithms_tpu_torch`` runs it ----
        for engine, nsmooth in CLI_CASES:
            out = f"{tmp}/cli_{engine}.ppm"
            before = _counts_k1_k2_k4()
            t0 = time.perf_counter()
            if cli.main([engine, nsmooth, src, "-o", out, "--device", device]) != 0:
                raise RuntimeError(f"the CLI failed on {engine} {nsmooth}")
            ms = (time.perf_counter() - t0) * 1e3
            ran = {k: v - before[k] for k, v in _counts_k1_k2_k4().items()}
            ref = want["box"] if engine == "4" else want[nsmooth]
            _vs(io.read_image(out), ref, f"CLI {engine} {nsmooth} ({H}x{W} PPM, "
                f"{ms:.1f} ms with the file I/O; launches {ran})", smi)

        # ---- directory streaming: BlurPipeline.stream over image paths ----
        paths, exact = [], []
        for k, (h, w) in enumerate(STREAM_SHAPES):
            f = img if (h, w) == (H, W) else np.ascontiguousarray(
                np.moveaxis(make_frames(1, h, w)[0], 0, -1))
            paths.append(f"{tmp}/s{k}_{h}x{w}.ppm")
            io.write_image(paths[-1], f)
            exact.append(f)
        pipe = BlurPipeline(SIGMA, device=dev)
        for sweep in ("first", "warm"):
            _sync(dev)
            t0 = time.perf_counter()
            outs = list(pipe.stream(paths))
            _sync(dev)
            dt = time.perf_counter() - t0
            print(f"phase 19 stream ({sweep} pass): {len(outs)} frames "
                  f"{list(STREAM_SHAPES)} in {dt * 1e3:.1f} ms = {len(outs) / dt:.2f} "
                  f"frames/s with reading and decoding, sigma={SIGMA}, stats {pipe.stats} "
                  f"({smi})", flush=True)
        if [k for k, _ in outs] != paths:
            raise RuntimeError("stream yielded its frames out of order")
        spec = device_spec(dev)
        for (key, got), f in zip(outs, exact):
            h, w = f.shape[:2]
            x = torch.from_numpy(f).to(dev)
            ref = blur_u8(x, SIGMA)
            bh, bw = pipe._bucketed(h, w)
            routes = []
            for sh, sw in ((h, w), (bh, bw)):
                plan = _plan_for(sh, sw, SIGMA, "gaussian", "auto")
                eng = _route("auto", plan, 1, dev, 3)
                routes.append((eng.value, _u8_dma_precision(plan, spec),
                               fused_blur._split_wins(plan, 1, "int8", dev)))
            same = routes[0] == routes[1]
            equal = torch.equal(got, ref)
            d = int((got.int() - ref.int()).abs().max())
            print(f"phase 19 stream {h}x{w} (bucket {bh}x{bw}, routes {routes}): "
                  f"torch.equal to exact-shape blur_u8 {equal}, max {d}", flush=True)
            if (same and not equal) or d > 1:
                raise RuntimeError(f"streamed {h}x{w} differs from blur_u8 by {d}")
        _vs(outs[0][1].cpu().numpy(), want["10"], f"stream {H}x{W} vs oracle", smi)

    # ---- the HTTP server: 8 POSTs of the 4K PPM from 2 clients, box, deriche ----
    started = threading.Event()
    t0 = time.perf_counter()
    httpd = serve_mod.serve(port=0, warmup=[f"{H}x{W}"], started=started, device=device)
    warm_s = time.perf_counter() - t0
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    started.wait(30)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    body = io.encode_image(img, "ppm")
    times, errors = [], []

    def post(query: str) -> tuple[np.ndarray, float]:
        t = time.perf_counter()
        req = urllib.request.Request(f"{url}/blur?{query}&format=ppm", data=body,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=300) as resp:
            got = io.decode_image(resp.read(), "ppm")
        return got, (time.perf_counter() - t) * 1e3

    def client(n: int) -> None:
        try:
            for _ in range(n):
                got, ms = post("sigma=10")
                times.append(ms)
                d = np.abs(got.astype(int) - want["10"].astype(int))
                errors.append(int(d.max()))
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(repr(e))

    try:
        clients = [threading.Thread(target=client, args=(SERVE_POSTS // SERVE_CLIENTS,))
                   for _ in range(SERVE_CLIENTS)]
        t0 = time.perf_counter()
        for c in clients:
            c.start()
        for c in clients:
            c.join()
        wall = time.perf_counter() - t0
        if len(times) != SERVE_POSTS or any(not isinstance(e, int) or e > 1 for e in errors):
            raise RuntimeError(f"the server's sigma 10 answers: {errors}")
        print(f"phase 19 server: warmup {H}x{W} {warm_s:.2f} s; {SERVE_POSTS} POSTs of a "
              f"{H}x{W} PPM at sigma 10 from {SERVE_CLIENTS} clients in {wall * 1e3:.1f} ms, "
              f"round-trip request ms p50 {statistics.median(times):.1f} max {max(times):.1f}, "
              f"max {max(errors)} counts from the oracle ({smi})", flush=True)
        for query, ref, label in (("sigma=6&engine=box", want["box"], "box nsmooth 6"),
                                  ("sigma=40&engine=deriche", want["40"], "deriche sigma 40")):
            got, ms = post(query)
            _vs(got, ref, f"server {label} ({ms:.1f} ms a request)", smi)
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as resp:
            print(f"phase 19 server /healthz: {resp.read().decode()}", flush=True)
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(30)

    # ---- filters on K2 against K2's plain version on the card ----
    batch = torch.from_numpy(np.ascontiguousarray(np.moveaxis(frames, 1, -1))).to(dev)
    got = unsharp_mask(batch, 2.0)
    planar = batch.movedim(-1, -3).contiguous()
    plan = make_plan((H, W), 2.0)
    xf = planar.float()
    plain = round_to_u8(xf + (xf - fused_blur.blur_fused_f32_ref(planar, plan)))
    _vs(got.cpu().numpy(), plain.movedim(-3, -1).cpu().numpy(),
        f"unsharp_mask {tuple(batch.shape)} sigma 2 vs K2's plain version", smi)
    sigmas = (5.0, 5.0, 7.0)
    got = channel_smooth(img, sigmas, device=device)
    ref = np.stack([
        round_to_u8(fused_blur.blur_fused_f32_ref(
            torch.from_numpy(np.ascontiguousarray(img[..., c])).to(dev).float(),
            make_plan((H, W), s))).cpu().numpy()
        for c, s in enumerate(sigmas)], axis=-1)
    _vs(got, ref, f"channel_smooth rgb {sigmas} {H}x{W} vs K2's plain version", smi)

    _sync(dev)
    counts = _counts_k1_k2_k4()
    print(f"phase 19 launches over the phase: {counts}; {time.perf_counter() - t_phase:.1f} s "
          f"({smi})", flush=True)
    if not all(counts.values()):
        raise RuntimeError(f"phase 19 did not launch every kernel of its path: {counts}")


# phase 20: K3/K3f past transform length 131072 (the wide cluster form on
# 16 CTAs at n 262144, the staged form past it, and at 262144 on a card that
# places no cluster of 16) against the plain version,
# then the slice's paths on 2160 x 140000 RGB frames (a stitched panorama
# strip), a 2160 x 131072 float batch and a 1400 x 262000 float plane
WIDE_CASE = (262144, 2001)  # (n, taps): the wide cluster form on 16 CTAs
STAGED_CASES = ((524288, 4001), (1048576, 8001))  # the staged form: digits 32; 8 x 8
BIG_ROWS = 8301  # x 262144 (K3) or 260144 (K3f): past 2^31 elements
BIG_ROWS_STAGED = 4151  # x 524288 (K3) or 520288 (K3f): past 2^31 elements
STRIP_H, STRIP_W = 2160, 140000
SIGMA_STRIP = 900.0  # r 2995: rows n 262144 (a cluster of 16), columns n 7168
PANO_F32_W = 131072  # blur AUTO forward + backward at SIGMA_F32_WIDE: n 262144
WIDE_H, WIDE_W = 1400, 262000  # at SIGMA_F32_WIDE: rows and adjoint rows n 524288


def _k3_counts(fft4step) -> dict:
    """K3's and K3f's launches, and those of each form past 16384."""
    return {**_cluster_counts(fft4step, "cluster"), **_cluster_counts(fft4step, "staged")}


@contextlib.contextmanager
def _no_cluster_of_16(fft4step):
    """This card as one that places no cluster of 16 CTAs (a MIG slice, a
    Hopper part with fewer free SMs in a GPC): the wide form's occupancy
    reads 0, every other length's stays the card's, and the form's cached
    query is emptied on the way in and out, so n 262144 takes the staged
    route (``fft4step._form``)."""
    real = fft4step.cluster_occupancy
    fft4step.cluster_occupancy = lambda n, framed=False: (
        0 if n == fft4step.CLUSTER_LONGEST else real(n, framed))
    fft4step._wide_clusters.cache_clear()
    try:
        yield
    finally:
        fft4step.cluster_occupancy = real
        fft4step._wide_clusters.cache_clear()


def _staged_route(fn, *args):
    """``fn(*args)`` as on a card that places no cluster of 16."""
    from blur_algorithms_tpu_torch.cuda_kernels import fft4step

    with _no_cluster_of_16(fft4step):
        return fn(*args)


def _tag(fft4step, n: int, framed: bool) -> str:
    """The count a K3 launch (K3f's where ``framed``) at ``n`` adds to on
    this card as it routes now: "staged", or "cluster" (the cluster and the
    wide form)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    return "staged" if fft4step._form(n, framed, dev) == "staged" else "cluster"


FORM_NAMES = {"cluster": "wide cluster form", "staged": "staged form"}  # at n 262144
OTHER_FORM = {"cluster": "staged", "staged": "cluster"}


def _forms_vs_plain(n: int, width: int, route: bool = False) -> dict:
    """K3 (9 rows of n) and K3f (7 rows of n / 2 + 1001, framed to n)
    against their plain versions, symmetric and asymmetric taps; each call
    must launch the form the card routes n to (``_tag``) once. ``route``:
    as on a card that places no cluster of 16 (``_no_cluster_of_16``), and
    held against this card's own form on the same rows where that is the
    wide one. The worst errors, keyed by kernel and form."""
    from blur_algorithms_tpu_torch import make_custom_plan
    from blur_algorithms_tpu_torch.cuda_kernels import fft4step
    from blur_algorithms_tpu_torch.ops.fft_mxu import _conv_rows_einsum, transform_length
    from blur_algorithms_tpu_torch.ops.kernels import wrap_centered

    errs = {}
    dim = n // 2 + 1001  # K3f: dim + 2 pad past n / 2, so the transform is n
    for asym in (False, True):
        what = f"taps={width} {'asymmetric' if asym else 'symmetric'}"
        for name, fn, plain, nrows, length in (
                ("K3", fft4step.fft_conv_rows, _conv_rows_einsum, 9, n),
                ("K3f", fft4step.fft_conv_rows_framed, fft4step.fft_conv_rows_framed_ref, 7,
                 dim)):
            framed = name == "K3f"
            plan = make_custom_plan((8, length), _wide_taps(width, asym), [1.0])
            rows = torch.from_numpy((np.random.default_rng(length).random((nrows, length))
                                     * 255).astype(np.float32)).cuda()
            with _no_cluster_of_16(fft4step) if route else contextlib.nullcontext():
                form = _tag(fft4step, n, framed)
                before = (fn.launches, getattr(fn, f"{form}_launches"))
                got = fn(rows, n, plan.row)
                torch.cuda.synchronize()
                ran = (fn.launches - before[0], getattr(fn, f"{form}_launches") - before[1])
            want = plain(rows, n, plan.row)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            errs[f"{name} {form}"] = max(errs.get(f"{name} {form}", 0.0), err)
            extra = ""
            if name == "K3" and n == STAGED_CASES[-1][0]:
                h = np.conj(np.fft.fft(wrap_centered(plan.row.taps, n).astype(np.float64)))
                ref = torch.fft.ifft(torch.fft.fft(rows.double(), dim=-1)
                                     * torch.from_numpy(h).cuda(), dim=-1).real
                extra = (f"; vs float64 torch.fft correlation "
                         f"{float((got.double() - ref).abs().max()):.3e}")
                del ref
            diff = 0.0
            if route and _tag(fft4step, n, framed) == "cluster":
                wide = fn(rows, n, plan.row)
                torch.cuda.synchronize()
                diff = float((got - wide).abs().max())
                extra += (f"; vs the wide form max_abs_err={diff:.3e}, bit-equal "
                          f"{torch.equal(got, wide)}")
                del wide
            shape = f"{nrows} rows n={n}" if name == "K3" else f"{nrows} rows dim={dim} n={n}"
            digits = f" (digits {fft4step.staged_digits(n)})" if form == "staged" else (
                f" (C={n // fft4step.cluster_segment(n)})")
            how = " routed as on a card that places no cluster of 16" if route else ""
            print(f"phase 20 {name} {form} form{how} vs plain: {shape}{digits} {what} "
                  f"max_abs_err={err:.3e} limit={FFT_TOL}{extra}", flush=True)
            if (ran != (1, 1) or not err <= FFT_TOL or not diff <= FFT_TOL
                    or (route and form != "staged")
                    or (name == "K3f" and transform_length(plan.row) != n)):
                raise RuntimeError(f"{name}'s {form} form at {n}: launches {ran}, "
                                   f"{err} from its plain version, {diff} from the wide form")
            del rows, got, want
    return errs


def _past_2_31(n: int, width: int, nrows: int) -> dict:
    """One launch each of K3 on ``nrows`` rows of n and K3f on as many of
    n - (width - 1) (pad (width - 1) / 2: n), an odd count past 2^31
    elements (64-bit offsets), in the form the card routes n to; rows are
    independent, so the plain version runs on the last rows alone (offsets
    past 2^31) and on the row that rides with the zero row."""
    from blur_algorithms_tpu_torch import make_custom_plan
    from blur_algorithms_tpu_torch.cuda_kernels import fft4step
    from blur_algorithms_tpu_torch.ops.fft_mxu import _conv_rows_einsum

    errs = {}
    gen = torch.Generator("cuda").manual_seed(31)
    for framed in (False, True):
        dim = n - (width - 1) if framed else n
        plan = make_custom_plan((8, dim), _wide_taps(width, framed), [1.0])
        fn = fft4step.fft_conv_rows_framed if framed else fft4step.fft_conv_rows
        plain = fft4step.fft_conv_rows_framed_ref if framed else _conv_rows_einsum
        rows = torch.rand((nrows, dim), generator=gen, device="cuda").mul_(255)
        form = _tag(fft4step, n, framed)
        before = getattr(fn, f"{form}_launches")
        got = fn(rows, n, plan.row)
        pick = torch.tensor([nrows // 2, *range(nrows - 7, nrows)], device="cuda")
        want = plain(rows[pick].contiguous(), n, plan.row)
        torch.cuda.synchronize()
        err = float((got[pick] - want).abs().max())
        finite = bool(torch.isfinite(got).all())
        name = "K3f" if framed else "K3"
        errs[f"{name} {form}"] = err
        scratch = (f"{(nrows + 1) // 2 * n * 2} scratch floats" if form == "staged"
                   else "no scratch")
        print(f"phase 20 {name} {form} form past 2^31 elements: {nrows} rows x {dim} "
              f"({nrows * dim} elements, {scratch}), n={n}, "
              f"{'asymmetric' if framed else 'symmetric'} taps={width}: rows {nrows // 2} and "
              f"{nrows - 7}..{nrows - 1} vs plain max_abs_err={err:.3e} limit={FFT_TOL}; "
              f"all finite {finite}", flush=True)
        if not (err <= FFT_TOL and finite and nrows * dim > 2**31
                and getattr(fn, f"{form}_launches") == before + 1):
            raise RuntimeError(f"{name}'s {form} form past 2^31 elements: {err}, finite "
                               f"{finite}")
        del rows, got, want
        torch.cuda.empty_cache()
    return errs


def _phase20_kernels() -> dict:
    """(a) K3/K3f at n 262144 in the form this card routes it to (the wide
    cluster form where it places a cluster of 16), then as a card that
    places none routes it (the staged form, also held against the wide
    form), and the staged form at 524288 (one first-pass digit, 32) and
    1048576 (two, 8 and 8), against the plain version: symmetric and
    asymmetric taps, odd row counts; the plain version's dense stages fit
    the card at all three, so no float64 torch.fft stand-in is needed (its
    error at 1048576 is printed beside). Then one launch of each length's
    own form past 2^31 elements (64-bit offsets), the ptxas lines and the
    clusters the card places at once at each cluster form's length."""
    from blur_algorithms_tpu_torch.cuda_kernels import fft4step

    errs = {f"{k} {form}": 0.0 for k in ("K3", "K3f") for form in ("cluster", "staged")}

    def worst(found: dict) -> None:
        for k, e in found.items():
            errs[k] = max(errs[k], e)

    worst(_forms_vs_plain(*WIDE_CASE))
    worst(_forms_vs_plain(*WIDE_CASE, route=True))
    for n, width in STAGED_CASES:
        worst(_forms_vs_plain(n, width))
    for (n, width), nrows in ((WIDE_CASE, BIG_ROWS), (STAGED_CASES[0], BIG_ROWS_STAGED)):
        worst(_past_2_31(n, width, nrows))
    for name, line in _ptxas_lines(("fft_conv_rows_wide_kernel",
                                    "fft_conv_rows_staged_pass_kernel",
                                    "fft_conv_rows_staged_segment_kernel")):
        print(f"phase 20 ptxas {name}: {line}", flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n in (32768, 65536, 131072, fft4step.CLUSTER_LONGEST):
        size = n // fft4step.cluster_segment(n)
        for framed in (False, True):
            c = fft4step.cluster_occupancy(n, framed)
            print(f"phase 20 cudaOccupancyMaxActiveClusters n={n} {'K3f' if framed else 'K3'}: "
                  f"{c} clusters of {size} ({size * c} CTAs of {sms} SMs); the form that runs: "
                  f"{fft4step._form(n, framed, dev)}", flush=True)
            if n == fft4step.CLUSTER_LONGEST and c < 1:
                print(f"phase 20 the card places no cluster of 16: "
                      f"{'K3f' if framed else 'K3'} at n {n} runs the staged form on its paths",
                      flush=True)
    print(f"phase 20 worst max_abs_err: {errs} (limit {FFT_TOL})", flush=True)
    torch.cuda.empty_cache()
    return errs


def _form_times(label: str, d: dict) -> None:
    """A launch of K3/K3f past 131072 on the main path's rows
    (``_kernel_times``'s dict): its time beside its bytes time (one read
    and one write of the rows), its bound and cuFFT's; raise if it is off
    its plain version by more than FFT_TOL."""
    print(f"phase 20 {label}: {d['ms']:.4f} ms; bytes {d['bytes_ms']:.4f} ms "
          f"({d['ms'] / d['bytes_ms']:.2f}x), bound {d['bound_ms']:.4f} ms ({d['bound_by']}); "
          f"cuFFT rfft -> multiply -> irfft {d['library_ms']:.4f} ms "
          f"({d['ms'] / d['library_ms']:.2f}x); plain {d['plain_ms']:.4f} ms; vs plain "
          f"max_abs_err={d['err']:.3e} limit={FFT_TOL}", flush=True)
    if not d["err"] <= FFT_TOL:
        raise RuntimeError(f"{label}: {d['err']} from the plain version")


def _against_staged(entry, rows, n, axis_plan, framed: bool, label: str) -> dict:
    """The wide cluster form against the copying staged form at n 262144 (B2's
    yardstick, never a path), in turns on the same rows: the two outputs'
    largest difference and each one's time."""
    from blur_algorithms_tpu_torch.benchmarks import fft_mxu_ablation as b2

    got = entry(rows, n, axis_plan)
    old = b2.staged_yardstick(rows, n, axis_plan, framed)
    torch.cuda.synchronize()
    diff = float((got - old).abs().max())
    del got, old
    t = _in_turns(label, {"current": lambda: entry(rows, n, axis_plan),
                          "staged": lambda: b2.staged_yardstick(rows, n, axis_plan, framed)})
    print(f"phase 20 {label} in turns with the copying staged form: current "
          f"{t['current']:.4f} ms, staged {t['staged']:.4f} ms "
          f"({t['current'] / t['staged']:.3f}x); outputs differ by {diff:.3e} "
          f"(limit {FFT_TOL})", flush=True)
    if not diff <= FFT_TOL:
        raise RuntimeError(f"the wide form and the copying staged form differ by {diff} at "
                           f"{label}")
    return {"current_ms": t["current"], "staged_ms": t["staged"]}


def _route_in_turns(entry, rows, n, axis_plan, framed: bool, label: str) -> dict:
    """n 262144 on the main path's ``rows`` as a card that places no cluster
    of 16 runs it (the staged form) against the plain version and this
    card's wide form on the same rows, then the two timed in turns."""
    from blur_algorithms_tpu_torch.cuda_kernels import fft4step
    from blur_algorithms_tpu_torch.ops.fft_mxu import _conv_rows_einsum

    plain = fft4step.fft_conv_rows_framed_ref if framed else _conv_rows_einsum
    before = (entry.cluster_launches, entry.staged_launches)
    staged = _staged_route(entry, rows, n, axis_plan)
    torch.cuda.synchronize()
    ran = (entry.cluster_launches - before[0], entry.staged_launches - before[1])
    wide = entry(rows, n, axis_plan)
    torch.cuda.synchronize()
    diff, equal = float((staged - wide).abs().max()), bool(torch.equal(staged, wide))
    del wide
    err = float((staged - plain(rows, n, axis_plan)).abs().max())
    del staged
    torch.cuda.empty_cache()
    t = _in_turns(label, {"wide": lambda: entry(rows, n, axis_plan),
                          "staged": lambda: _staged_route(entry, rows, n, axis_plan)})
    print(f"phase 20 {label} through the staged route (as on a card that places no cluster of "
          f"16; launches {ran}) in turns with the wide form: staged {t['staged']:.4f} ms, wide "
          f"{t['wide']:.4f} ms ({t['staged'] / t['wide']:.3f}x); staged vs plain "
          f"max_abs_err={err:.3e}, vs the wide form {diff:.3e} (bit-equal {equal}); limit "
          f"{FFT_TOL}", flush=True)
    if ran != (0, 1) or not err <= FFT_TOL or not diff <= FFT_TOL:
        raise RuntimeError(f"the staged route at {label}: launches {ran}, {err} from the plain "
                           f"version, {diff} from the wide form")
    return {"staged_ms": t["staged"], "wide_ms": t["wide"], "err": err,
            "vs_wide_max_abs_err": diff, "bit_equal_to_wide": equal}


def _slice19(smi: str) -> list[dict]:
    """Phase 20; returns the kernels-line entries of K3's and K3f's wide
    cluster form (where the card places a cluster of 16) and of their
    staged form, with its route at n 262144."""
    from blur_algorithms_tpu_torch import api, blur, blur_u8, make_plan
    from blur_algorithms_tpu_torch.cuda_kernels import fft4step
    from blur_algorithms_tpu_torch.ops.adjoint import blur_adjoint
    from blur_algorithms_tpu_torch.ops.fft_mxu import transform_length
    from blur_algorithms_tpu_torch.utils import timing
    from blur_algorithms_tpu_torch.utils.frames import make_frames_on

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    k3, k3f = fft4step.fft_conv_rows, fft4step.fft_conv_rows_framed
    _zero_cluster_counts(fft4step)
    errs = _phase20_kernels()
    # the form this card runs at n 262144: "cluster" (the wide form) where
    # it places a cluster of 16, else "staged"; the route as on a card that
    # places none is then driven beside it
    at = {"K3": _tag(fft4step, fft4step.CLUSTER_LONGEST, False),
          "K3f": _tag(fft4step, fft4step.CLUSTER_LONGEST, True)}
    wide = {k: f == "cluster" for k, f in at.items()}
    # launches on the slice's paths: of the cluster form at n 262144 (every
    # cluster launch of these paths; their other axes are one-block) and of
    # the staged form (past it, and on the route at it)
    launched = {"K3 cluster": 0, "K3f cluster": 0, "K3 staged": 0, "K3f staged": 0}
    mp = STRIP_H * STRIP_W / 1e6

    def strip_counts_ok(ran: dict, form: str) -> bool:
        """One frame's K3f launches at n 262144 on the rows (``form``) and
        the columns' one-block launch, no K3."""
        return (ran["fft_conv_rows_framed"] == 2 and ran[f"fft_conv_rows_framed {form}"] == 1
                and not ran[f"fft_conv_rows_framed {OTHER_FORM[form]}"]
                and not ran["fft_conv_rows"])

    # (b) blur_u8 AUTO on one 2160 x 140000 RGB frame at sigma 900: whole-frame
    # FFT_MXU, K3f at n 262144 on the rows, the one-block K3f on the columns
    img = make_frames_on("cuda", 1, STRIP_H, STRIP_W).movedim(1, -1).contiguous()
    plan = make_plan((STRIP_H, STRIP_W), SIGMA_STRIP)
    spec = api.device_spec(img.device)
    eng = api._resolve_engine("auto", plan, 1, img.device, 3)
    streams = api._fft_mxu_streams(plan, 3, spec)
    torch.cuda.synchronize()
    _zero_cluster_counts(fft4step)
    out = blur_u8(img, SIGMA_STRIP)
    torch.cuda.synchronize()
    ran = _k3_counts(fft4step)
    launched[f"K3f {at['K3f']}"] += ran[f"fft_conv_rows_framed {at['K3f']}"]
    ref = blur_u8(img, SIGMA_STRIP, engine="fft_tiles")
    d = (out.int() - ref.int()).abs()
    dmax, exact = int(d.max()), float((d == 0).float().mean())
    print(f"phase 20 main path: blur_u8 AUTO {tuple(img.shape)} sigma={SIGMA_STRIP} "
          f"r={plan.row.support_radius} -> {eng.value} (streams: {streams}; estimate "
          f"{api.estimate_bytes(plan, 3)} bytes, budget {spec.fft_mxu_byte_budget}; n "
          f"{transform_length(plan.row)}, {transform_length(plan.col)}; K3f's "
          f"{FORM_NAMES[at['K3f']]}): launches {ran}; vs fft_tiles (torch.fft) max={dmax} "
          f"exact={exact}", flush=True)
    if (eng is not api.Engine.FFT_MXU or streams or not strip_counts_ok(ran, at["K3f"])
            or dmax > 1):
        raise RuntimeError(f"blur_u8 AUTO at sigma {SIGMA_STRIP} on the strip: {eng}, {ran}, "
                           f"{dmax} counts from fft_tiles")
    t_route_u8 = None
    if wide["K3f"]:
        # (b') the same call as on a card that places no cluster of 16
        torch.cuda.synchronize()
        _zero_cluster_counts(fft4step)
        routed = _staged_route(blur_u8, img, SIGMA_STRIP)
        torch.cuda.synchronize()
        ran = _k3_counts(fft4step)
        launched["K3f staged"] += ran["fft_conv_rows_framed staged"]
        d = (routed.int() - ref.int()).abs()
        dmax = int(d.max())
        dwide = int((routed.int() - out.int()).abs().max())
        print(f"phase 20 main path: blur_u8 AUTO {tuple(img.shape)} sigma={SIGMA_STRIP} "
              f"routed as on a card that places no cluster of 16 (K3f's staged form at n "
              f"{transform_length(plan.row)}): launches {ran}; vs fft_tiles max={dmax} exact="
              f"{float((d == 0).float().mean())}; vs the wide form's output max={dwide}, "
              f"equal {torch.equal(routed, out)}", flush=True)
        if not strip_counts_ok(ran, "staged") or dmax > 1 or dwide > 1:
            raise RuntimeError(f"blur_u8 AUTO on the strip through the staged route: {ran}, "
                               f"{dmax} counts from fft_tiles, {dwide} from the wide form")
        del routed
        t_route_u8 = _in_turns(f"blur_u8 AUTO 2160x140000 sigma={SIGMA_STRIP}",
                               {"wide": lambda: blur_u8(img, SIGMA_STRIP),
                                "staged": lambda: _staged_route(blur_u8, img, SIGMA_STRIP)})
        print(f"phase 20 blur_u8 AUTO 2160x140000 sigma={SIGMA_STRIP} in turns: staged route "
              f"{t_route_u8['staged']:.4f} ms, wide form {t_route_u8['wide']:.4f} ms "
              f"({t_route_u8['staged'] / t_route_u8['wide']:.3f}x)", flush=True)
    del out, ref, d
    t_strip = {
        "auto": timing.time_cuda(blur_u8, img, SIGMA_STRIP, iters=GIANT_ITERS, warmup=1,
                                 name=f"blur_u8 AUTO (fft_mxu) 2160x140000 sigma={SIGMA_STRIP}",
                                 megapixels=mp),
        "fused": timing.time_cuda(blur_u8, img, SIGMA_STRIP, "fused", iters=GIANT_ITERS,
                                  warmup=1, name=f"blur_u8 fused 2160x140000 sigma={SIGMA_STRIP}",
                                  megapixels=mp),
    }
    # K3f alone on the frame's rows: 6480 rows of 140000, n 262144; in turns
    # with the copying staged form there, and with the staged route
    rows = img[0].movedim(-1, 0).reshape(-1, STRIP_W).float()
    del img
    torch.cuda.empty_cache()
    label = f"K3f {FORM_NAMES[at['K3f']]} 2160x140000 rows sigma={SIGMA_STRIP}"
    k3f_d = _kernel_times(k3f, rows, transform_length(plan.row), plan.row, True, label, 20)
    _form_times(label, k3f_d)
    k3f_d["in_turns"] = _against_staged(k3f, rows, transform_length(plan.row), plan.row, True,
                                        label)
    k3f_route = (_route_in_turns(k3f, rows, transform_length(plan.row), plan.row, True, label)
                 if wide["K3f"] else None)
    del rows
    torch.cuda.empty_cache()

    # (c) the streamed path: blur_u8 AUTO on four such frames, on this card's
    # route and on the staged route
    img = make_frames_on("cuda", BATCH, STRIP_H, STRIP_W).movedim(1, -1).contiguous()
    eng = api._resolve_engine("auto", plan, 1, img.device, BATCH * 3)
    streams = api._fft_mxu_streams(plan, BATCH * 3, spec)
    row_strips = -(-STRIP_H // 1024)
    outs = {}
    for form in ("card", "staged") if wide["K3f"] else ("card",):
        whole, whole_fn = [], api.blur_fft_mxu_cuda
        api.blur_fft_mxu_cuda = lambda *a: whole.append(1) or whole_fn(*a)
        try:
            torch.cuda.synchronize()
            _zero_cluster_counts(fft4step)
            outs[form] = (_staged_route(blur_u8, img, SIGMA_STRIP) if form == "staged"
                          else blur_u8(img, SIGMA_STRIP))
            torch.cuda.synchronize()
            ran = _k3_counts(fft4step)
        finally:
            api.blur_fft_mxu_cuda = whole_fn
        ran_form = at["K3f"] if form == "card" else "staged"
        launched[f"K3f {ran_form}"] += ran[f"fft_conv_rows_framed {ran_form}"]
        single = blur_u8(img[:1], SIGMA_STRIP)  # one frame: whole-frame, as (b)
        d = (outs[form][:1].int() - single.int()).abs()
        dmax, exact = int(d.max()), float((d == 0).float().mean())
        del single, d
        dcard = int((outs[form].int() - outs["card"].int()).abs().max())
        how = (f"K3f's {FORM_NAMES[ran_form]}" if form == "card" else
               "routed as on a card that places no cluster of 16")
        print(f"phase 20 main path: blur_u8 AUTO {tuple(img.shape)} sigma={SIGMA_STRIP} -> "
              f"{eng.value} (streams: {streams}, estimate {api.estimate_bytes(plan, BATCH * 3)} "
              f"bytes; {how}); launches {ran}, whole-frame calls {len(whole)}; frame 0 vs the "
              f"single-frame call max={dmax} exact={exact}; vs this card's route max={dcard}",
              flush=True)
        if (eng is not api.Engine.FFT_MXU or not streams or whole
                or ran[f"fft_conv_rows_framed {ran_form}"] != row_strips
                or ran[f"fft_conv_rows_framed {OTHER_FORM[ran_form]}"] or ran["fft_conv_rows"]
                or dmax > 1 or dcard > 1):
            raise RuntimeError(f"blur_u8 AUTO on 4 strips did not stream through K3f's "
                               f"{FORM_NAMES[ran_form]} within 1 count: {ran}, {len(whole)}, "
                               f"{dmax}, {dcard}")
    del outs
    t_streamed = timing.time_cuda(blur_u8, img, SIGMA_STRIP, iters=GIANT_ITERS, warmup=1,
                                  name=f"blur_u8 AUTO streamed 4x2160x140000 sigma={SIGMA_STRIP}",
                                  megapixels=BATCH * mp)
    del img
    torch.cuda.empty_cache()

    def fwd_bwd_checked(shape, planes: int, seed: int, what: str,
                        route: bool = False) -> tuple:
        """blur AUTO forward + backward at SIGMA_F32_WIDE on ``planes`` float
        planes of ``shape`` (``route``: as on a card that places no cluster
        of 16): the counts of each direction, x.grad against
        blur_adjoint(g) and the adjoint identity; returns (x, plan, fwd,
        bwd, the adjoint rows' n)."""
        x = make_frames_on("cuda", 1, *shape)[:, :planes].float().contiguous()
        fplan = make_plan(shape, SIGMA_F32_WIDE)
        g = torch.rand(x.shape, generator=torch.Generator(x.device).manual_seed(seed),
                       device=x.device)
        xg = x.clone().requires_grad_()
        with _no_cluster_of_16(fft4step) if route else contextlib.nullcontext():
            torch.cuda.synchronize()
            _zero_cluster_counts(fft4step)
            y = blur(xg, SIGMA_F32_WIDE)
            torch.cuda.synchronize()
            fwd = _k3_counts(fft4step)
            _zero_cluster_counts(fft4step)
            (y * g).sum().backward()
            torch.cuda.synchronize()
            bwd = _k3_counts(fft4step)
            want = blur_adjoint(g, fplan)  # a check: its launches are not the path's
        torch.cuda.synchronize()
        gerr = float((xg.grad - want).abs().max())
        lhs = float((y.detach().double() * g.double()).sum())
        rhs = float((x.double() * xg.grad.double()).sum())
        rel = abs(lhs - rhs) / abs(lhs)
        r = fplan.row.support_radius
        n_adj = max(256, 1 << (shape[1] + 4 * r - 1).bit_length())  # the adjoint's rows
        print(f"phase 20 main path: blur AUTO forward + backward {tuple(x.shape)} f32 "
              f"sigma={SIGMA_F32_WIDE} r={r} (rows n {transform_length(fplan.row)}; adjoint "
              f"rows n {n_adj}; {what}): forward launches {fwd}, backward {bwd}; x.grad vs "
              f"blur_adjoint(g) max={gerr:.3e}; adjoint identity <Ax, g> {lhs:.9e} vs "
              f"<x, A^T g> {rhs:.9e}, relative {rel:.3e} limit 1e-5", flush=True)
        if not gerr <= 1e-6 * float(want.abs().max()) or not rel <= 1e-5:
            raise RuntimeError(f"x.grad differs from blur_adjoint(g) by {gerr}, or the adjoint "
                               f"identity is off by {rel}")
        del y, g, want, xg
        torch.cuda.empty_cache()
        return x, fplan, fwd, bwd, n_adj

    def f32_counts_ok(fwd: dict, bwd: dict, f3: str, f3f: str) -> bool:
        """K3f at n 262144 on the rows forward (``f3f``) and the one-block
        K3f on the columns; K3 at 262144 on the adjoint's rows backward
        (``f3``) and the one-block K3 on its columns."""
        return (fwd["fft_conv_rows_framed"] == 2 and fwd[f"fft_conv_rows_framed {f3f}"] == 1
                and not fwd[f"fft_conv_rows_framed {OTHER_FORM[f3f]}"]
                and not fwd["fft_conv_rows"] and bwd["fft_conv_rows"] == 2
                and bwd[f"fft_conv_rows {f3}"] == 1 and not bwd[f"fft_conv_rows {OTHER_FORM[f3]}"]
                and not bwd["fft_conv_rows_framed"])

    def fwd_bwd(t):
        t = t.detach().requires_grad_()
        blur(t, SIGMA_F32_WIDE).backward(torch.ones_like(t))
        return t.grad

    # (d) blur AUTO forward + backward on (1, 3, 2160, 131072) f32 at sigma
    # 400: K3f at n 262144 on the rows forward, K3 on the adjoint's rows
    x, plan, fwd, bwd, n_adj = fwd_bwd_checked(
        (STRIP_H, PANO_F32_W), 3, 20, f"K3/K3f's {FORM_NAMES[at['K3']]}")
    launched[f"K3 {at['K3']}"] += bwd[f"fft_conv_rows {at['K3']}"]
    launched[f"K3f {at['K3f']}"] += fwd[f"fft_conv_rows_framed {at['K3f']}"]
    if not f32_counts_ok(fwd, bwd, at["K3"], at["K3f"]):
        raise RuntimeError(f"the f32 blur launched {fwd} forward, {bwd} backward")
    t_f32 = timing.time_cuda(fwd_bwd, x, iters=GIANT_ITERS, warmup=1,
                             name=f"blur AUTO forward + backward 3x2160x{PANO_F32_W} "
                                  f"sigma={SIGMA_F32_WIDE}",
                             megapixels=3 * STRIP_H * PANO_F32_W / 1e6)
    t_route_f32 = None
    if wide["K3"] and wide["K3f"]:
        # (d') the same call as on a card that places no cluster of 16
        xs, _, fwd, bwd, _ = fwd_bwd_checked((STRIP_H, PANO_F32_W), 3, 20,
                                             "routed as on a card that places no cluster of 16",
                                             route=True)
        del xs
        launched["K3 staged"] += bwd["fft_conv_rows staged"]
        launched["K3f staged"] += fwd["fft_conv_rows_framed staged"]
        if not f32_counts_ok(fwd, bwd, "staged", "staged"):
            raise RuntimeError(f"the f32 blur's staged route launched {fwd} forward, {bwd} "
                               f"backward")
        routed, own = _staged_route(fwd_bwd, x), fwd_bwd(x)
        torch.cuda.synchronize()
        dgrad = float((routed - own).abs().max())
        print(f"phase 20 main path: blur AUTO forward + backward x.grad, the staged route vs "
              f"the wide form: max={dgrad:.3e} (limit {FFT_TOL}), equal "
              f"{torch.equal(routed, own)}", flush=True)
        del routed, own
        if not dgrad <= FFT_TOL:
            raise RuntimeError(f"the f32 blur's gradient through the staged route is {dgrad} "
                               f"from the wide form's")
        t_route_f32 = _in_turns(f"blur AUTO forward + backward 3x2160x{PANO_F32_W}",
                                {"wide": lambda: fwd_bwd(x),
                                 "staged": lambda: _staged_route(fwd_bwd, x)})
        print(f"phase 20 blur AUTO forward + backward 3x2160x{PANO_F32_W} sigma="
              f"{SIGMA_F32_WIDE} in turns: staged route {t_route_f32['staged']:.4f} ms, wide "
              f"form {t_route_f32['wide']:.4f} ms "
              f"({t_route_f32['staged'] / t_route_f32['wide']:.3f}x)", flush=True)
    # K3 alone on the adjoint's rows (6480 rows of 131072 + 4 r -> 262144); in
    # turns with the copying staged form there, and with the staged route
    r = plan.row.support_radius
    padded = torch.nn.functional.pad(x.reshape(-1, PANO_F32_W),
                                     (2 * r, n_adj - PANO_F32_W - 2 * r)).contiguous()
    del x
    torch.cuda.empty_cache()
    label = f"K3 {FORM_NAMES[at['K3']]} adjoint rows sigma={SIGMA_F32_WIDE}"
    k3_d = _kernel_times(k3, padded, n_adj, plan.row, False, label, 20)
    _form_times(label, k3_d)
    k3_d["in_turns"] = _against_staged(k3, padded, n_adj, plan.row, False, label)
    k3_route = (_route_in_turns(k3, padded, n_adj, plan.row, False, label)
                if wide["K3"] else None)
    del padded
    torch.cuda.empty_cache()

    # (e) the staged form on a path: blur AUTO forward + backward on one
    # 1400 x 262000 f32 plane at sigma 400 (rows n 524288 forward, K3f; the
    # adjoint's rows 262000 + 4 r -> 524288, K3)
    x, plan, fwd, bwd, n_adj = fwd_bwd_checked((WIDE_H, WIDE_W), 1, 21, "the staged form")
    launched["K3 staged"] += bwd["fft_conv_rows staged"]
    launched["K3f staged"] += fwd["fft_conv_rows_framed staged"]
    if (fwd["fft_conv_rows_framed staged"] != 1 or bwd["fft_conv_rows staged"] != 1
            or fwd["fft_conv_rows_framed cluster"] or bwd["fft_conv_rows cluster"]
            or transform_length(plan.row) != 524288 or n_adj != 524288):
        raise RuntimeError(f"the 1400 x 262000 blur launched {fwd} forward, {bwd} backward")
    label = f"K3f staged form 1400x{WIDE_W} rows sigma={SIGMA_F32_WIDE}"
    staged_f = _kernel_times(k3f, x.reshape(-1, WIDE_W), 524288, plan.row, True, label, 20)
    _form_times(label, staged_f)
    r = plan.row.support_radius
    padded = torch.nn.functional.pad(x.reshape(-1, WIDE_W),
                                     (2 * r, n_adj - WIDE_W - 2 * r)).contiguous()
    del x
    torch.cuda.empty_cache()
    label = f"K3 staged form adjoint rows 1400x{WIDE_W} sigma={SIGMA_F32_WIDE}"
    staged_k = _kernel_times(k3, padded, n_adj, plan.row, False, label, 20)
    _form_times(label, staged_k)
    del padded
    torch.cuda.empty_cache()

    for res in (*t_strip.values(), t_streamed, t_f32):
        print(f"phase 20 time: {res}", flush=True)
    print(f"phase 20 launches past 131072 on the slice's paths: {launched}; "
          f"{time.perf_counter() - t0:.1f} s ({smi})", flush=True)
    for name, n in launched.items():
        kernel, form = name.split()
        if n < 1 and (form == "staged" or wide[kernel]):
            raise RuntimeError(f"{name} form was not launched on the main path")
    entry = lambda name, line, n, d, err, **more: {  # noqa: E731
        "name": name, "route": "cuda", "source": "blur_algorithms_tpu_torch/csrc/fft4step.cu",
        "replaces": line, "launches": n, "max_abs_err": err, "ms": d["ms"],
        "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"], "bound_by": d["bound_by"],
        "library_ms": d["library_ms"], **more,
    }

    def at_262144(d: dict, route: dict | None, calls: dict | None) -> dict:
        """The staged form at n 262144, the route of a card that places no
        cluster of 16: its time on the main path's rows (in turns with the
        wide form where this card has it), beside the same work's bound,
        plain version and cuFFT (``d``), and the calls in turns."""
        if route is None:  # this card routes 262144 to the staged form: d timed it
            return {"ms": d["ms"], "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
                    "library_ms": d["library_ms"], "max_abs_err": d["err"]}
        return {"ms": route["staged_ms"], "wide_ms": route["wide_ms"],
                "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
                "library_ms": d["library_ms"], "max_abs_err": route["err"],
                "vs_wide_max_abs_err": route["vs_wide_max_abs_err"],
                "bit_equal_to_wide": route["bit_equal_to_wide"],
                "call_in_turns_ms": calls}

    routes = ["n 262144 where the card places no cluster of 16 CTAs", "every power of two "
              "past 262144"]
    k3_line, k3f_line = ("blur_algorithms_tpu/pallas_kernels/fft4step.py:138",
                         "blur_algorithms_tpu/pallas_kernels/fft4step.py:157")
    wide_entries = [
        entry("fft4step_wide", k3_line, launched["K3 cluster"], k3_d,
              max(errs["K3 cluster"], k3_d["err"]), in_turns_with_staged=k3_d["in_turns"]),
        entry("fft4step_framed_wide", k3f_line, launched["K3f cluster"], k3f_d,
              max(errs["K3f cluster"], k3f_d["err"]), in_turns_with_staged=k3f_d["in_turns"]),
    ]
    return [
        *(e for e, kernel in zip(wide_entries, ("K3", "K3f")) if wide[kernel]),
        entry("fft4step_staged", k3_line, launched["K3 staged"], staged_k,
              max(errs["K3 staged"], staged_k["err"]), routes=routes,
              at_262144=at_262144(k3_d, k3_route, t_route_f32)),
        entry("fft4step_framed_staged", k3f_line, launched["K3f staged"], staged_f,
              max(errs["K3f staged"], staged_f["err"]), routes=routes,
              at_262144=at_262144(k3f_d, k3f_route, t_route_u8)),
    ]


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
        # int8 bit-equal to the plain version; hybrid and bf16 (tensor-core
        # groups of 16 taps against tap-by-tap sums) within 1 count
        if not (err <= 1 if prec in ("hybrid", "bf16") else torch.equal(out, ref)):
            raise RuntimeError(f"blur_u8 ({prec}) differs from the plain version by {err}")
        d = np.abs(out[0].cpu().numpy().astype(int) - want0.astype(int))
        what = "AUTO" if auto else f"precision='{prec}'"
        print(f"phase 3 main path: blur_u8 {what} {tuple(x.shape)} sigma={SIGMA}: rung {prec}, "
              f"{body.__name__} launches={body.launches}, vs plain version max_abs_err={err} "
              f"({'equal' if prec == 'int8' else 'limit 1'}), "
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
    slice16_kernels = _slice16()
    _slice18(smi)
    slice19_kernels = _slice19(smi)

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
        *slice7_kernels, *slice11_kernels, *slice16_kernels, *slice19_kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
