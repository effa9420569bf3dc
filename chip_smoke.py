"""Chip smoke test of the PyTorch + CUDA port (blur_algorithms_tpu_torch).

Drives the port's main path on one CUDA card and fails loudly on any fault:

1. prints the card (``nvidia-smi`` name and power limit), then builds the
   CUDA kernels from ``blur_algorithms_tpu_torch/csrc`` and prints the time;
2. kernel vs plain version: K1 (the fused int8 blur) against its plain
   PyTorch version on the card, uint8 RGB 1080x1920 frames at
   sigma 1, 3, 10, 50, 150 and 180 (support radius up to 598), an
   anisotropic sigma (5, 11) and a ragged 1001x1777 frame; each must be
   ``torch.equal``;
3. main path of slice 1: ``blur_u8`` AUTO on a (4, 2160, 3840, 3) uint8
   CUDA tensor at sigma 10 (``bench.py``'s configuration, and its frames
   through the port's copy ``utils/frames.make_frames``); K1's launch count
   must rise, the result must equal the plain version bit for bit and
   frame 0 must be within 1 count of the NumPy oracle;
4. times from CUDA events (median of 20 after warm-up): K1 alone, the plain
   version, and the whole ``blur_u8`` with its layout copies;
5. K2 (the fused f32 blur) against its plain version on the card: f32
   planes 1080x1920 at sigma 1, 10, 50 and 180 (r up to 598), sigma
   (5, 11), a radius-0 row axis, asymmetric custom taps on both axes, a
   ragged 1001x1777 frame, and uint8 in / uint8 out with a signed sharpen
   filter; f32 within 1e-3 * max|x| / 255, uint8 within 1 count;
6. main path of slice 2: ``blur`` AUTO on the same batch as float planes
   (4, 3, 2160, 3840) at sigma 10 launches K2 and not K1, matches the plain
   version and (plane 0) the float64 direct oracle within 1e-3; its
   backward pass equals ``blur_adjoint`` of the cotangent and satisfies the
   adjoint identity <A x, g> = <x, A^T g> to 1e-5 relative; and
   ``convolve_separable`` with a signed 5-tap sharpen on the uint8 batch
   launches K2, not K1, within 1 count of the plain version;
7. times from CUDA events (median of 20): K2 alone, its plain version,
   ``blur`` forward, forward + backward, the uint8 ``convolve_separable``,
   and a yardstick the port never calls (reflect pad + two depthwise
   ``F.conv2d``, TF32 off).

The line before the last is a JSON object describing each kernel; the last
is ``{"ok": true, "device": {...}}``. Run from the repository root:

    python3 chip_smoke.py

It exits non-zero, printing no result, where no CUDA device is available.
"""

from __future__ import annotations

import json
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
HD, RAGGED = (1080, 1920), (1001, 1777)  # phase 5 frame shapes
SHARPEN5 = [-0.125, -0.25, 1.75, -0.25, -0.125]  # signed, sums to 1


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
    torch.cuda.synchronize()
    fused_dma.blur_fused_u8_dma.launches = 0
    fused_blur.blur_fused_f32.launches = 0
    out = blur(x, SIGMA)
    torch.cuda.synchronize()
    launches = fused_blur.blur_fused_f32.launches
    if launches < 1 or fused_dma.blur_fused_u8_dma.launches:
        raise RuntimeError(
            f"blur launched K2 {launches} and K1 "
            f"{fused_dma.blur_fused_u8_dma.launches} times")
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
          f"K2 launches={launches}, K1 launches=0, vs plain max_abs_err={err:.3e}, "
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
    for res in (k2, plain, fwd, both, conv, lib):
        print(f"phase 7 time: {res}", flush=True)
    print(f"phase 7 yardstick vs blur: max_abs_err={lib_err:.3e}", flush=True)

    outputs = x.numel()
    bound, by = _bound_ms(
        8 * outputs, 2 * outputs * (2 * rw + 1 + 2 * rh + 1), F32_FLOP_PER_S)
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


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")

    from blur_algorithms_tpu_torch import blur_u8, make_plan, oracle
    from blur_algorithms_tpu_torch.cuda_kernels import fused_blur, fused_dma
    from blur_algorithms_tpu_torch.utils import build, timing
    from blur_algorithms_tpu_torch.utils.frames import make_frames

    # ---- phase 1: the card, then the kernel build ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    build.load_library()
    ptxas = [ln.strip() for ln in build.last_build["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"phase 1 build: {build.last_build['library']} "
          f"(built now: {build.last_build['built']}) in "
          f"{time.perf_counter() - t0:.2f} s; ptxas: {' | '.join(ptxas)}",
          flush=True)

    # ---- phase 2: K1 against its plain version on the card ----
    cases = [((1080, 1920), s) for s in (1.0, 3.0, 10.0, 50.0, 150.0, 180.0)]
    cases += [((1080, 1920), (5.0, 11.0)), ((1001, 1777), SIGMA)]
    max_err = 0
    for k, ((h, w), sigma) in enumerate(cases):
        plan = make_plan((h, w), sigma)
        x = _case_frames(h, w, seed=k)
        got = fused_dma.blur_fused_u8_dma(x, plan)
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

    # ---- phase 3: the main path at bench.py's size ----
    frames = make_frames(BATCH, H, W)  # (B, C, H, W) uint8
    img = np.ascontiguousarray(np.moveaxis(frames, 1, -1))
    x = torch.from_numpy(img).cuda()
    plan = make_plan((H, W), SIGMA)
    torch.cuda.synchronize()
    fused_dma.blur_fused_u8_dma.launches = 0
    fused_blur.blur_fused_f32.launches = 0
    out = blur_u8(x, SIGMA)
    torch.cuda.synchronize()
    launches = fused_dma.blur_fused_u8_dma.launches
    if launches < 1:
        raise RuntimeError("blur_u8 did not launch K1")
    if fused_blur.blur_fused_f32.launches:
        raise RuntimeError("blur_u8 at sigma 10 launched K2")
    if out.shape != x.shape or out.dtype != torch.uint8 or out.device != x.device:
        raise RuntimeError(f"blur_u8 returned {out.shape} {out.dtype} {out.device}")
    planar = x.movedim(-1, -3).contiguous()
    ref = fused_dma.blur_fused_u8_dma_ref(planar, plan).movedim(-3, -1)
    torch.cuda.synchronize()
    err = int((out.int() - ref.int()).abs().max())
    max_err = max(max_err, err)
    if not torch.equal(out, ref):
        raise RuntimeError(f"blur_u8 differs from the plain version by {err}")
    want0 = oracle.blur_u8(img[0], SIGMA)
    d = np.abs(out[0].cpu().numpy().astype(int) - want0.astype(int))
    print(f"phase 3 main path: blur_u8 AUTO {tuple(x.shape)} sigma={SIGMA}: "
          f"K1 launches={launches}, equal to plain version=True, "
          f"frame 0 vs oracle max={int(d.max())} exact={float((d == 0).mean())}",
          flush=True)
    if d.max() > 1:
        raise RuntimeError(f"frame 0 is {int(d.max())} counts from the oracle")

    # ---- phase 4: times ----
    mp = BATCH * H * W / 1e6
    k1 = timing.time_cuda(fused_dma.blur_fused_u8_dma, planar, plan,
                          iters=ITERS, name="K1 fused_dma int8", megapixels=mp)
    plain = timing.time_cuda(fused_dma.blur_fused_u8_dma_ref, planar, plan,
                             iters=ITERS, name="plain version", megapixels=mp)
    whole = timing.time_cuda(blur_u8, x, SIGMA, iters=ITERS,
                             name="blur_u8 (with layout copies)", megapixels=mp)
    for res in (k1, plain, whole):
        print(f"phase 4 time: {res}", flush=True)

    k2 = _slice2(frames, make_plan, oracle, fused_blur, fused_dma, timing)

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
    }, k2]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
