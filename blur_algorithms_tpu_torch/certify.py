"""Certify the fast precision rungs on a CUDA device; print its DeviceSpec entry.

The port's copy of the JAX package's certification runbook
(``benchmarks/default_prec_cert.py``, ``hybrid_split_cert.py`` and
``certify_device.py``), run on the card against the port's own oracles
(``oracle.blur_u8``, ``oracle.blur_planar_fft2`` and the O(1)-per-pixel box
oracle ``box_oracle_u8``):

1. ``dma``: K1's hybrid and bf16 bodies on nine adversarial patterns
   (``patterns``) at 1088x1920, over a sigma grid (gaussian taps) or a box
   radius grid (box_fast taps, two passes); each pattern's oracle is
   computed once and shared by the rungs. The gate is max <= 1 count; the
   certified floor is the smallest radius from which every measured radius
   passes (``certified_min_radius``).
2. ``split``: the two-pass split's pass 2, int8 and hybrid, on the int16
   ``E`` of the int8 rows pass: gaussian column radius 1..4094 on 8200x256
   frames (sigma ``(sigma_y, 10)``; the JAX sweep's 7424 rows would clamp
   the radius at 3712), box support 2..1022 on 2560x1280. The JAX sweep
   starts at its split radius; the port's split runs from a smaller one,
   and an anisotropic plan runs its pass 2 at any column radius, so the
   sweep starts under the smallest hybrid floor. The ceiling is the
   largest radius before the first failure (``split_ceiling``).
3. ``route``: hybrid and bf16 against int8 on K1 at a radius ladder, and
   the split's hybrid pass 2 against its int8 pass 2, in turns on a batch
   of 4 RGB 2160x3840 frames (CUDA events). A rung routes from the smallest
   radius from which it is at least as fast at every radius upward
   (``route_floor``: 0 where it wins everywhere, None where it never does),
   counting only the radii under the device's uint8 split radius (the
   record's ``k1_ceiling``): from there AUTO runs the split, not K1, so
   K1's times past it route nothing; the split's hybrid pass 2 keeps its
   ceiling only if it is at least as fast everywhere.

Run on the card from the repository root:

    python -m blur_algorithms_tpu_torch.certify [--sections dma,split,route]
        [--precision hybrid bf16] [--kernel gaussian box_fast] [--out FILE]

It prints one JSON line per case, then the record and a ready-to-paste
``utils/hw._MEASURED_PRECISION`` entry; it exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import functools
import json
import sys

import numpy as np
import torch

# the JAX protocol's grids: default_prec_cert.py (sigmas) and
# certify_device.py (box radii, route ladder)
SIGMAS = (1.3, 1.6, 2.0, 2.5, 3.0, 4.0, 5.0, 6.0, 8.0, 10.0, 13.0, 16.0, 24.0,
          32.0, 48.0, 64.0, 100.0, 150.0, 250.0)
BOX_RADII = (1, 2, 3, 4, 6, 8, 12, 16, 24, 48, 96, 150, 300)
DMA_HW = (1088, 1920)
# the split's pass 2: every column radius the split may run it at, from
# under the smallest hybrid floor (an anisotropic plan runs the split on its
# row radius, whatever its column radius) to the split's reach
SPLIT_GAUSS_HW = (8200, 256)
SPLIT_GAUSS_R = (2, 3, 5, 8, 12, 17, 25, 33, 49, 65, 100, 165, 249, 332, 498, 665,
                 1000, 1330, 1800, 2400, 3000, 3450, 4096)
SPLIT_BOX_HW = (2560, 1280)
SPLIT_BOX_RADII = (1, 2, 4, 8, 12, 16, 24, 48, 96, 166, 250, 300, 400, 511)  # support 2..1022
ROUTE_R = (7, 17, 33, 65, 105, 165, 332, 598)
SPLIT_ROUTE_SIGMAS = (100.0, 250.0, 400.0)  # r 332, 831, 1330
ROUTE_BATCH, ROUTE_HW = 4, (2160, 3840)
# sigma per unit of support radius of the port's gaussian width rule
R_PER_SIGMA = 3.3267


def patterns(h: int, w: int, seed: int) -> dict[str, np.ndarray]:
    """Adversarial uint8 content (C=3 planar) for rounding-boundary hunts
    (the JAX ``default_prec_cert.patterns``)."""
    rng = np.random.default_rng(seed)
    out = {
        "uniform": (rng.random((3, h, w)) * 255).astype(np.uint8),
        "salt": (rng.random((3, h, w)) < 0.5).astype(np.uint8) * 255,
    }
    yy, xx = np.mgrid[:h, :w]
    for p in (1, 3, 8, 31):
        out[f"checker{p}"] = np.broadcast_to(
            (((yy // p) + (xx // p)) % 2 * 255).astype(np.uint8), (3, h, w)
        ).copy()
    step = np.zeros((3, h, w), np.uint8)
    step[:, :, w // 2:] = 255
    step[:, h // 2:, :] ^= 255
    out["step"] = step
    # near-boundary grays: values whose blurred means sit at .5 boundaries
    out["gray127"] = np.full((3, h, w), 127, np.uint8)
    g = out["gray127"].copy()
    g[:, ::2, ::2] = 128
    out["gray127_128"] = g
    return out


def box_oracle_u8(img: np.ndarray, radius: int, passes: int = 2) -> np.ndarray:
    """FastBoxBlur oracle for planar uint8 ``(C, H, W)`` in O(1) a pixel:
    sequential reflect-101 box passes by float64 cumulative-sum differences
    (the JAX ``default_prec_cert.box_oracle_u8``)."""
    w = 2 * radius + 1

    def box1(a: np.ndarray, axis: int) -> np.ndarray:
        pad = [(0, 0)] * a.ndim
        pad[axis] = (radius, radius)
        ap = np.pad(a, pad, mode="reflect")
        cs = np.cumsum(ap, axis=axis, dtype=np.float64)
        zero = np.zeros_like(np.take(cs, [0], axis=axis))
        cs = np.concatenate([zero, cs], axis=axis)
        hi = np.take(cs, range(w, cs.shape[axis]), axis=axis)
        lo = np.take(cs, range(0, cs.shape[axis] - w), axis=axis)
        return (hi - lo) / w

    out = img.astype(np.float64)
    for _ in range(passes):
        out = box1(out, -1)
        out = box1(out, -2)
    return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)


def gauss_oracle_u8(img: np.ndarray, plan) -> np.ndarray:
    """``oracle.blur_u8`` of planar ``(C, H, W)`` on this plan."""
    from blur_algorithms_tpu_torch import oracle

    out = oracle.blur_planar_fft2(img.astype(np.float32), plan)
    return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)


def certified_min_radius(rows: list[dict]) -> int | None:
    """The smallest radius from which every measured radius (this one and
    above) passes the gate (the JAX ``default_prec_cert`` rule)."""
    for row in sorted(rows, key=lambda r: r["radius"]):
        if all(q["max"] <= 1 for q in rows if q["radius"] >= row["radius"]):
            return row["radius"]
    return None


def split_ceiling(rows: list[dict]) -> int | None:
    """The largest radius of the split's hybrid pass 2 before its first
    failing radius (the JAX ``hybrid_split_cert`` rule)."""
    ok = None
    for row in sorted(rows, key=lambda r: r["radius"]):
        if row["max"]["hybrid"] > 1:
            break
        ok = row["radius"]
    return ok


def route_floor(rows: dict, fast: str) -> int | None:
    """The smallest probed radius from which ``fast`` is at least as fast as
    int8 at every radius upward: 0 where that is every probed radius, None
    where it is none (the JAX ``derive_route_floor``, whose 10**9 is None
    here)."""
    radii = sorted(rows)
    floor = None
    for r in reversed(radii):
        if rows[r][fast] <= rows[r]["int8"]:
            floor = r
        else:
            break
    if floor is None:
        return None
    return 0 if floor == radii[0] else rows[floor]["radius"]


def _plan(shape, kernel: str, x):
    from blur_algorithms_tpu_torch.ops.plan import make_plan

    if kernel == "box_fast":
        return make_plan(shape, int(x), kernel="box_fast", box_passes=2)
    return make_plan(shape, x)


def _max_diff(got: torch.Tensor, want: np.ndarray) -> int:
    return int((got.int() - torch.from_numpy(want).to(got.device).int()).abs().max())


def _oracles(pats: dict, kernel: str, x, plan) -> dict[str, np.ndarray]:
    """Every pattern's oracle, in threads (the FFTs and sums release the
    interpreter lock)."""
    def one(img):
        if kernel == "box_fast":
            return box_oracle_u8(img, int(x), 2)
        return gauss_oracle_u8(img, plan)

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        return dict(zip(pats, pool.map(one, pats.values())))


def dma_sweep(precisions, kernel: str, grid=None, hw=DMA_HW, seed: int = 5,
              log=print) -> dict[str, list[dict]]:
    """K1's ``precisions`` bodies on the patterns over the grid; one row per
    measured radius and rung."""
    from blur_algorithms_tpu_torch.cuda_kernels import fused_dma

    bodies = {"hybrid": fused_dma.blur_fused_u8_hybrid, "bf16": fused_dma.blur_fused_u8_bf16}
    grid = grid or (BOX_RADII if kernel == "box_fast" else SIGMAS)
    pats = patterns(*hw, seed)
    dev = {k: torch.from_numpy(v).cuda() for k, v in pats.items()}
    rows = {p: [] for p in precisions}
    for x in grid:
        plan = _plan(hw, kernel, x)
        r = max(plan.col.support_radius, plan.row.support_radius)
        serve = [p for p in precisions
                 if fused_dma.dma_form_applicable(torch.uint8, plan, p)]
        if not serve:
            log(json.dumps({"kernel": kernel, "x": x, "radius": r, "skip": "past K1"}))
            continue
        want = _oracles(pats, kernel, x, plan)
        for p in serve:
            per = {name: _max_diff(bodies[p](dev[name], plan), want[name])
                   for name in pats}
            row = {"precision": p, "kernel": kernel, "x": x, "radius": r,
                   "max": max(per.values()), "per_pattern": per}
            rows[p].append(row)
            log(json.dumps(row))
    return rows


def split_sweep(kernel: str, grid=None, hw=None, seed: int = 7, log=print) -> list[dict]:
    """The split's two pass 2 forms, int8 and hybrid, over the split regime
    (or the column radii ``grid``, box radii per pass for box taps, on
    frames of shape ``hw``)."""
    from blur_algorithms_tpu_torch.cuda_kernels import fused_blur, fused_split

    box = kernel == "box_fast"
    grid = grid or (SPLIT_BOX_RADII if box else SPLIT_GAUSS_R)
    hw = hw or (SPLIT_BOX_HW if box else SPLIT_GAUSS_HW)
    pats = patterns(*hw, seed + 1 if box else seed)
    rows = []
    for x in grid:
        if box:
            plan = _plan(hw, kernel, x)
        else:
            sigma = x / R_PER_SIGMA
            plan = _plan(hw, kernel, (sigma, 10.0))
            while plan.col.support_radius > x:
                sigma *= 0.999
                plan = _plan(hw, kernel, (sigma, 10.0))
            x = round(sigma, 3)
        rows_plan, cols_plan = fused_blur._split_plans(plan)
        want = _oracles(pats, kernel, x, plan)
        per = {"int8": {}, "hybrid": {}}
        for name, img in pats.items():
            e = fused_split.fused_split_rows_int8(torch.from_numpy(img).cuda(), rows_plan)
            for form, pass2 in (("int8", fused_split.fused_split_cols_int8),
                                ("hybrid", fused_split.fused_split_cols_hybrid)):
                per[form][name] = _max_diff(pass2(e, cols_plan), want[name])
        row = {"kernel": kernel, "shape": list(hw), "x": x,
               "radius": plan.col.support_radius,
               "max": {f: max(v.values()) for f, v in per.items()},
               "per_pattern": per}
        rows.append(row)
        log(json.dumps(row))
    return rows


def _in_turns(fns: dict, *args, iters: int = 10) -> dict[str, float]:
    """Each call timed in turns (forward, then backward order); the mean of
    its two medians (CUDA events)."""
    from blur_algorithms_tpu_torch.utils.timing import time_cuda

    names = list(fns)
    t = {k: [] for k in names}
    for name in names + names[::-1]:
        t[name].append(time_cuda(fns[name], *args, iters=iters, warmup=1,
                                 name=name).median_ms)
    return {k: float(np.mean(v)) for k, v in t.items()}


def k1_ceiling(spec) -> int | None:
    """The radius from which AUTO runs the split in place of K1 on uint8
    frames on a device of ``spec`` (``fused_blur._split_wins``), or None
    where K1 runs to its domain."""
    if spec.fused_split_min_radius_u8 is not None:
        return spec.fused_split_min_radius_u8
    return spec.fused_split_min_radius


def route_probe(precisions, log=print) -> dict:
    """K1's rungs against int8 at the radius ladder, and the split's pass 2
    forms at the split ladder, on a batch of RGB 4K frames; with the
    device's ``k1_ceiling``."""
    from blur_algorithms_tpu_torch.cuda_kernels import fused_blur, fused_dma, fused_split
    from blur_algorithms_tpu_torch.ops.plan import make_plan
    from blur_algorithms_tpu_torch.utils.frames import make_frames
    from blur_algorithms_tpu_torch.utils.hw import device_spec

    x = torch.from_numpy(make_frames(ROUTE_BATCH, *ROUTE_HW)).cuda()
    bodies = {"int8": functools.partial(fused_dma.blur_fused_u8_dma, direct=True),
              "hybrid": fused_dma.blur_fused_u8_hybrid, "bf16": fused_dma.blur_fused_u8_bf16}
    k1 = {}
    for rt in ROUTE_R:
        plan = make_plan(ROUTE_HW, rt / R_PER_SIGMA)
        fns = {p: (lambda t, f=bodies[p]: f(t, plan)) for p in ("int8", *precisions)}
        k1[rt] = {"radius": plan.row.support_radius, **_in_turns(fns, x)}
        log(json.dumps({"route": "K1", "r": rt, **k1[rt]}))
    split = {}
    for sigma in SPLIT_ROUTE_SIGMAS:
        plan = make_plan(ROUTE_HW, sigma)
        rows_plan, cols_plan = fused_blur._split_plans(plan)
        e = fused_split.fused_split_rows_int8(x, rows_plan)
        fns = {"int8": lambda t: fused_split.fused_split_cols_int8(t, cols_plan),
               "hybrid": lambda t: fused_split.fused_split_cols_hybrid(t, cols_plan)}
        r = plan.col.support_radius
        split[r] = {"radius": r, **_in_turns(fns, e)}
        log(json.dumps({"route": "split pass 2", "r": r, **split[r]}))
        del e
    return {"k1": k1, "split": split, "k1_ceiling": k1_ceiling(device_spec(x.device))}


def entry(record: dict) -> dict[str, int | None]:
    """The ``_MEASURED_PRECISION`` entry of a record: the DeviceSpec fields
    of the measured sweeps (fields of sweeps not run are left out). bf16 has
    one floor, from the gaussian sweep, as in the JAX package; its box sweep
    is a record only."""
    out = {}
    for (prec, kernel), rows in record.get("dma", {}).items():
        if kernel == "box_fast" and prec == "bf16":
            continue
        field = f"{prec}_cert_min_radius" + ("_box" if kernel == "box_fast" else "")
        out[field] = certified_min_radius(rows)
    route = record.get("route")
    split_fast = route is None or all(v["hybrid"] <= v["int8"]
                                      for v in route["split"].values())
    for kernel, rows in record.get("split", {}).items():
        field = "hybrid_split_cert_max_radius" + ("_box" if kernel == "box_fast" else "")
        out[field] = split_ceiling(rows) if split_fast else None
    if route is not None:
        ceiling = route.get("k1_ceiling")
        k1 = {rt: v for rt, v in route["k1"].items()
              if ceiling is None or v["radius"] < ceiling}
        for prec in ("hybrid", "bf16"):
            if any(prec in v for v in route["k1"].values()):
                out[f"{prec}_route_min_radius"] = route_floor(k1, prec)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sections", default="dma,split,route")
    ap.add_argument("--precision", nargs="+", default=["hybrid", "bf16"],
                    choices=["hybrid", "bf16"])
    ap.add_argument("--kernel", nargs="+", default=["gaussian", "box_fast"],
                    choices=["gaussian", "box_fast"])
    ap.add_argument("--out", help="write the whole record here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("certify needs a CUDA device; none is available", file=sys.stderr)
        return 2
    sections = set(args.sections.split(","))
    name = torch.cuda.get_device_name(0)
    record: dict = {"device": name}
    log = lambda line: print(line, flush=True)  # noqa: E731
    if "dma" in sections:
        record["dma"] = {}
        for kernel in args.kernel:
            for prec, rows in dma_sweep(args.precision, kernel, log=log).items():
                record["dma"][(prec, kernel)] = rows
    if "split" in sections:
        record["split"] = {k: split_sweep(k, log=log) for k in args.kernel}
    if "route" in sections:
        record["route"] = route_probe(args.precision, log=log)
    fields = entry(record)
    printable = dict(record, dma={f"{p}/{k}": v for (p, k), v in record.get("dma", {}).items()},
                     entry=fields)
    line = json.dumps(printable)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(f"\nready-to-paste utils/hw.py entry:\n_MEASURED_PRECISION[{name!r}] = "
          f"{json.dumps(fields, indent=4).replace('null', 'None')}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
