"""Readings that set a cell's limits, on the card at the cell's own size (not
run by the benchmark's runs).

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 ... --control-seeds 7 8 9

For each of ``--seeds``: the cell's input pool made from the seed as a run
makes it, one warm-up call and then one ``blur_u8`` call per pool tensor
through the window's own entry, each answer judged by the reference (the
lower readings are the largest of these). For each of ``--control-seeds``:
a whole run of the cell (``harness.run_cell``, a window of ``--seconds``)
with the control in the program's place, the reference computed in float8
e4m3 (``reference.blur_lower_precision``); its numbers go through the cell's
own comparison, and it has to come out not correct (the upper readings are
the smallest of these). ``--operand bfloat16`` runs the same reference at the
configurations' own bfloat16 in its place instead, a reading of what the
stated precision gives. One JSON line per reading on standard output.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import run as run_mod  # noqa: E402
from portbench import manifest as manifest_mod  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--operand", choices=("float8_e4m3fn", "bfloat16"), default="float8_e4m3fn")
    args = ap.parse_args(argv)
    manifest = manifest_mod.load()
    cell = manifest.cell(args.workload)
    run_mod.pin_devices(cell.chips)
    run_mod.cache_dirs()
    import torch

    from portbench import frames, harness, reference

    if not torch.cuda.is_available():
        print("portbench control: no CUDA card", file=sys.stderr)
        return 2
    from blur_algorithms_tpu_torch.api import blur_u8
    from blur_algorithms_tpu_torch.utils import build

    build.load_library()
    cfg, traffic = cell.config, cell.traffic
    shape = (cfg["batch"], cfg["height"], cfg["width"], cfg["channels"])
    sigma = harness.sigma_of(traffic, cfg)
    engine = traffic.get("engine", "auto")
    ops = None
    for seed in args.seeds:
        judgement = reference.Judgement()
        t0 = time.perf_counter()
        for k in range(int(traffic["pool"])):
            x = frames.make_frames("cuda", *shape, frames.frame_seed(seed, k))
            blur_u8(x, sigma, engine=engine)
            out = blur_u8(x, sigma, engine=engine)
            torch.cuda.synchronize()
            ops = ops or reference.Operators(shape[1], shape[2], sigma, x.device)
            reference.judge(out, x, sigma, judgement, ops)
            del x, out
        torch.cuda.synchronize()
        print(json.dumps({"cell": cell.name, "side": "program", "seed": seed,
                          **judgement.numbers(),
                          "seconds": time.perf_counter() - t0}), flush=True)
    del ops
    torch.cuda.empty_cache()
    low = {}
    operand = getattr(torch, args.operand)

    def control(img, sigma, engine="auto"):
        if "ops" not in low:
            low["ops"] = reference.Operators(shape[1], shape[2], sigma, img.device, operand)
        return reference.blur_lower_precision(img, sigma, operand, low["ops"])

    for seed in args.control_seeds:
        t0 = time.perf_counter()
        result, compared = harness.run_cell(manifest, cell, seed, args.seconds, False, "cuda",
                                            time.perf_counter(), blur_u8=control)
        print(json.dumps({"cell": cell.name, "side": f"control {args.operand}",
                          "seed": seed, "correct": result["correct"],
                          "attempted": result["attempted"], **result["judged"],
                          "checks": {n: {"value": v, "limit": lim, "passed": ok}
                                     for n, v, lim, ok in compared},
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
