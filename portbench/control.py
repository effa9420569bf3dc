"""Readings that set a cell's limits, on the card at the cell's own size (not
run by the benchmark's runs).

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 ... --control-seeds 7 8 9

For each of ``--seeds``: the cell's input pool made from the seed as a run
makes it, one warm-up call and then one call per pool tensor through the
window's own entry (``harness.make_entry``), the answers judged by the
reference (the lower readings are the largest of these). For each of
``--control-seeds``: a whole run of the cell (``harness.run_cell``, a window
of ``--seconds``) with the control in the program's place, the reference
computed one step below the configuration's precision: float8 e4m3 operands
for a ``blur_u8`` cell (``reference.blur_lower_precision``), TF32 operands
forward and backward for a ``blur`` cell (``reference.LowerPrecisionBlur``).
Its numbers go through the cell's own comparison, and it has to come out not
correct (the upper readings are the smallest of these). ``--operand``
computes the reference in another operand type in its place, such as the
configuration's own (``bfloat16``, ``float32``): a reading of what the stated
precision gives. One JSON line per reading on standard output.
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


def control_function(cell, operand, device):
    """The control of ``cell``'s entry in the program's place: the
    reference with ``operand`` operands (the step below the configuration's
    precision where None), its band matrices made once."""
    from portbench import harness, reference

    cfg = cell.config
    h, w = cfg["height"], cfg["width"]
    sigma = harness.sigma_of(cell.traffic, cfg)
    if harness.entry_name(cell.traffic) == "blur":
        ops = reference.Operators(h, w, sigma, device, operand or reference.FLOAT_CONTROL)

        def control(planes, sigma, engine="auto"):
            return reference.LowerPrecisionBlur.apply(planes, ops)
    else:
        ops = reference.Operators(h, w, sigma, device, operand or reference.CONTROL_DTYPE)

        def control(img, sigma, engine="auto"):
            return reference.blur_lower_precision(img, sigma, ops.operand, ops)
    return control


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--operand", choices=("float8_e4m3fn", "bfloat16", "float32"), default=None)
    args = ap.parse_args(argv)
    manifest = manifest_mod.load()
    cell = manifest.cell(args.workload)
    run_mod.pin_devices(cell.chips)
    run_mod.cache_dirs()
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("portbench control: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        entry = harness.make_entry(cell, seed, "cuda")
        kept = []
        for k in range(len(entry.pool)):
            entry.call(k)
            kept.append((k, entry.call(k)))
            torch.cuda.synchronize()
        values, numbers = entry.judge(kept)
        del entry, kept
        torch.cuda.empty_cache()
        print(json.dumps({"cell": cell.name, "side": "program", "seed": seed, "values": values,
                          **{k: run_mod.plain(v) for k, v in numbers.items()},
                          "seconds": time.perf_counter() - t0}), flush=True)
    operand = getattr(torch, args.operand) if args.operand else None
    control = control_function(cell, operand, "cuda") if args.control_seeds else None
    side = f"control {args.operand or 'one step below'}"
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        result, compared = harness.run_cell(manifest, cell, seed, args.seconds, False, "cuda",
                                            time.perf_counter(), fn=control)
        print(json.dumps({"cell": cell.name, "side": side, "seed": seed,
                          "correct": result["correct"], "attempted": result["attempted"],
                          **{k: run_mod.plain(v) for k, v in result["judged"].items()},
                          "checks": {n: {"value": run_mod.plain(v), "limit": lim,
                                         "passed": ok} for n, v, lim, ok in compared},
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
