"""Run one benchmark cell once on the card this process sees.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device`` and, traced, ``breakdown``;
its last key, ``checks``, holds each number compared with its limit, which
are also the last lines on standard error. Exits with another code than 0,
and prints no result, where no CUDA card (or fewer than the cell asks for)
is visible, where the port is missing beside the benchmark, or where the
process holds JAX or the JAX package once the window has closed.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import guard, manifest as manifest_mod  # noqa: E402


def process_start() -> float:
    """The ``time.perf_counter()`` reading at this process's start, from
    ``/proc`` (to the kernel's 10 ms tick), else at this module's import."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _T0
    now = time.perf_counter()
    return now - age if 0.0 <= age <= now - _T0 + 60.0 else _T0


def pin_devices(chips: int) -> None:
    """Let this process see exactly the cell's cards, before CUDA starts:
    the first ``chips`` of those it was given (none where it was given an
    empty list), or cards 0..chips-1 where it was given no list."""
    given = os.environ.get("CUDA_VISIBLE_DEVICES")
    if given is None:
        ids = [str(i) for i in range(chips)]
    else:
        ids = [d.strip() for d in given.split(",") if d.strip()][:chips]
    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(ids)


def cache_dirs() -> None:
    """Every compiler cache at a fixed path inside the checkout (``build/``,
    where the port also keeps its built library)."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "inductor")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def power_limit_w(torch) -> float | None:
    """The power limit in watts of the card this process uses, as
    ``nvidia-smi`` reads it: the card is named by its UUID, else by the
    first entry of ``CUDA_VISIBLE_DEVICES``."""
    uuid = getattr(torch.cuda.get_device_properties(0), "uuid", None)
    given = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0].strip() or "0"
    for card in ([f"GPU-{uuid}"] if uuid else []) + [given]:
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                 "-i", card], capture_output=True, text=True, timeout=20, check=True).stdout
            return float(out.strip().splitlines()[0])
        except (OSError, subprocess.SubprocessError, ValueError, IndexError):
            continue
    return None


def plain(value):
    """``value`` as strict JSON holds it: a float that is not finite (a
    missing answer reads ``inf``) as its name."""
    return repr(value) if isinstance(value, float) and not math.isfinite(value) else value


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start()

    manifest = manifest_mod.load()
    cell = manifest.cell(args.workload)
    pin_devices(cell.chips)
    cache_dirs()
    t_torch_start = time.perf_counter()
    import torch

    t_torch = time.perf_counter() - t_torch_start

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: cell {cell.name} needs {cell.chips} CUDA card(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    if not (ROOT / "blur_algorithms_tpu_torch" / "__init__.py").is_file():
        print(f"portbench: the port blur_algorithms_tpu_torch is missing under {ROOT}",
              file=sys.stderr)
        return 2

    from portbench import harness

    result, compared = harness.run_cell(manifest, cell, args.seed, args.seconds,
                                        bool(args.trace), "cuda", t_start)
    result["setup_parts"] = {"to_torch_s": t_torch_start - t_start, "import_torch_s": t_torch,
                             **result["setup_parts"]}
    dev = result["device"]
    result["device"] = {"platform": dev.pop("platform"), "kind": torch.cuda.get_device_name(0),
                        **dev, "power_limit_w": power_limit_w(torch)}
    found = guard.forbidden_modules(sys.modules)
    if found:
        print(f"portbench: the process holds forbidden modules: {', '.join(found)}",
              file=sys.stderr)
        return 3
    result["judged"] = {k: plain(v) for k, v in result["judged"].items()}
    result["checks"] = {name: {"value": plain(v), "limit": lim} for name, v, lim, _ in compared}
    for name, value, limit, ok in compared:
        print(f"check {name}: {value!r} limit {limit!r} {'ok' if ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
