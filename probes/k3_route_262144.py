"""Probe of K3/K3f's route at transform length 262144: phase 20 of
``chip_smoke.py`` on this card, then as a card that places no cluster of 16
CTAs would run it.

The wide cluster form at n 262144 needs a cluster of 16 CTAs, a
non-portable size; a card that places none (a MIG slice, a Hopper part
with fewer free SMs in a GPC) runs the staged form there, chosen before
the launch by ``fft4step._form``. Phase 20 drives that route beside the
wide form wherever the card places one; its other branch, every path on
the staged form, runs only on a card that places none. This probe runs
the phase twice: as the card is, and with ``cluster_occupancy`` reading 0
at 262144 for the whole phase, so that branch runs here too. It also
prints what the kernel library's build log gives ``chip_smoke``'s ptxas
reader in this process (the log is kept beside the library, so a library
that another process built reads the same lines). Prints the phases'
kernels-line entries as one JSON line, and writes them to ``OUT`` where
given. Run from the repository root on a machine with one CUDA card (~4
min with the builds):

    python3 probes/k3_route_262144.py [card|none|both] [OUT]
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fft4step  # noqa: E402
from blur_algorithms_tpu_torch.utils import build  # noqa: E402


def main() -> int:
    mode = sys.argv[1] if len(sys.argv) > 1 else "both"
    if mode not in ("card", "none", "both") or len(sys.argv) > 3:
        raise SystemExit(f"usage: {sys.argv[0]} [card|none|both] [OUT]")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    build.load_library()
    lines = chip_smoke._ptxas_lines(("fft_conv_rows_kernel",))
    print(f"kernel library built now: {build.last_build['built']}; its log gives "
          f"{len(lines)} ptxas lines of fft_conv_rows_kernel", flush=True)
    build.load_probe_library()  # phase 20's in-turns yardstick
    print(f"builds {time.perf_counter() - t0:.1f} s", flush=True)
    out = {}
    if mode in ("card", "both"):
        t0 = time.perf_counter()
        out["card"] = chip_smoke._slice19(smi)
        print(f"phase 20 on this card: {time.perf_counter() - t0:.1f} s", flush=True)
    if mode in ("none", "both"):
        t0 = time.perf_counter()
        with chip_smoke._no_cluster_of_16(fft4step):
            out["no cluster of 16"] = chip_smoke._slice19(smi)
        print(f"phase 20 as a card that places no cluster of 16: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    if len(sys.argv) > 2:
        pathlib.Path(sys.argv[2]).write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
