"""Probe of K3/K3f's cluster form (``csrc/fft4step.cu``, n 32768-131072) on
the card: the current kernel against PR 16's design of it and against
itself with the other segment length (``other_segment``: 8192 at n 32768,
16384 at 65536), and both designs with their parts left out (the current
one's: ``current_push_barriers``, its pushes ended by cluster barriers in
place of the receivers' transaction counts; ``current_local``, its
exchanges kept in the CTA too; ``current_local_cta_barriers``, its cluster
barriers made the CTA's too).

PR 16's kernel and its variants are B2's (``csrc/probes/fft_ablation.cu``,
``benchmarks/fft_mxu_ablation.cluster_ablation``): ``pr16`` whole; ``local``
(the exchanges through the CTA's own shared memory, the same accesses);
``no_barriers`` (no cluster barrier after the first but the one before
exit); ``local_no_barriers`` (none after the first); ``io_only`` (the
radix-C pass's reads and the last stores alone); ``body_only`` (the
length-16384 body alone). At each of ``cluster_cells()``' shapes (K3 on the
panorama's adjoint rows, K3f on a giant frame's rows, K3f on a streamed
column strip at n 65536) the current kernel and every variant run in turns,
forward then backward through the list, median of 20 calls each.

Before that it prints the card, the ptxas registers and spills of both
kernels' instantiations, ``cudaOccupancyMaxActiveClusters`` for both at C
2, 4 and 8, and holds both against the plain version at n 32768, 65536 and
131072 (9 rows, symmetric and asymmetric taps, within ``FFT_TOL``). Run
from the repository root on a machine with one CUDA card:

    python3 probes/k3_cluster_variants.py [--variants pr16,local,...]
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys
import threading

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from blur_algorithms_tpu_torch import make_custom_plan  # noqa: E402
from blur_algorithms_tpu_torch.benchmarks import fft_mxu_ablation as b2  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fft4step  # noqa: E402
from blur_algorithms_tpu_torch.ops.fft_mxu import _conv_rows_einsum  # noqa: E402
from blur_algorithms_tpu_torch.ops.kernels import gaussian_kernel  # noqa: E402
from blur_algorithms_tpu_torch.utils import build  # noqa: E402
from _earlier import in_turns, ptxas  # noqa: E402

FFT_TOL = 2e-2  # chip_smoke.py's FFT_TOL, 0..255 scale
LENGTHS = (32768, 65536, 131072)
TIMED_ALL = {(32768, False), (32768, True), (65536, True)}  # where every variant is built


def _taps(width: int, asymmetric: bool) -> np.ndarray:
    t = gaussian_kernel(width / 6.0, width).astype(np.float64)
    if asymmetric:
        t *= np.linspace(0.6, 1.4, width)
    return (t / t.sum()).astype(np.float32)


def _occupancy(fn, *args) -> int:
    v = ctypes.c_int(-1)
    rc = fn(*args, ctypes.byref(v))
    if rc:
        raise RuntimeError(f"occupancy query failed: CUDA error {rc}")
    return v.value


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--variants", default=",".join([*b2.CLUSTER_VARIANTS, b2.OTHER_SEGMENT,
                                                   *b2.CURRENT_VARIANTS]),
                   help="PR 16's variants and other_segment, timed beside the current kernel")
    args = p.parse_args(argv)
    variants = [v for v in args.variants.split(",") if v]
    if not torch.cuda.is_available():
        raise RuntimeError("probes/k3_cluster_variants.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    failed: list = []

    def probe_build():
        try:
            build.load_probe_library()
        except Exception as e:  # noqa: BLE001 - re-raised below
            failed.append(e)

    t = threading.Thread(target=probe_build, name="probe-build")  # beside the kernels' build
    t.start()
    lib = build.load_library()
    t.join()
    if failed:
        raise RuntimeError(f"the probes' library did not build: {failed[0]}") from failed[0]
    plib = build.load_probe_library()
    for line in ptxas(build.last_build.get("log", ""), "fft_conv_rows_cluster_kernel"):
        print(f"ptxas current: {line}", flush=True)
    for name in ("fft_conv_rows_cluster_kernel", "fft_cluster_pr16_kernel"):
        for line in ptxas(build.last_probe_build.get("log", ""), name):
            print(f"ptxas probe: {line}", flush=True)
    for n in LENGTHS:
        for framed in (False, True):
            cur = _occupancy(lib.fft_conv_rows_cluster_occupancy, n, int(framed))
            old = _occupancy(plib.fft_cluster_ablation_occupancy, 0, n, int(framed))
            c, c16 = n // fft4step.cluster_segment(n), n // fft4step.BODY_N
            print(f"cudaOccupancyMaxActiveClusters n={n} {'K3f' if framed else 'K3'}: current "
                  f"{cur} of {c} ({cur * c} CTAs), pr16 {old} of {c16} ({old * c16} CTAs), "
                  f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs", flush=True)

    # both kernels against the plain version at every length
    for n in LENGTHS:
        for asym in (False, True):
            plan = make_custom_plan((8, n), _taps(801, asym), [1.0])
            rows = torch.from_numpy(
                (np.random.default_rng(n).random((9, n)) * 255).astype(np.float32)).cuda()
            want = _conv_rows_einsum(rows, n, plan.row)
            fns = {"current": fft4step.fft_conv_rows, "pr16": b2.cluster_ablation}
            if n == 32768:
                fns[b2.OTHER_SEGMENT] = lambda r, m, ax: b2.cluster_ablation(
                    r, m, ax, b2.OTHER_SEGMENT)
            errs = {name: float((fn(rows, n, plan.row) - want).abs().max())
                    for name, fn in fns.items()}
            print(f"vs plain: K3 9 rows n={n} {'asymmetric' if asym else 'symmetric'} "
                  f"max_abs_err {errs} (limit {FFT_TOL})", flush=True)
            if not max(errs.values()) <= FFT_TOL:
                raise RuntimeError(f"a cluster kernel disagrees with its plain version at {n}")

    for label, nrows, n, ax, framed in b2.cluster_cells():
        gen = torch.Generator(device="cuda").manual_seed(n + nrows)
        x = torch.rand((nrows, ax.dim if framed else n), generator=gen, device="cuda") * 255
        cur = fft4step.fft_conv_rows_framed if framed else fft4step.fft_conv_rows
        fns = {"current": lambda: cur(x, n, ax)}
        for v in variants:
            if v == "pr16" or (n, framed) in TIMED_ALL:  # other_segment there too
                fns[v] = lambda v=v: b2.cluster_ablation(x, n, ax, v, framed)
        got, want = fns["current"](), fns["pr16"]()
        torch.cuda.synchronize()
        diff = float((got - want).abs().max())
        del got, want
        print(f"{label}: {nrows} rows, n {n}: current vs pr16 max_abs_diff {diff:.3e}",
              flush=True)
        if not diff <= FFT_TOL:
            raise RuntimeError(f"the current kernel differs from PR 16's at {label}")
        ms = in_turns(label, fns)
        base = ms["pr16"]
        print(f"{label}: ms in turns: " + ", ".join(
            f"{k} {v:.4f} ({v - base:+.4f})" for k, v in ms.items()), flush=True)
        del x
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
