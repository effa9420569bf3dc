"""Probe of K3/K3f past transform length 131072 (``csrc/fft4step.cu``) on
the card: the copying staged form with its passes timed apart, and every
design tried for n 262144, in turns.

The staged form runs a pair of rows through three kinds of launch: the
forward radix-P pass (rows -> a complex scratch buffer in device memory),
the segment pass (each segment of 16384 of scratch through the one-block
body) and the inverse radix-P pass (scratch -> rows).
``probes/k3_staged_parts.cu``, compiled after a source in one translation
unit (an earlier commit's ``fft4step.cu``, and the current
``csrc/probes/fft_ablation.cu`` over a copy of the current ``fft4step.cu``
whose cluster form also takes C 16, ``c16_source``), launches them one at a
time, the staged form in waves of pairs sharing a scratch buffer L2 may
hold, and the cluster designs at C 16. At each of the probe's shapes
(K3 on the 6480 adjoint rows of a 3 x 2160 x 131072 float blur at sigma
400, n 262144; K3f on the 6480 rows of a 2160 x 140000 RGB frame at sigma
900, n 262144; K3f on 1200 rows of 300000 at sigma 100, n 524288) it
times, in turns (forward then backward through the list, median of 20
calls each): the package's K3/K3f (``current``: the wide cluster form at
262144, the staged form past it); the earlier source's whole staged entry
and each of its passes beside its own bytes time (what it reads and writes
once at 3.35 TB/s); the current segment pass; the current staged form
(its passes chained, one wave of every pair); the L2 candidate, the staged
form in waves with the rows' streaming hint, in one wave and in waves of
8, 16, 32 and 64 MB of scratch; and at 262144 the
cluster form's own design at C 16 (G = 8 lanes a butterfly) with its parts
left out (pushes ended by cluster barriers, kept in the CTA, independent
CTAs in clusters and unclustered), the split design at C 16, a wide form of
the split design with pushes and transaction counts, and (K3) the cluster form
at n 131072 on the same points. It holds the current output against the
earlier one within ``FFT_TOL``, the earlier passes chained against its
entry (equal), and every other correct design against the earlier entry;
before, the current K3 and K3f against their plain versions at each
shape's length (9 and 7 rows, symmetric and asymmetric taps of 2001).

Before that it prints the card, the ptxas registers and spills of the
staged, cluster and wide kernels in both builds, and
``cudaOccupancyMaxActiveClusters`` of the clusters of 16 (a non-portable
size, allowed first) with each launch's shared memory, and of the package's
cluster forms at every length. Run from the repository root on a machine
with one CUDA card (~5 minutes with the builds):

    git show <parent>:blur_algorithms_tpu_torch/csrc/fft4step.cu > build/parent_fft4step.cu
    python3 probes/k3_staged_variants.py --earlier build/parent_fft4step.cu

Without ``--earlier`` the current source stands in for the earlier one.
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

from blur_algorithms_tpu_torch import make_custom_plan, make_plan  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fft4step  # noqa: E402
from blur_algorithms_tpu_torch.ops.fft_mxu import _conv_rows_einsum, transform_length  # noqa: E402
from blur_algorithms_tpu_torch.ops.kernels import gaussian_kernel  # noqa: E402
from blur_algorithms_tpu_torch.utils import build  # noqa: E402
from _earlier import in_turns, library, ptxas  # noqa: E402

FFT_TOL = 2e-2  # chip_smoke.py's FFT_TOL, 0..255 scale
WAVE_MB = (8, 16, 32, 64)  # the staged form's scratch a wave, timed
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PARTS = pathlib.Path(__file__).resolve().parent / "k3_staged_parts.cu"
SCRATCH_IO, ROWS_IO, FRAMED_IO = 0, 1, 2  # csrc/fft4step.cu: StagedIo
# The cluster form's own design at C 16 takes a butterfly over G = 8 lanes,
# whose lane rotation W_G^k is an eighth turn at odd k; the source's
# cluster form rotates by quarter turns (G <= 4). ``c16_source`` builds from
# a copy of fft4step.cu with the rotation below, the same as the source's at
# G <= 4 (the lengths the package serves).
C16_TURNS = """// v * W_G^k (kInv: the conjugate root), k known at run time: quarter turns
// for G <= 4; at G = 8 an odd k first takes the f32 root W_8 = (1 - i)
// sqrt(1/2), selected, not branched, then (-i)^(k >> 1).
template <int G, bool kInv>
__device__ __forceinline__ float2 turns(float2 v, int k) {
  static_assert(G == 1 || G == 2 || G == 4 || G == 8, "a lane group of 1, 2, 4 or 8");
  if constexpr (G == 8) {
    constexpr float kR = 0.707106769f;  // sqrt(1/2) rounded to f32
    const float2 w = kInv ? make_float2((v.x - v.y) * kR, (v.x + v.y) * kR)
                          : make_float2((v.x + v.y) * kR, (v.y - v.x) * kR);
    v = (k & 1) ? w : v;
    const int q = (k >> 1) & 3;
    return quarter_turns(v, kInv ? (4 - q) & 3 : q);
  } else {
    const int q = (k * (4 / G)) & 3;
    return quarter_turns(v, kInv ? (4 - q) & 3 : q);
  }
}

"""
C16_EDITS = (
    ("// Where the cluster form keeps what.", C16_TURNS + "// Where the cluster form keeps what."),
    ("v[c] = quarter_turns(a[c][mi], (g * c * (4 / G)) & 3);",
     "v[c] = turns<G, false>(a[c][mi], g * c);"),
    ("quarter_turns(v[c], (4 - ((g * c * (4 / G)) & 3)) & 3)", "turns<G, true>(v[c], g * c)"),
)


def shapes() -> list[tuple[str, int, int, object, bool]]:
    """(label, rows, n, axis plan, framed) of each timed shape."""
    adj = make_plan((2160, 131072), 400.0).row  # the adjoint's rows: 131072 + 4 r -> 262144
    strip = make_plan((2160, 140000), 900.0).row
    wide = make_plan((400, 300000), 100.0).row
    return [
        ("K3 adjoint rows sigma 400", 6480, 1 << 18, adj, False),
        ("K3f 2160x140000 rows sigma 900", 6480, transform_length(strip), strip, True),
        ("K3f 400x300000 rows sigma 100", 1200, transform_length(wide), wide, True),
    ]


def staged_digits(n: int) -> list[int]:
    """The staged form's first-pass digits at n, as ``fft4step.staged_digits``
    splits ``n / BODY_N`` (which takes only the lengths the staged form now
    serves; an earlier source ran it from 262144)."""
    p = (n // fft4step.BODY_N).bit_length() - 1
    t = -(-p // 5)
    return [1 << (p // t + (i < p % t)) for i in range(t)]


def _taps(width: int, asymmetric: bool) -> np.ndarray:
    t = gaussian_kernel(width / 6.0, width).astype(np.float64)
    if asymmetric:
        t *= np.linspace(0.6, 1.4, width)
    return (t / t.sum()).astype(np.float32)


def against_plain(n: int) -> float:
    """The current K3 (9 rows of n) and K3f (7 rows of n / 2 + 1001, framed
    to n) against their plain versions, symmetric and asymmetric taps of
    2001: the largest error."""
    worst = 0.0
    for asym in (False, True):
        plan = make_custom_plan((8, n), _taps(2001, asym), [1.0])
        rows = torch.from_numpy(
            (np.random.default_rng(n).random((9, n)) * 255).astype(np.float32)).cuda()
        k3 = float((fft4step.fft_conv_rows(rows, n, plan.row)
                    - _conv_rows_einsum(rows, n, plan.row)).abs().max())
        dim = n // 2 + 1001
        plan = make_custom_plan((8, dim), _taps(2001, asym), [1.0])
        rows = torch.from_numpy(
            (np.random.default_rng(dim).random((7, dim)) * 255).astype(np.float32)).cuda()
        k3f = float((fft4step.fft_conv_rows_framed(rows, n, plan.row)
                     - fft4step.fft_conv_rows_framed_ref(rows, n, plan.row)).abs().max())
        print(f"vs plain: n {n} {'asymmetric' if asym else 'symmetric'}: K3 9 rows "
              f"max_abs_err {k3:.3e}, K3f 7 rows of {dim} {k3f:.3e} (limit {FFT_TOL})",
              flush=True)
        if transform_length(plan.row) != n or not max(k3, k3f) <= FFT_TOL:
            raise RuntimeError(f"the current form disagrees with its plain version at {n}")
        worst = max(worst, k3, k3f)
    return worst


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.parts_staged_pass.argtypes = [i, i, i, vp, vp, vp, vp, i, i, i, i, i, vp]
    lib.parts_staged_segment.argtypes = [vp, vp, vp, i, i, i, vp]
    lib.parts_cluster16_occupancy.argtypes = [i, ctypes.POINTER(i)]
    fns = [lib.parts_staged_pass, lib.parts_staged_segment, lib.parts_cluster16_occupancy]
    if hasattr(lib, "fft_conv_rows_staged"):  # built over a whole fft4step.cu
        lib.fft_conv_rows_staged.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, vp, vp]
        fns.append(lib.fft_conv_rows_staged)
    if hasattr(lib, "parts_cluster16_variant"):  # built over B2's fft_ablation.cu
        lib.parts_cluster16_variant.argtypes = [i, i, i, vp, vp, vp, vp, i, i, i, i, vp]
        lib.parts_split_cluster16.argtypes = [i, vp, vp, vp, vp, i, i, i, i, vp]
        lib.parts_wide.argtypes = [i, i, vp, vp, vp, vp, i, i, i, i, vp]
        lib.parts_wide_occupancy.argtypes = [i, i, ctypes.POINTER(i)]
        lib.parts_staged.argtypes = [i, vp, vp, vp, vp, i, i, i, i, i, vp, i, vp]
        fns += [lib.parts_cluster16_variant, lib.parts_split_cluster16, lib.parts_wide,
                lib.parts_wide_occupancy, lib.parts_staged]
    for f in fns:
        f.restype = i
    return lib


def c16_source(csrc: pathlib.Path) -> pathlib.Path:
    """The current ``csrc/probes/fft_ablation.cu`` over a copy of
    ``csrc/fft4step.cu`` with ``C16_EDITS`` made, in ``build/probe/c16``:
    the copy of ``fft_ablation.cu``'s path."""
    out = build.build_dir() / "probe" / "c16"
    (out / "probes").mkdir(parents=True, exist_ok=True)
    src = (csrc / "fft4step.cu").read_text()
    for old, new in C16_EDITS:
        if src.count(old) != 1:
            raise RuntimeError(f"fft4step.cu no longer holds {old!r} once")
        src = src.replace(old, new)
    (out / "fft4step.cu").write_text(src)
    abl = out / "probes" / "fft_ablation.cu"
    abl.write_text((csrc / "probes" / "fft_ablation.cu").read_text())
    return abl


def parts_library(src: pathlib.Path, name: str) -> tuple[ctypes.CDLL, str]:
    """``src`` (an earlier ``fft4step.cu``, whole, or ``c16_source``'s B2
    source, which holds this one's kernels) and
    ``k3_staged_parts.cu`` built as one library."""
    unit = build.build_dir() / "probe" / f"{name}.cu"
    unit.parent.mkdir(parents=True, exist_ok=True)
    unit.write_text(f'#include "{src.resolve()}"\n#include "{PARTS}"\n')
    lib, log = library(unit, name)
    return _declare(lib), log


def _check(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what} failed: CUDA error {rc}")


class Staged:
    """A source's staged form on one shape: its passes one at a time, its
    whole entry (an earlier source's), the cluster form's variants at C 16
    and the split design there (the current source's)."""

    def __init__(self, lib, x, n, ax, framed, scratch=None):
        self.lib, self.x, self.n, self.framed = lib, x, n, framed
        self.rows, self.dim = x.shape
        self.pad = ax.pad if framed else 0
        self.tw = fft4step._twiddles(n, x.device)
        self.h, complex_h = fft4step._kernel_spectrum(ax, n, x.device)
        self.complex_h = int(complex_h)
        self.out = torch.empty_like(x)
        self.scratch = scratch if scratch is not None else torch.empty(
            ((self.rows + 1) // 2, n, 2), device=x.device)
        self.n_log2 = n.bit_length() - 1
        self.digits = staged_digits(n)
        self.io = FRAMED_IO if framed else ROWS_IO

    def _stream(self) -> int:
        return torch.cuda.current_stream().cuda_stream

    def _pass(self, inverse: bool) -> None:
        """The first (forward) or last (inverse) pass: the one digit's."""
        if len(self.digits) != 1:
            raise ValueError("the probe times one-digit lengths")
        r_log2 = self.digits[0].bit_length() - 1
        _check(self.lib.parts_staged_pass(
            r_log2, int(inverse), self.io, self.x.data_ptr(), self.out.data_ptr(),
            self.scratch.data_ptr(), self.tw.data_ptr(), self.rows, self.dim, self.pad,
            self.n_log2, self.n_log2, self._stream()), "a staged pass")

    def forward(self) -> None:
        self._pass(False)

    def inverse(self) -> None:
        self._pass(True)

    def segment(self) -> None:
        _check(self.lib.parts_staged_segment(
            self.scratch.data_ptr(), self.tw.data_ptr(), self.h.data_ptr(), self.complex_h,
            self.rows, self.n_log2, self._stream()), "the segment pass")

    def chained(self) -> torch.Tensor:
        self.forward()
        self.segment()
        self.inverse()
        return self.out

    def variant(self, v: int, unclustered: bool = False) -> torch.Tensor:
        """The cluster form at C 16 with a ClusterVariant's parts left out
        (0: none, the design itself; any other a wrong result)."""
        _check(self.lib.parts_cluster16_variant(
            v, int(unclustered), int(self.framed), self.x.data_ptr(), self.out.data_ptr(),
            self.tw.data_ptr(), self.h.data_ptr(), self.complex_h, self.rows, self.dim,
            self.pad, self._stream()), f"cluster variant {v}")
        return self.out

    def split(self) -> torch.Tensor:
        _check(self.lib.parts_split_cluster16(
            int(self.framed), self.x.data_ptr(), self.out.data_ptr(), self.tw.data_ptr(),
            self.h.data_ptr(), self.complex_h, self.rows, self.dim, self.pad, self._stream()),
            "the split design at C 16")
        return self.out

    def wide(self, persistent: bool = False) -> torch.Tensor:
        _check(self.lib.parts_wide(
            int(persistent), int(self.framed), self.x.data_ptr(), self.out.data_ptr(),
            self.tw.data_ptr(),
            self.h.data_ptr(), self.complex_h, self.rows, self.dim, self.pad, self._stream()),
            "the wide cluster form")
        return self.out

    def waves(self, wave: int) -> torch.Tensor:
        """The L2 candidate: the staged form in waves of ``wave`` pairs that
        share one scratch buffer (this shape's), the rows with the
        streaming hint."""
        _check(self.lib.parts_staged(
            int(self.framed), self.x.data_ptr(), self.out.data_ptr(), self.tw.data_ptr(),
            self.h.data_ptr(), self.complex_h, self.rows, self.n_log2, self.dim, self.pad,
            self.scratch.data_ptr(), wave, self._stream()), "the staged form in waves")
        return self.out

    def whole(self) -> torch.Tensor:
        out = torch.empty_like(self.x)
        _check(self.lib.fft_conv_rows_staged(
            self.x.data_ptr(), out.data_ptr(), self.tw.data_ptr(), self.h.data_ptr(),
            self.complex_h, self.rows, self.n, self.dim, self.pad, int(self.framed),
            self.scratch.data_ptr(), self._stream()), "the staged entry")
        return out

    def bytes_ms(self) -> dict:
        """Each pass's bytes (each input read once, each output written
        once) at 3.35 TB/s: the rows at their own length, scratch at n."""
        pairs = (self.rows + 1) // 2
        rows_b, scratch_b = 4 * self.rows * self.dim, 8 * pairs * self.n
        b = {"forward pass": rows_b + scratch_b, "segment pass": 2 * scratch_b,
             "inverse pass": scratch_b + rows_b}
        return {k: v / HBM_BYTES_PER_S * 1e3 for k, v in b.items()}


def _occupancy16(lib, framed: bool) -> int:
    v = ctypes.c_int(-1)
    _check(lib.parts_cluster16_occupancy(int(framed), ctypes.byref(v)),
           "cudaOccupancyMaxActiveClusters at C 16")
    return v.value


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--earlier", type=pathlib.Path,
                   help="an earlier fft4step.cu (default: the current one)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("probes/k3_staged_variants.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    csrc = ROOT / "blur_algorithms_tpu_torch" / "csrc"
    srcs = {"earlier": args.earlier or csrc / "fft4step.cu",
            "current": c16_source(csrc)}
    libs, logs, failed = {}, {}, []

    def parts(key):
        try:
            libs[key], logs[key] = parts_library(srcs[key], f"k3_staged_parts_{key}")
        except Exception as e:  # noqa: BLE001 - re-raised below
            failed.append(e)

    threads = [threading.Thread(target=parts, args=(k,)) for k in srcs]
    for t in threads:
        t.start()
    build.load_library()
    for t in threads:
        t.join()
    if failed:
        raise RuntimeError(f"a parts library did not build: {failed[0]}") from failed[0]
    for key in srcs:
        for kernel in ("fft_conv_rows_staged_pass_kernel", "fft_conv_rows_staged_segment_kernel",
                       "fft_conv_rows_cluster_kernelILi16384ELi16", "fft_cluster_pr16_kernelILi16",
                       "fft_conv_rows_wide_kernel", "fft_wide_push_kernel"):
            for line in ptxas(logs[key], kernel):
                print(f"ptxas {key}: {line}", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for key in srcs:
        for framed in (False, True):
            c = _occupancy16(libs[key], framed)
            print(f"cudaOccupancyMaxActiveClusters {key} M 16384 C 16 "
                  f"{'K3f' if framed else 'K3'}: {c} clusters ({16 * c} CTAs of {sms} SMs)",
                  flush=True)
    for persistent in (False, True):
        for framed in (False, True):
            v = ctypes.c_int(-1)
            _check(libs["current"].parts_wide_occupancy(int(persistent), int(framed),
                                                        ctypes.byref(v)),
                   "the wide form's occupancy")
            print(f"cudaOccupancyMaxActiveClusters {'persistent ' * persistent}wide form "
                  f"{'K3f' if framed else 'K3'}: {v.value} clusters of 16", flush=True)
    n = 2 * fft4step.BODY_N
    while n <= fft4step.CLUSTER_LONGEST:
        for framed in (False, True):
            c = fft4step.cluster_occupancy(n, framed)
            size = n // fft4step.cluster_segment(n)
            print(f"cudaOccupancyMaxActiveClusters current cluster form n {n} "
                  f"{'K3f' if framed else 'K3'}: {c} clusters of {size} ({c * size} CTAs)",
                  flush=True)
        n *= 2
    for n in sorted({s[2] for s in shapes()}):
        against_plain(n)

    for label, nrows, n, ax, framed in shapes():
        gen = torch.Generator(device="cuda").manual_seed(n + nrows)
        x = torch.rand((nrows, ax.dim if framed else n), generator=gen, device="cuda") * 255
        old = Staged(libs["earlier"], x, n, ax, framed)
        new = Staged(libs["current"], x, n, ax, framed, old.scratch)
        cur = fft4step.fft_conv_rows_framed if framed else fft4step.fft_conv_rows
        got, want = cur(x, n, ax), old.whole()
        diff = float((got - want).abs().max())
        del got
        chained = float((old.chained() - want).abs().max())
        chained_new = float((new.chained() - want).abs().max())
        c16 = n == 16 * fft4step.BODY_N
        c16_form = float((new.variant(0) - want).abs().max()) if c16 else 0.0
        split = float((new.split() - want).abs().max()) if c16 else 0.0
        wide = float((new.wide() - want).abs().max()) if c16 else 0.0
        wide_p = float((new.wide(True) - want).abs().max()) if c16 else 0.0
        half = (nrows + 1) // 2
        one_wave = float((new.waves(half) - want).abs().max())
        waves = float((new.waves(max(1, (WAVE_MB[0] << 20) // (8 * n))) - want).abs().max())
        torch.cuda.synchronize()
        del want
        print(f"{label}: {nrows} rows x {x.shape[1]}, n {n}: current vs earlier staged "
              f"max_abs_diff {diff:.3e} (limit {FFT_TOL}); earlier passes chained vs its "
              f"entry {chained:.3e}, the current source's {chained_new:.3e}; the L2 "
              f"candidate in one wave {one_wave:.3e}, in waves of {WAVE_MB[0]} MB "
              f"{waves:.3e}; at C 16 the cluster form {c16_form:.3e}, the split design "
              f"{split:.3e}, the wide forms "
              f"{wide:.3e} (pushes), {wide_p:.3e} (persistent)",
              flush=True)
        if not (diff <= FFT_TOL and chained == 0.0 and chained_new <= FFT_TOL
                and max(c16_form, split, wide, wide_p, one_wave, waves) <= FFT_TOL):
            raise RuntimeError(f"{label}: the forms disagree")
        fns = {"current": lambda: cur(x, n, ax), "earlier staged": old.whole,
               "forward pass": old.forward, "segment pass": old.segment,
               "inverse pass": old.inverse, "current segment pass": new.segment,
               "current staged form": new.chained,
               "one wave, streaming hint": lambda: new.waves(half)}
        for mb in WAVE_MB:  # the L2 candidate: waves whose scratch L2 may hold
            wave = max(1, (mb << 20) // (8 * n))
            if wave < half:
                fns[f"waves of {mb} MB ({wave} pairs), streaming hint"] = (
                    lambda w=wave: new.waves(w))
        if c16:  # the cluster form's parts at C 16, and the same points at C 8
            fns.update({
                "c16 cluster form": lambda: new.variant(0),
                "c16 push barriers": lambda: new.variant(16),
                "c16 pushes kept local": lambda: new.variant(17),
                "c16 independent CTAs": lambda: new.variant(19),
                "c16 independent, unclustered": lambda: new.variant(19, True),
                "split design c16": new.split, "wide form c16, pushes": new.wide,
                "wide form c16, persistent": lambda: new.wide(True)})
            if not framed:
                x8 = x.view(2 * nrows, n // 2)
                fns["c8 n131072, the same points"] = lambda: cur(x8, n // 2, ax)
        ms = in_turns(label, fns)
        bytes_ms = old.bytes_ms()
        parts_sum = sum(ms[k] for k in bytes_ms)
        bytes_ms["current segment pass"] = bytes_ms["segment pass"]
        print(f"{label}: ms in turns: " + ", ".join(
            f"{k} {v:.4f}" + (f" (bytes {bytes_ms[k]:.4f}, {v / bytes_ms[k]:.2f}x)"
                              if k in bytes_ms else "")
            for k, v in ms.items())
            + f"; passes summed {parts_sum:.4f}; current / earlier "
              f"{ms['current'] / ms['earlier staged']:.3f}", flush=True)
        del old, new, x, fns
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
