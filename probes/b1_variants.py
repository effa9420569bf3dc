"""Probe of B1's chain kernel (``csrc/probes/mma_rate.cu``) on the card.

Builds patched copies of the cluster source, each into its own library under
``build/probe/``: ablations whose results are wrong by design and only their
times count. Two leave out the work after each product of one chain (the
exchange of the cast tiles through distributed shared memory and its
cluster barrier; also the barrier that every CTA has finished reading its
panel); three split one product's time: ``launch`` returns once the
barriers are set up (the launch with its clusters and shared memory),
``load_only`` loads and waits for the panel and computes no tile,
``no_products`` has no stage of K (the panel load and the output's store of
the empty tiles). With
``--earlier PATH``, the earlier source (one
block a 64-row panel, the tiles through a device-memory scratch, the C
interface ``mma_rate_chain(..., a, bt, out, scratch, ...)`` and
``mma_rate_blocks_per_sm``) as the yardstick. At the 1024^3 cube, int8 and
bf16, on both paths, it checks the shipped and the earlier kernels against
the plain chain, then times in turns (``probes/_earlier.in_turns``): one
product on one chain per call (beside ``torch._int_mm``) and as CUDA graph
replays (the kernel's time, the split's ablations and the library call
too), one chain of 16 resident products with and without its exchange, and
the rates' launches (filling the card, ``inner`` from ``inner_for``),
resident and streamed. Run from the repository root on a machine with one
CUDA card:

    python3 probes/b1_variants.py [--earlier build/parent_mma_rate.cu]
        [--variants shipped,no_exchange,...]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import dataclasses
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from blur_algorithms_tpu_torch.benchmarks import mxu_dot_rate as b1  # noqa: E402
from blur_algorithms_tpu_torch.utils import build  # noqa: E402
import _earlier  # noqa: E402

SRC = build._CSRC / "probes" / "mma_rate.cu"

_SYNCS = "return pi == products - 1 ? 0 : (pi % p.inner == p.inner - 1 ? 1 : 2);"
_FREE = "        cluster_sync();  // every CTA of the cluster is done reading its panel\n"
_AFTER_FREE = """          if (tid == 0) reload();
          continue;
        }
"""

_SETUP = "  cluster_sync();  // every CTA's barriers exist before any peer signals them\n"
_OWN = "const int own = rank < p.ntile ? (p.ntile - rank + C - 1) / C : 0;"
_NKC = "const int nkc = p.kb / kStageK;"

# name -> [(text in the shipped source, replacement), ...]
VARIANTS = {
    "shipped": [],
    # ablations, the panel not updated between products: the cluster
    # barrier that the panels are free and no exchange; neither
    "no_exchange": [(_SYNCS, _SYNCS.replace(": 2);", ": 1);")),
                    (_AFTER_FREE, _AFTER_FREE + "        continue;\n")],
    "no_sync": [(_SYNCS, _SYNCS.replace(": 2);", ": 0);")),
                (_FREE, "        if (it < p.inner - 1) continue;\n" + _FREE)],
    # one product's parts: the launch alone; and the panel's load; and the
    # output's store
    "launch": [(_SETUP, _SETUP + "  if (p.inner > 0) return;\n")],
    "load_only": [(_OWN, "const int own = 0;")],
    "no_products": [(_NKC, "const int nkc = 0;")],
}
ABLATIONS = ("no_exchange", "no_sync", "launch", "load_only", "no_products")
EXCHANGE = ("shipped", "no_exchange", "no_sync")  # one chain of 16 resident products


def _declare_new(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.mma_rate_clusters.argtypes = [i, i, i, i, i, ctypes.POINTER(i)]
    lib.mma_rate_maps.argtypes = [vp, vp, i, i, i, vp]
    lib.mma_rate_chain.argtypes = [i, i, i, vp, vp, *[i] * 10, vp]
    return lib


def _declare_earlier(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.mma_rate_blocks_per_sm.argtypes = [i, i, i, i, ctypes.POINTER(i)]
    lib.mma_rate_chain.argtypes = [i, i, i, vp, vp, vp, vp, *[i] * 9, vp]
    return lib


def _check(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what}: CUDA error {rc}")


@contextlib.contextmanager
def _serving(lib):
    """``mxu_dot_rate`` on ``lib`` in place of the probes' library."""
    kept = build._probe_lib
    build._probe_lib = lib
    try:
        yield
    finally:
        build._probe_lib = kept


@dataclasses.dataclass
class Launch:
    """One prepared launch of a library's chain kernel (either interface)."""

    fn: object
    rows: int
    inner: int = 1

    def __call__(self):
        return self.fn(self.inner)


def _prepare_new(lib, a, b, path, resident, copies) -> Launch:
    """``mxu_dot_rate.prepare`` through ``lib``."""
    with _serving(lib):
        launch = b1.prepare(a, b, 1, path=path, resident=resident, copies=copies)

    def run(inner):
        with _serving(lib):
            return dataclasses.replace(launch, inner=inner)()

    return Launch(run, launch.real_rows)


def _prepare_earlier(lib, a, b, path, resident, copies) -> Launch:
    m, k = a.shape
    n = b.shape[1]
    es = a.element_size()
    panels = -(-m // 64)
    kp = -(-k * es // 128) * 128 // es
    np_ = -(-n // 128) * 128
    ap = torch.zeros((panels * 64, kp), dtype=a.dtype, device=a.device)
    ap[:m, :k] = a
    bt = torch.zeros((np_, kp), dtype=a.dtype, device=a.device)
    bt[:n, :k] = b.t()
    wg = int(path == "wgmma")
    grid = panels
    if copies:
        blocks = ctypes.c_int(0)
        _check(lib.mma_rate_blocks_per_sm(wg, es - 1, int(resident), kp * es,
                                          ctypes.byref(blocks)), "mma_rate_blocks_per_sm")
        sms = torch.cuda.get_device_properties(a.device).multi_processor_count
        grid = max(panels, sms * blocks.value)
    out = torch.empty((m, k), dtype=torch.int32 if es == 1 else torch.float32, device=a.device)
    scratch = torch.empty(grid * 64 * min(n, k) * es, dtype=torch.uint8, device=a.device)

    def run(inner):
        _check(lib.mma_rate_chain(wg, es - 1, int(resident), ap.data_ptr(), bt.data_ptr(),
                                  out.data_ptr(), scratch.data_ptr(), m, k, kp * es, np_,
                                  min(n, k) * es, panels, inner, 1, grid,
                                  torch.cuda.current_stream().cuda_stream), "mma_rate_chain")
        return out

    return Launch(run, sum(min(64, m - 64 * (g % panels)) for g in range(grid)))


def _graph(fn):
    """``fn`` captured in a CUDA graph: its replay, the device's time with
    no host work between launches. The replay holds ``fn``, and with it
    the tensors the graph reads and writes (entering a capture empties
    the allocator's cache, so a tensor freed after its capture would leave
    the graph pointing at returned memory)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return lambda graph=graph, fn=fn: graph.replay()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--earlier", type=pathlib.Path, default=None)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    dev = torch.device("cuda")
    text = SRC.read_text()
    srcs = {}
    for name in args.variants.split(","):
        patched = text
        for old, new in VARIANTS[name]:
            if old not in patched:
                raise RuntimeError(f"variant {name}: the shipped source has no {old[:60]!r}")
            patched = patched.replace(old, new)
        srcs[name] = build.build_dir() / "probe" / f"b1_{name}.cu"
        srcs[name].parent.mkdir(parents=True, exist_ok=True)
        srcs[name].write_text(patched)
    if args.earlier:
        srcs["earlier"] = args.earlier
    with concurrent.futures.ThreadPoolExecutor(len(srcs)) as pool:  # one nvcc each
        built = dict(zip(srcs, pool.map(lambda k: _earlier.library(srcs[k], f"b1_{k}"),
                                        srcs)))
    libs = {}
    for name, (lib, log) in built.items():
        libs[name] = ((_declare_earlier(lib), _prepare_earlier) if name == "earlier"
                      else (_declare_new(lib), _prepare_new))
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"b1 {name}: built; ptxas {regs[:1]}", flush=True)
    print(torch.cuda.get_device_name(0), flush=True)
    for dtype in ("int8", "bf16"):
        a, b = (t.to(dev) for t in b1.operands(1024, 1024, 1024, dtype, seed=9))
        for name, (lib, prep) in libs.items():
            if name in ABLATIONS:
                continue
            want = b1.chain_ref(a, b, 1)
            for path in b1.PATHS:
                got = prep(lib, a, b, path, False, False)()
                torch.cuda.synchronize()
                d = (got.double() - want.double()).abs()
                ok = (torch.equal(got, want) if dtype == "int8"
                      else bool((d <= b1.bf16_bound(a, b, want)).all()))
                print(f"b1 {name} {dtype} {path} cube one product vs plain: held={ok}",
                      flush=True)
        for path in b1.PATHS:
            if dtype == "int8":
                one = {name: prep(lib, a, b, path, False, False)
                       for name, (lib, prep) in libs.items() if name not in ABLATIONS}
                one["torch._int_mm"] = lambda a=a, b=b: torch._int_mm(a, b)
                t = _earlier.in_turns(f"b1 {path} int8 cube one product", one)
                print(f"b1 one product {dtype} {path} per call (ms, in turns): {t}", flush=True)
                graphs = {name: _graph(prep(lib, a, b, path, False, False))
                          for name, (lib, prep) in libs.items()}
                graphs["torch._int_mm"] = _graph(lambda a=a, b=b: torch._int_mm(a, b))
                t = _earlier.in_turns(f"b1 {path} int8 cube one product graph", graphs)
                print(f"b1 one product {dtype} {path} as CUDA graph replays (ms, in turns): "
                      f"{t}", flush=True)
            chains = {}
            for name in EXCHANGE:
                if name in libs:
                    lib, prep = libs[name]
                    chains[name] = prep(lib, a, b, path, True, False)
                    chains[name].inner = 16
            if chains:
                t = _earlier.in_turns(f"b1 {path} {dtype} one chain of 16", chains, iters=10)
                print(f"b1 one chain {dtype} {path} resident, 16 products (us a product, in "
                      "turns): " + "; ".join(f"{k} {v * 1e3 / 16:.2f}" for k, v in t.items()),
                      flush=True)
            for resident in (True, False):
                fns, ops = {}, {}
                for name, (lib, prep) in libs.items():
                    if name in ABLATIONS:
                        continue
                    la = prep(lib, a, b, path, resident, True)
                    la.inner = b1.inner_for(la.rows, 1024, 1024)
                    fns[name] = la
                    ops[name] = 2.0 * la.rows * 1024 * 1024 * la.inner
                t = _earlier.in_turns(f"b1 {path} {dtype} rate", fns, iters=5)
                tops = {k: ops[k] / (v * 1e-3) / 1e12 for k, v in t.items()}
                print(f"b1 rate {dtype} {path} {'resident' if resident else 'streamed'} "
                      f"(TOP/s, in turns; share of {b1.PEAK_OPS[dtype] / 1e12:.0f}): "
                      + "; ".join(f"{k} {v:.1f} ({v * 1e12 / b1.PEAK_OPS[dtype]:.1%})"
                                  for k, v in tops.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
