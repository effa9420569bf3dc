"""Probe of K1's tensor-core bodies (``csrc/fused_dma.cu``) on the card:
where a call's time goes, and the tile shapes around the policy's.

Builds the current ``csrc/fused_dma.cu`` and four ablated copies of it,
each on its own, into libraries under ``build/probe/``: ``loader`` (the
row groups staged, no rows or cols pass), ``rows`` (the rows pass on
whatever the stage holds, no loader and no cols pass), ``cols`` (the cols
pass and its stores on whatever the plane holds, no loader and no rows
pass) and ``skeleton`` (none of the three: setup, barriers and loops):
each copy has the call sites of the parts it leaves out disabled, so what
remains runs as it does in K1. With ``--earlier`` (a
``fused_dma.cu``, e.g. the parent commit's, put into ``build/`` with ``git
show``) that source is built and timed too. Then, on 4 RGB 2160x3840
frames, times in turns (each library's mean of two medians of 20
CUDA-event timings): K1 hybrid, int8 and bf16 direct at sigma 10, and K1a hybrid
and int8 on A4's frame of a dp 2 x sp 2 shard at sigma 9 (the sharded
step); the full build's results are held against the plain versions (int8
``torch.equal``, hybrid and bf16 within 1 count), and each call is also timed
as a CUDA graph replay (the kernel without the wrapper's host time). Then the hybrid and int8
direct forms at the policy's tile and at 128, 240 and 480 rows x 32, 64 and
128 columns where the block fits, at r 9, 32, 65, 99, 165, 332 and 598
(``--tiles``; ``--tiles-all``: at r 32 through every library). Run from the
repository root on a machine with one CUDA card:

    python3 probes/k1_tc_ablation.py [--earlier build/parent_fused_dma.cu \
        --earlier-py build/parent_fused_dma.py] [--variant build/other.cu] [--tiles]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import threading

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from _earlier import in_turns, library  # noqa: E402

from blur_algorithms_tpu_torch import make_plan  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import assemble, fused_dma  # noqa: E402
from blur_algorithms_tpu_torch.ops.pad import reflect_101  # noqa: E402
from blur_algorithms_tpu_torch.parallel.sharded import _local_plan  # noqa: E402
from blur_algorithms_tpu_torch.utils import build, timing  # noqa: E402

ENTRIES = ("blur_fused_u8_k1", "assemble_padded_u8", "assemble_padded_prepad_u8",
           "blur_cuda_error_string")
# the call sites each part of the int8 and hybrid forms runs through
PARTS = {
    "loader": ("load_window(s.stage + (t & 1)", "load_rect(s.stage + (t % p.slots)"),
    "rows": ("rows_mma<B>(s, L, p.tw, p.rows_shift, s.stage + (t",
             "rows_mma<B, true>(s, L, p.tw, p.rows_shift, s.stage + (t"),
    "cols": ("cols_mma<B, kOutU8>(s, L, p, s.plane[0], 0, col_units<B>(p.th, p.tw)",
             "cols_mma<B, kOutU8>(s, L, p, s.plane[0], 0, units"),
}
TILE_ROWS = (128, 240, 480)
TILE_SIGMAS = (3.0, 10.0, 20.0, 30.0, 50.0, 100.0, 180.0)  # r 9, 32, 65, 99, 165, 332, 598


def _ablated(keep: str | None) -> pathlib.Path:
    """``fused_dma.cu`` with the call sites of every part but ``keep``
    disabled (``if (false)``; None: all three, the skeleton of setup,
    barriers and loops), written to ``build/probe/``."""
    src = (build._CSRC / "fused_dma.cu").read_text()
    for part, sites in PARTS.items():
        if part == keep:
            continue
        for site in sites:
            if site not in src:
                raise RuntimeError(f"call site {site!r} of {part} not in fused_dma.cu")
            src = src.replace(site, "if (false) " + site)
    out = build.build_dir() / "probe" / f"fused_dma_{keep}_only.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(src)
    return out


def _entry_lines(log: str, mangled: str) -> list[str]:
    """ptxas's lines for the entry function whose mangled name holds
    ``mangled``."""
    out, on = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            on = mangled in ln
        elif on and ("registers" in ln or "spill" in ln):
            out.append(ln)
    return out


@contextlib.contextmanager
def _serving(lib):
    kept = build._lib
    build._lib = lib
    try:
        yield
    finally:
        build._lib = kept


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--earlier", type=pathlib.Path,
                   help="an earlier fused_dma.cu, timed through --earlier-py")
    p.add_argument("--earlier-py", type=pathlib.Path,
                   help="the cuda_kernels/fused_dma.py that sizes its launches")
    p.add_argument("--variant", type=pathlib.Path, action="append", default=[],
                   help="another fused_dma.cu of the current layout, timed beside")
    p.add_argument("--tiles", action="store_true", help="run the tile sweep")
    p.add_argument("--tiles-all", action="store_true",
                   help="time the r 32 tiles through every library, not the current alone")
    args = p.parse_args()
    earlier_py = None
    if args.earlier:
        import importlib.util

        spec = importlib.util.spec_from_file_location("earlier_fused_dma", args.earlier_py)
        earlier_py = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = earlier_py  # its dataclasses look their module up
        spec.loader.exec_module(earlier_py)
    full = build.load_library()
    srcs = {"current": build._CSRC / "fused_dma.cu",
            **{f"{k} alone": _ablated(k) for k in PARTS}, "skeleton": _ablated(None)}
    if args.earlier:
        srcs["earlier"] = args.earlier
    for v in args.variant:
        srcs[f"variant {v.stem}"] = v
    libs, errs = {}, {}

    logs = {}

    def make(name, src):
        try:
            libs[name], logs[name] = library(src, "k1_" + name.replace(" ", "_"))
        except RuntimeError as err:  # noqa: PERF203
            errs[name] = str(err)

    threads = [threading.Thread(target=make, args=kv) for kv in srcs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise RuntimeError(f"builds failed: {errs}")
    for name in srcs:  # registers and spills of the hybrid direct form
        spills = [ln.replace("ptxas info    :", "").strip()
                  for ln in _entry_lines(logs[name], "k1_directILi1ELb1E")]
        print(f"ptxas {name}: k1_direct<hybrid, uint8 out> {' | '.join(spills)}", flush=True)
    for lib in libs.values():
        for entry in ENTRIES:
            getattr(lib, entry).argtypes = getattr(full, entry).argtypes
            getattr(lib, entry).restype = getattr(full, entry).restype

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 256, (12, 2160, 3840), dtype=np.uint8)).cuda()
    plan = make_plan((2160, 3840), 10.0)
    local = _local_plan(make_plan((2160, 3840), 9.0), 1080, 3840)
    rh, rw = local.col.support_radius, local.row.support_radius
    hx = reflect_101(x[:6, :1080], [(rh, rh)], axes=[-2]).contiguous()

    def calls(mod):
        """The timed calls through one version of fused_dma.py, A4's frames
        at its own geometry."""
        frames = {}
        for rung in ("hybrid", "int8"):
            geo = mod.k1_geometry("assembled", rung, local, 6, device=x.device)
            frames[rung] = assemble.assemble_padded_prepad(hx, rw, rw, geo.hp, geo.wp)
        return {
            "K1 hybrid direct sigma 10": lambda: mod.blur_fused_u8_dma(
                x, plan, precision="hybrid", direct=True),
            "K1 int8 direct sigma 10": lambda: mod.blur_fused_u8_dma(x, plan, direct=True),
            "K1 bf16 direct sigma 10": lambda: mod.blur_fused_u8_dma(
                x, plan, precision="bf16", direct=True),
            "K1a hybrid on caller rows sigma 9": lambda: mod.blur_fused_u8_assembled(
                frames["hybrid"], local, "hybrid"),
            "K1a int8 on caller rows sigma 9": lambda: mod.blur_fused_u8_assembled(
                frames["int8"], local, "int8"),
        }, frames

    now, frames = calls(fused_dma)
    then = calls(earlier_py)[0] if earlier_py else {}
    out = {"device": torch.cuda.get_device_name(0), "times": {}, "graph": {}, "tiles": {}}
    for label, call in now.items():
        with _serving(libs["current"]):
            got = call()
        rung = next(r for r in ("hybrid", "bf16", "int8") if r in label)
        if "K1a" in label:
            want = fused_dma.blur_fused_u8_padded_ref(frames[rung], local, rh, rw, rung)
        else:
            want = fused_dma._plain(x, plan, rung, True)
        err = int((got.int() - want.int()).abs().max())
        ok = torch.equal(got, want) if rung == "int8" else err <= 1
        if not ok:
            raise RuntimeError(f"{label}: {err} counts from its plain version")

        def run(lib, fn):
            with _serving(lib):
                return fn()

        fns = {k: (lambda lib=lib, fn=(then[label] if k == "earlier" else call): run(lib, fn))
               for k, lib in libs.items()}
        t = in_turns(label, fns)
        out["times"][label] = t
        # the kernel alone: the call captured in a CUDA graph and replayed,
        # no host work between the launches (the per-call times above
        # include the wrapper's host time wherever the kernel is shorter)
        with _serving(libs["current"]):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                call()
        out["graph"][label] = timing.time_cuda(graph.replay, iters=20,
                                               name=f"{label} graph").median_ms
        print(f"{label}: {json.dumps(t)} (max_abs_err {err}); current as a CUDA graph "
              f"{out['graph'][label]:.4f} ms", flush=True)
    for sigma in TILE_SIGMAS if args.tiles or args.tiles_all else ():
        p_s = make_plan((2160, 3840), sigma)
        r = p_s.row.support_radius
        # every library at r 32 with --tiles-all, else the current one
        tlibs = libs if (args.tiles_all and sigma == 10.0) else {"current": libs["current"]}
        for rung in ("hybrid", "int8"):
            fns = {"policy": (lambda rung=rung, p_s=p_s: fused_dma.blur_fused_u8_dma(
                x, p_s, None, rung, direct=True))}
            for th in TILE_ROWS:
                for tw in (32, 64, 128):
                    if fused_dma.k1_geometry("direct", rung, p_s, 12, (th, tw), x.device):
                        fns[f"{th}x{tw}"] = (
                            lambda tile=(th, tw), rung=rung, p_s=p_s: fused_dma.blur_fused_u8_dma(
                                x, p_s, tile, rung, direct=True))
            geo = fused_dma.k1_geometry("direct", rung, p_s, 12, None, x.device)
            timed = {f"{name} {k}": (lambda lib=lib, fn=fn: run(lib, fn))
                     for name, lib in tlibs.items() for k, fn in fns.items()}
            t = in_turns(f"K1 {rung} direct tiles r {r}", timed)
            out["tiles"][f"{rung} r {r}"] = {"policy": f"{geo.th}x{geo.tw}", **t}
            best = min(t, key=t.get)
            print(f"K1 {rung} direct r {r} (policy {geo.th}x{geo.tw}) at pinned tiles, best "
                  f"{best}: {json.dumps(t)}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
