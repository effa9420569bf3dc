"""Probe of A4 (``assemble_rows_kernel`` of ``csrc/fused_dma.cu``) on the
card: the shipped kernel against its variants and the earlier kernel, in
turns, per call and as CUDA graph replays.

The shard is the sharded path's at its main configuration: 4 RGB 2160x3840
frames (``utils/frames.make_frames``) on dp 2 x sp 2 at sigma 9, the top
shard (6 planes of 1080 rows with 29 halo rows each side) into the frame
``fused_dma.k1_geometry("assembled", ...)`` sizes for it. A4 reads it in
three layouts (``assemble.HaloedRows`` views of the batch: the top shard,
its top halo the block's rows 1..r reversed; the bottom shard, its bottom
halo reversed; an interior block of the same height between two neighbour
views), each held ``torch.equal`` against the plain version, as is each
variant, built into ``build/probe/`` in parallel: the ring variant
(``probes/a4_ring.cu``: each source row staged in shared memory by a 1-D
TMA copy, two rows in flight a warp), the shipped source with
``kA4Unroll`` 1 and 8 (the chunks a lane loads before it stores; 4
shipped) and, with ``--earlier`` (a ``fused_dma.cu``, e.g. the parent
commit's, put into ``build/`` with ``git show``), the earlier A4 (its
``assemble_padded_prepad_u8`` on one contiguous buffer, through a copy of
that commit's Python wrapper). Then, in turns (the mean of two medians of
20 CUDA-event timings), per call, each call captured in a CUDA graph and
replayed (the device's time with no host work between launches), and 10
calls captured in one graph (a call's share, the replay's fixed cost
spread): the earlier A4 on the contiguous shard; A5's launch with no row
border (``assemble.assemble_padded(x, 0, rw, 0, rw, hp, wp)``, the earlier
A4's kernel through the current A5 wrapper); the shipped A4 on the
contiguous shard and on the top shard's views; each variant on the views;
and a ``copy_`` of the contiguous shard. Prints one JSON line with the
times, the bytes bound and the card (also written to ``--out`` if given).
Run from the repository root on a machine with one CUDA card:

    python3 probes/a4_variants.py [--earlier build/parent_fused_dma.cu]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
import threading

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from _earlier import in_turns, library  # noqa: E402

from blur_algorithms_tpu_torch import make_plan  # noqa: E402
from blur_algorithms_tpu_torch.api import _u8_dma_precision  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import assemble, fused_dma  # noqa: E402
from blur_algorithms_tpu_torch.parallel import make_mesh, sharded  # noqa: E402
from blur_algorithms_tpu_torch.parallel.sharded import _local_plan  # noqa: E402
from blur_algorithms_tpu_torch.utils import build  # noqa: E402
from blur_algorithms_tpu_torch.utils.frames import make_frames  # noqa: E402
from blur_algorithms_tpu_torch.utils.hw import device_spec  # noqa: E402

BATCH, H, W, SIGMA = 4, 2160, 3840, 9.0
HBM_BYTES_PER_S = 3.35e12
SRC = ROOT / "blur_algorithms_tpu_torch" / "csrc" / "fused_dma.cu"
UNROLL_LINE = "constexpr int kA4Unroll = 4;"
UNROLLS = {"unroll 1": 1, "unroll 8": 8}  # the shipped source with another kA4Unroll
GRAPH_CALLS = 10  # calls in one graph for the amortized device time


def _graph(fn, calls: int = 1):
    """``calls`` calls of ``fn`` captured in one CUDA graph; the replay
    holds ``fn`` and the tensors it reads."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return lambda graph=graph, fn=fn: graph.replay()


def _earlier_a4(lib):
    """The earlier commit's A4 wrapper (``assemble_padded_prepad`` as it was
    before A4 read row segments), calling ``lib``'s entry."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.assemble_padded_prepad_u8.argtypes = [vp, vp, i, i, i, i, i, i, i, vp]
    lib.assemble_padded_prepad_u8.restype = i

    def a4(x, rw, orw, hp, wp):
        hs, w = x.shape[-2:]
        if rw < 0 or orw < min(rw, w - 1) or hp < 1 or wp < 1:
            raise ValueError("bad frame")
        hp = hp if hp > (hs // 8) * 8 else hp + 8
        if x.dtype != torch.uint8 or not x.is_contiguous() or wp % 16:
            raise ValueError("A4 takes contiguous uint8 planes")
        planes = x.reshape(-1, hs, w)
        out = torch.empty((planes.shape[0], hp, wp), dtype=torch.uint8, device=x.device)
        with torch.cuda.device(x.device):
            rc = lib.assemble_padded_prepad_u8(
                planes.data_ptr(), out.data_ptr(), planes.shape[0], hs, w, rw, orw, hp, wp,
                torch.cuda.current_stream(x.device).cuda_stream)
        if rc:
            raise RuntimeError(f"the earlier A4 failed: CUDA error {rc}")
        return out.reshape(*x.shape[:-2], hp, wp)

    return a4


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--earlier", type=pathlib.Path, help="an earlier fused_dma.cu")
    p.add_argument("--out", type=pathlib.Path, help="also write the JSON line here")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("a4_variants needs a CUDA card")
    shipped = build.load_library()
    text = SRC.read_text()
    srcs = {"ring": ROOT / "probes" / "a4_ring.cu"}
    for name, unroll in UNROLLS.items():
        if UNROLL_LINE not in text:
            raise RuntimeError(f"the shipped source has no {UNROLL_LINE!r}")
        srcs[name] = build.build_dir() / "probe" / f"a4_{name.replace(' ', '_')}.cu"
        srcs[name].parent.mkdir(parents=True, exist_ok=True)
        srcs[name].write_text(text.replace(UNROLL_LINE, f"constexpr int kA4Unroll = {unroll};"))
    if args.earlier:
        srcs["earlier"] = args.earlier
    libs, logs, errs = {}, {}, {}

    def make(name, src):
        try:
            libs[name], logs[name] = library(src, f"a4_{name.replace(' ', '_')}")
        except Exception as err:  # noqa: BLE001 - reported below
            errs[name] = str(err)

    threads = [threading.Thread(target=make, args=kv) for kv in srcs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise RuntimeError(f"builds failed: {errs}")
    variants = {}
    for name, lib in libs.items():
        if name == "earlier":
            continue
        fn = lib.assemble_padded_prepad_rows_u8
        fn.argtypes = shipped.assemble_padded_prepad_rows_u8.argtypes
        fn.restype = ctypes.c_int
        variants[name] = fn
        kernel = "a4_ring_kernel" if name == "ring" else "assemble_rows_kernel"
        lines = logs[name].splitlines()
        at = next(k for k, ln in enumerate(lines) if kernel in ln and "Compiling" in ln)
        print(f"ptxas {name}: " + " | ".join(ln.replace("ptxas info    :", "").strip()
                                             for ln in lines[at + 2 : at + 4]), flush=True)
    earlier = _earlier_a4(libs["earlier"]) if args.earlier else None

    dev = torch.device("cuda", torch.cuda.current_device())
    planar = torch.from_numpy(make_frames(BATCH, H, W)).to(dev)
    plan = make_plan((H, W), SIGMA)
    local = _local_plan(plan, H // 2, W)
    rh, rw = local.col.support_radius, local.row.support_radius
    rung = _u8_dma_precision(local, device_spec(dev))
    planes = BATCH // 2 * 3
    geo = fused_dma.k1_geometry("assembled", rung, local, planes, device=dev)
    hp, wp = geo.hp, geo.wp
    mesh = make_mesh(dp=2, sp=2, devices=[dev] * 4)
    halo = sharded._haloed_row(sharded._blocks(planar, mesh)[0], mesh.devices[0],
                               rh, H // 2, 0, H)
    q = H // 4
    layouts = {
        "top": halo[0],
        "bottom": halo[1],
        "interior": assemble.HaloedRows(planar[: BATCH // 2, :, q - rh : q],
                                        planar[: BATCH // 2, :, q : q + H // 2],
                                        planar[: BATCH // 2, :, q + H // 2 : q + H // 2 + rh]),
    }
    hx = layouts["top"].cat()  # the contiguous shard the earlier route built
    held = {}
    for name, rows in layouts.items():
        want = assemble.assemble_padded_prepad_rows_ref(rows, rw, rw, hp, wp)
        got = {"shipped": assemble.assemble_padded_prepad(rows, rw, rw, hp, wp),
               **{k: assemble._launch(fn, rows.parts(), rw, rw, hp, wp)
                  for k, fn in variants.items()}}
        if name == "top":
            got["shipped, one segment"] = assemble.assemble_padded_prepad(hx, rw, rw, hp, wp)
            got["A5 with no row border"] = assemble.assemble_padded(hx, 0, rw, 0, rw, hp, wp)
            if earlier:
                got["earlier"] = earlier(hx, rw, rw, hp, wp)
        torch.cuda.synchronize()
        for k, v in got.items():
            held[f"{name}: {k}"] = torch.equal(v, want)
    print(f"a4 against its plain version on ({planes}, {hx.shape[-2]}, {W}) -> ({hp}, {wp}): "
          f"{held}", flush=True)
    if not all(held.values()):
        raise RuntimeError(f"an A4 differs from its plain version: {held}")

    top = layouts["top"]
    buf = torch.empty_like(hx)
    fns = {}
    if earlier:
        fns["earlier A4, contiguous shard"] = lambda: earlier(hx, rw, rw, hp, wp)
    fns.update({
        "A5 with no row border, contiguous shard": lambda: assemble.assemble_padded(
            hx, 0, rw, 0, rw, hp, wp),
        "shipped A4, contiguous shard": lambda: assemble.assemble_padded_prepad(
            hx, rw, rw, hp, wp),
        "shipped A4, the top shard's views": lambda: assemble.assemble_padded_prepad(
            top, rw, rw, hp, wp),
        **{f"{k} A4, the top shard's views": (
            lambda fn=fn: assemble._launch(fn, top.parts(), rw, rw, hp, wp))
           for k, fn in variants.items()},
        "copy_ of the contiguous shard": lambda: buf.copy_(hx),
    })
    per_call = in_turns("a4 per call", fns)
    graphs = in_turns("a4 graph", {k: _graph(f) for k, f in fns.items()})
    graphs10 = in_turns(f"a4 graph of {GRAPH_CALLS}", {k: _graph(f, GRAPH_CALLS)
                                                       for k, f in fns.items()})
    graphs10 = {k: v / GRAPH_CALLS for k, v in graphs10.items()}
    nbytes = planes * hx.shape[-2] * W + planes * hp * wp
    out = {
        "device": torch.cuda.get_device_name(0),
        "power_limit": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip(),
        "shard": [planes, hx.shape[-2], W], "frame": [hp, wp], "rung": rung, "rw": rw,
        "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "copy_bytes": 2 * hx.numel(), "copy_bound_ms": 2 * hx.numel() / HBM_BYTES_PER_S * 1e3,
        "per_call_ms": per_call, "graph_ms": graphs, f"graph_of_{GRAPH_CALLS}_ms_a_call": graphs10,
        "host_ms": {k: per_call[k] - graphs[k] for k in fns},
    }
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
