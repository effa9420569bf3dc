"""B3: what K1's loaders fetch, with no band work.

The port of the JAX package's ``benchmarks/dma_fetch_rate.py``: on the
padded frame of a batch of 4 RGB 4K frames at r 32 (12 planes of 2224 x
4096 bytes), fetch each plane's 10 windows of 2224 x 640 bytes at a
384-column stride (``windowed``), or the whole plane (``strip``), and store
only ``[:8, :128]`` of the last window or of the plane, so that the fetch
cannot be dropped and the store can be checked. Here the windows are
fetched by 16-byte ``cp.async`` or by TMA boxes, and beside them K1's own
loaders at the tile ``fused_dma.k1_geometry`` picks for ``blur_u8`` at
sigma 10 on the same batch, as the int8 and hybrid bodies stage raw bytes:
the direct form's windows (16-byte ``cp.async`` inside the frame, mirrored
aligned words past its edges) and the assembled form's (K1a) rectangles of
A5's padded frame; each stores ``[:8, :128]`` of its plane's last window.

A CUDA tensor runs ``csrc/probes/fetch_rate.cu``; a CPU tensor the plain
versions (the slices the kernels store). Rates: bytes fetched per second,
frame bytes per second, and their ratio, the read amplification.

Run: ``python -m blur_algorithms_tpu_torch.benchmarks.dma_fetch_rate``
(``--device cpu``: the plain versions' stores). Prints JSON lines; writes no
file.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from blur_algorithms_tpu_torch.benchmarks._common import (
    check_launch,
    device_arg,
    device_of,
    emit,
)

__all__ = ["BC", "HP", "NBW", "SHP", "SWP", "TH", "TW", "WP", "K1Loader", "fetch_k1",
           "fetch_k1_ref", "fetch_windows", "fetch_windows_ref", "k1_bytes", "k1_loader",
           "window_bytes"]

# the JAX probe's geometry (dma_fetch_rate.py main): padded frame (BC, HP,
# WP) uint8, windows of (SHP, SWP) at a TW-column stride, NBW a plane
BC, HP, WP = 12, 2224, 4096
TH, TW = 2160, 384
SHP, SWP = 2224, 640
NBW = 10

STORE = (8, 128)  # what every store holds per plane
_G_WINDOW = 16  # rows a ring slot holds for the windows (TMA box height)
_G_STRIP = 8  # for the strip (4096 bytes a row)
# rows a block fetches (a multiple of its slots' rows): ~128-160 KB a block,
# 1080 blocks for the windows and 840 for the strips
_CHUNK_WINDOW, _CHUNK_STRIP = 256, 32


def window_bytes(width: int = SWP, nwin: int = NBW, planes: int = BC, rows: int = SHP) -> int:
    """Bytes ``nwin`` windows of ``rows`` x ``width`` fetch on every plane."""
    return planes * nwin * rows * width


def fetch_windows_ref(frame: torch.Tensor, strip: bool = False) -> torch.Tensor:
    """Plain version: ``[:8, :128]`` of each plane's last window (or of the
    plane)."""
    col = 0 if strip else (NBW - 1) * TW
    return frame[:, :STORE[0], col:col + STORE[1]].clone()


def _check_frame(frame: torch.Tensor) -> None:
    if frame.dtype != torch.uint8 or frame.ndim != 3 or frame.shape[1:] != (HP, WP):
        raise ValueError(f"B3 takes a ({BC}, {HP}, {WP})-like uint8 frame, got "
                         f"{tuple(frame.shape)} {frame.dtype}")


def fetch_windows(frame: torch.Tensor, *, strip: bool = False, tma: bool = False) -> torch.Tensor:
    """The windows (or the strip) of every plane of ``frame`` through a
    shared-memory ring: 16-byte cp.async, or TMA boxes (``tma``). A CUDA
    tensor launches the kernel, a CPU tensor runs the plain version.
    ``fetch_windows.launches[form]`` counts, the form "windowed",
    "windowed_tma" or "strip"."""
    _check_frame(frame)
    if frame.device.type == "cpu":
        return fetch_windows_ref(frame, strip)
    if frame.device.type != "cuda" or not frame.is_contiguous():
        raise ValueError(f"B3 runs on contiguous CUDA or CPU frames, not {frame.device}")
    if strip and tma:
        raise ValueError("the TMA form fetches the windows")
    from blur_algorithms_tpu_torch.utils.build import load_probe_library

    out = torch.empty((frame.shape[0], *STORE), dtype=torch.uint8, device=frame.device)
    width, nwin, g, chunk = ((WP, 1, _G_STRIP, _CHUNK_STRIP) if strip
                             else (SWP, NBW, _G_WINDOW, _CHUNK_WINDOW))
    slots = 4 if tma else 3
    rc = load_probe_library().fetch_windows(
        int(tma), frame.data_ptr(), out.data_ptr(), frame.shape[0], HP, WP, width, TW, nwin,
        chunk, g, slots * g * width, torch.cuda.current_stream(frame.device).cuda_stream)
    check_launch(rc, "fetch_windows")
    fetch_windows.launches["strip" if strip else "windowed_tma" if tma else "windowed"] += 1
    return out


fetch_windows.launches = dict.fromkeys(("windowed", "windowed_tma", "strip"), 0)


@dataclasses.dataclass(frozen=True)
class K1Loader:
    """K1's staging at one plan: the tile, the padded windows and the shared
    memory of the form's block (``fused_dma.k1_geometry``)."""

    th: int
    tw: int
    rh: int
    rw: int
    rows: int  # window rows a tile stages: round16(th + 2rh)
    sw: int  # window bytes a row
    delta: int  # the direct window starts delta columns left of j0 - rw
    smem: int
    slots: int  # the assembled form's buffers (0 for direct)
    xh: int  # A5's padded frame (assembled)
    xw: int

    @property
    def window(self) -> tuple[int, int]:
        """Rows and bytes of a row the form stages per tile."""
        return self.rows, self.sw


def k1_loader(plan, form: str, device: torch.device, precision: str = "hybrid",
              planes: int = BC) -> K1Loader:
    """K1's ``form`` ("direct" or "assembled") as ``k1_geometry`` sizes it
    for ``precision`` on ``planes`` planes on ``device`` (the H100's
    shared memory on the CPU)."""
    from blur_algorithms_tpu_torch.cuda_kernels.fused_dma import k1_geometry, tc_layout

    if precision == "bf16" or form not in ("direct", "assembled"):
        raise ValueError(f"the probe times the int8 and hybrid bodies' direct and assembled "
                         f"loaders, not {precision} {form}")
    geo = k1_geometry(form, precision, plan, planes, device=device)
    if geo is None:
        raise ValueError(f"K1's {form} form does not serve this plan")
    rh, rw = plan.col.support_radius, plan.row.support_radius
    lay = tc_layout(form, precision, geo.th, geo.tw, rh, rw, geo.slots)
    lo = K1Loader(geo.th, geo.tw, rh, rw, lay.rows, lay.sw, lay.delta, geo.smem, geo.slots,
                  geo.hp, geo.wp)
    if lo.window[1] < STORE[1]:
        raise ValueError(f"K1's {form} window is {lo.window[1]} bytes wide: the probe "
                         f"stores {STORE[1]}")
    return lo


def _last_tile(h: int, w: int, lo: K1Loader) -> tuple[int, int]:
    return (-(-h // lo.th) - 1) * lo.th, (-(-w // lo.tw) - 1) * lo.tw


def fetch_k1_ref(planar: torch.Tensor, lo: K1Loader,
                 frame: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: ``[:8, :128]`` of the last tile's window of each plane,
    as the form stages it: the direct form's reflect-101 gather of the
    planes, or the assembled form's rectangle of A5's padded ``frame`` (the
    planes at (rh, rw), reflect-101 out to rw columns past the edge and
    zeros past that; ``assemble_padded_ref``'s where none is given)."""
    h, w = planar.shape[-2:]
    i0, j0 = _last_tile(h, w, lo)
    x = planar.reshape(-1, h, w)
    if lo.slots:
        if frame is None:
            from blur_algorithms_tpu_torch.cuda_kernels.assemble import assemble_padded_ref

            frame = assemble_padded_ref(x, lo.rh, lo.rw, lo.rh, lo.rw, lo.xh, lo.xw)
        return frame[:, i0:i0 + STORE[0], j0:j0 + STORE[1]].clone()
    rows = _reflect101(i0 - lo.rh + np.arange(STORE[0]), h)
    cols = _reflect101(j0 - lo.rw - lo.delta + np.arange(STORE[1]), w)
    return x[:, torch.from_numpy(rows)][:, :, torch.from_numpy(cols)].clone()


def _reflect101(i: np.ndarray, n: int) -> np.ndarray:
    i = np.abs(i)
    return np.where(i > n - 1, 2 * (n - 1) - i, i)


def fetch_k1(planar: torch.Tensor, lo: K1Loader, frame: torch.Tensor | None = None) -> torch.Tensor:
    """K1's loader over uint8 planes ``(..., H, W)``: the direct form's
    gather (``lo.slots == 0``), or the assembled form's cp.async from A5's
    padded ``frame``. A CUDA tensor launches the kernel, a CPU tensor runs
    the plain version. ``fetch_k1.launches[form]`` counts, the form
    "direct" or "assembled"."""
    if planar.dtype != torch.uint8 or planar.ndim < 2:
        raise ValueError(f"K1's loaders take uint8 planes, got {planar.dtype}")
    if planar.device.type == "cpu":
        return fetch_k1_ref(planar, lo, frame)
    h, w = planar.shape[-2:]
    x = planar.reshape(-1, h, w)
    assembled = lo.slots > 0
    if assembled and (frame is None or frame.shape != (x.shape[0], lo.xh, lo.xw)):
        raise ValueError(f"the assembled form reads A5's ({x.shape[0]}, {lo.xh}, {lo.xw}) frame")
    src = frame if assembled else x
    if not src.is_contiguous():
        raise ValueError("K1's loaders read contiguous planes")
    from blur_algorithms_tpu_torch.utils.build import load_probe_library

    out = torch.empty((x.shape[0], *STORE), dtype=torch.uint8, device=x.device)
    rc = load_probe_library().fetch_k1(
        int(assembled), src.data_ptr(), out.data_ptr(), x.shape[0], h, w, lo.th, lo.tw,
        lo.rh, lo.rw, lo.xh, lo.xw, lo.slots, lo.smem,
        torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(rc, "fetch_k1")
    fetch_k1.launches["assembled" if assembled else "direct"] += 1
    return out


fetch_k1.launches = dict.fromkeys(("direct", "assembled"), 0)


def k1_bytes(h: int, w: int, lo: K1Loader, planes: int) -> int:
    """Bytes a K1 loader fetches: every tile's window."""
    rows, row_bytes = lo.window
    return planes * -(-h // lo.th) * -(-w // lo.tw) * rows * row_bytes


def main(argv: list[str] | None = None) -> int:
    from blur_algorithms_tpu_torch import make_plan
    from blur_algorithms_tpu_torch.cuda_kernels.assemble import assemble_padded
    from blur_algorithms_tpu_torch.utils.timing import time_cuda

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    device_arg(p)
    args = p.parse_args(argv)
    device = device_of(args.device)
    rng = np.random.default_rng(0)
    frame = torch.from_numpy(rng.integers(0, 256, (BC, HP, WP), dtype=np.uint8)).to(device)
    planar = torch.from_numpy(rng.integers(0, 256, (BC, 2160, 3840), dtype=np.uint8)).to(device)
    plan = make_plan((2160, 3840), 10.0)
    jobs = [("windowed cp.async", lambda: fetch_windows(frame), window_bytes(), frame.numel()),
            ("strip cp.async", lambda: fetch_windows(frame, strip=True),
             window_bytes(WP, 1), frame.numel())]
    if device.type == "cuda":
        jobs.insert(1, ("windowed TMA", lambda: fetch_windows(frame, tma=True), window_bytes(),
                        frame.numel()))
    for form in ("direct", "assembled"):
        lo = k1_loader(plan, form, device)
        padded = (assemble_padded(planar, lo.rh, lo.rw, lo.rh, lo.rw, lo.xh, lo.xw)
                  if lo.slots else None)
        jobs.append((f"K1 {form}", lambda lo=lo, padded=padded: fetch_k1(planar, lo, padded),
                     k1_bytes(2160, 3840, lo, BC), planar.numel()))
    for name, fn, fetched, frame_bytes in jobs:
        rec = {"probe": "B3", "loader": name, "fetched_bytes": fetched,
               "frame_bytes": frame_bytes, "read_amplification": fetched / frame_bytes}
        if device.type == "cuda":
            ms = time_cuda(fn, iters=20, name=name).median_ms
            rec.update(ms=ms, fetched_gbps=fetched / ms / 1e6, frame_gbps=frame_bytes / ms / 1e6,
                       device=torch.cuda.get_device_name(device))
        else:
            rec.update(device="cpu", store_sum=int(fn().sum()))
        emit(rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
