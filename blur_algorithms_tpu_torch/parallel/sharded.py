"""Sharded blur: dp over frames, sp over image rows with halo exchange.

The port of the JAX package's ``parallel/sharded.py``. Layout: planar
``(B, C, H, W)`` cut into ``(B / dp, C, H / sp, W)`` blocks, block ``(i, j)``
on ``mesh.devices[i][j]``: uint8 end to end for uint8 inputs (halos move as
raw bytes; conversion, the int8 fixed point and the rounding happen inside
the per-shard kernel), float32 otherwise.

Each shard's step is ``fused_blur.blur_fused_haloed``, the single-device
fused engine on rows that carry the caller's halo rows, with the kernel
``blur_fused_u8`` would pick for the shard's plan: the haloed split where it
wins on the device, K1a on A4's frame (``fused_dma.blur_fused_haloed_dma``)
where K1 serves the rung, K2 with ``pre_padded_col`` otherwise. (The JAX
path takes the DMA form wherever it applies; the port follows the H100's
measured split radius instead, as single-device AUTO does.) The only
distributed work is the halo exchange before it: ``r`` rows per shard
boundary (``ppermute``), or whole blocks from ``ceil(r / h_loc)`` neighbours
where the kernel is wider than a shard, indexed with reflect-101 arithmetic
against the true height, so the sharded result equals the single-device
one. Where a shard's device is the input's, the cut and the single-hop
halos are views of the input (``assemble.HaloedRows``: the block, the
neighbours' edge rows, the frame's own edge rows read in reverse for the
reflect-101 halo), and K1a's A4 reads them in place: that route neither
cuts nor concatenates. The split and K2 routes concatenate them once.
Past the device's fused/FFT crossover, where no fused form serves, or where
the gather would copy most of the frame to every shard, the call goes to
``blur_fft_sharded``: the rows pass on H-sharded blocks, one ``all_to_all``
to W-sharded blocks, the columns pass, and back.

The JAX path runs ``shard_map`` in one process; so does this one, with the
shards' steps in turn and ``ppermute`` / ``all_to_all`` as explicit copies
(``.to(device)``) between the mesh's devices. On a mesh of repeated devices
(``[cuda:0] * 4``) every copy stays on the card and the same code runs.
The output lands on the input's device; a mesh of another device type
raises. Nothing here is differentiable (the JAX per-shard kernels have no
VJP either).
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from blur_algorithms_tpu_torch.cuda_kernels.assemble import HaloedRows
from blur_algorithms_tpu_torch.cuda_kernels.fused_blur import (
    blur_fused_haloed,
    haloed_fused_feasible,
)
from blur_algorithms_tpu_torch.ops.plan import BlurPlan
from blur_algorithms_tpu_torch.parallel.mesh import Mesh
from blur_algorithms_tpu_torch.utils.hw import device_spec

__all__ = [
    "all_to_all",
    "blur_fft_sharded",
    "blur_fft_sharded_u8",
    "blur_sharded",
    "blur_sharded_u8",
    "ppermute",
]


def ppermute(blocks: list[torch.Tensor], perm: list[tuple[int, int]],
             devices) -> list[torch.Tensor]:
    """``jax.lax.ppermute`` over a list of per-shard tensors: each ``(src,
    dst)`` pair copies ``blocks[src]`` to ``devices[dst]``; a shard that no
    pair sends to receives zeros."""
    out: list[torch.Tensor | None] = [None] * len(blocks)
    for src, dst in perm:
        out[dst] = blocks[src].to(devices[dst])
    return [torch.zeros_like(blocks[k]) if o is None else o for k, o in enumerate(out)]


def all_to_all(blocks: list[torch.Tensor], split_axis: int, concat_axis: int,
               devices) -> list[torch.Tensor]:
    """``jax.lax.all_to_all(..., tiled=True)`` over a list of per-shard
    tensors: shard ``i`` cuts its block into ``n`` equal chunks along
    ``split_axis`` and sends chunk ``j`` to shard ``j``, which concatenates
    what it receives along ``concat_axis`` in the order of ``i``."""
    n = len(blocks)
    size = blocks[0].shape[split_axis]
    if size % n:
        raise ValueError(f"all_to_all: axis of {size} does not split over {n} shards")
    chunks = [torch.split(b, size // n, dim=split_axis) for b in blocks]
    return [torch.cat([chunks[i][j].to(devices[j]) for i in range(n)], dim=concat_axis)
            for j in range(n)]


@functools.lru_cache(maxsize=256)  # plans hash by identity
def _local_plan(plan: BlurPlan, h_loc: int, w: int) -> BlurPlan:
    """Per-shard plan: the GLOBAL taps on the local row count (the JAX
    function of the same name). Built by replacing the geometry rather than
    re-planning, so the kernel's taps are the single-device plan's even
    where the support exceeds the shard height."""
    return dataclasses.replace(
        plan, shape=(h_loc, w), col=dataclasses.replace(plan.col, dim=h_loc)
    )


def _check(planar: torch.Tensor, plan: BlurPlan, mesh: Mesh) -> None:
    if planar.ndim != 4:
        raise ValueError(f"expected planar frames (B, C, H, W), got {tuple(planar.shape)}")
    h, w = planar.shape[-2:]
    if (h, w) != tuple(plan.shape):
        raise ValueError(f"plan shape {plan.shape} != image shape {(h, w)}")
    kinds = {d.type for row in mesh.devices for d in row}
    if kinds != {planar.device.type}:
        raise ValueError(f"a {planar.device.type} tensor cannot run on a mesh of "
                         f"{sorted(kinds)} devices")


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether ``a`` and ``b`` name one device (a CUDA index of None: the
    current card)."""
    def index(d):
        return torch.cuda.current_device() if d.index is None else d.index

    return a.type == b.type and (a.type != "cuda" or index(a) == index(b))


def _blocks(planar: torch.Tensor, mesh: Mesh) -> list[list[torch.Tensor]]:
    """Block ``(i, j)`` of the ``(dp, sp)`` cut on its device: a view of a
    contiguous ``planar`` where the block's device is ``planar``'s, else a
    contiguous copy (as the cut to another card must be). No caller writes
    into a block or needs it contiguous."""
    views = planar.is_contiguous()
    n_dp, n_sp = mesh.shape["dp"], mesh.shape["sp"]
    bl, hl = planar.shape[0] // n_dp, planar.shape[2] // n_sp
    out = []
    for i in range(n_dp):
        row = []
        for j in range(n_sp):
            blk = planar[i * bl:(i + 1) * bl, :, j * hl:(j + 1) * hl, :]
            dev = mesh.devices[i][j]
            row.append(blk if views and _same_device(dev, planar.device)
                       else blk.to(dev).contiguous())
        out.append(row)
    return out


def _gather(outs: list[list[torch.Tensor]], device: torch.device) -> torch.Tensor:
    """The per-shard outputs, back on ``device`` as one ``(B, C, H, W)``."""
    return torch.cat([torch.cat([o.to(device) for o in row], dim=-2) for row in outs], dim=0)


def _haloed_row(blocks: list[torch.Tensor], devices, r: int, h_loc: int, pad_h: int,
                h: int) -> list[torch.Tensor | HaloedRows]:
    """One dp row's sp blocks with ``r`` halo rows each side: from the
    neighbours, reflect-101 at the frame's top and bottom (the JAX
    ``shard_map`` body's three cases).

    On the single-hop path (``r + 2 pad_h + 1 <= h_loc``) each shard's rows
    are a ``HaloedRows`` of views, with nothing copied on one device: the
    block; the neighbours' edge rows, moved to its device (a peer copy of
    ``r`` rows between cards, no copy on the same one); at the frame's top
    and bottom the block's own rows ``1..r`` and ``lo..lo + r`` marked
    reversed. An indivisible height makes one copy there, the bottom block
    with its pad rows filled; the other parts stay views. A4 reads them in
    place; the other per-shard kernels take their ``cat()``. The multi-hop
    gather copies, and returns one tensor a shard."""
    n_sp = len(blocks)
    if r == 0:
        return [HaloedRows(None, b, None) for b in blocks]
    if r + 2 * pad_h + 1 <= h_loc:
        if pad_h:
            # indivisible height: the bottom shard's zero-pad rows get the
            # reflect-101 continuation of the TRUE image (rows h-2, h-3,
            # ...), so edge-row halos stay right on the cheap path
            last = blocks[-1]
            fill = last[..., h_loc - 2 * pad_h - 1 : h_loc - pad_h - 1, :].flip(-2)
            blocks = [*blocks[:-1], torch.cat([last[..., : h_loc - pad_h, :], fill], dim=-2)]
        # global borders: reflect-101 of the shard's own rows; the bottom
        # mirror continues past the filled pad rows, hence the 2*pad_h shift
        # of its source window. Interior halos: the neighbours' edge rows
        # (ppermute's (j - 1, j) and (j + 1, j) pairs)
        lo = h_loc - 1 - 2 * pad_h - r
        out = []
        for j, blk in enumerate(blocks):
            top = (blk[..., 1 : r + 1, :] if j == 0
                   else blocks[j - 1][..., -r:, :].to(devices[j]))
            bot = (blk[..., lo : lo + r, :] if j == n_sp - 1
                   else blocks[j + 1][..., :r, :].to(devices[j]))
            out.append(HaloedRows(top, blk, bot, top_reversed=j == 0,
                                  bot_reversed=j == n_sp - 1))
        return out
    # kernel wider than a shard (or a padded height the fill cannot serve):
    # whole blocks from the k nearest neighbours each way (absent sources
    # deliver zeros), then the (2k+1)-block context indexed with reflect-101
    # row arithmetic against the TRUE height; outputs of the zero-pad rows
    # (>= h) are garbage and cropped by the caller
    k = min(-(-r // h_loc), n_sp - 1)
    above = [ppermute(blocks, [(i, i + d) for i in range(n_sp - d)], devices)
             for d in range(k, 0, -1)]
    below = [ppermute(blocks, [(i + d, i) for i in range(n_sp - d)], devices)
             for d in range(1, k + 1)]
    out = []
    for j, blk in enumerate(blocks):
        ext = torch.cat([a[j] for a in above] + [blk] + [b[j] for b in below], dim=-2)
        # ext row 0 is global row (j - k) * h_loc; plan clamping keeps
        # r <= h - 1, so one reflection lands inside for every real output
        # row; the clip only matters for the cropped pad rows
        g = j * h_loc + torch.arange(-r, h_loc + r)
        g = torch.where(g < 0, -g, g)
        g = torch.where(g > h - 1, 2 * (h - 1) - g, g)
        g = torch.clamp(g, 0, h - 1)
        out.append(ext.index_select(-2, (g - (j - k) * h_loc).to(ext.device)))
    return out


def blur_sharded(planar: torch.Tensor, plan: BlurPlan, mesh: Mesh,
                 out_u8: bool = False) -> torch.Tensor:
    """Blur planar frames ``(B, C, H, W)`` over a ``(dp, sp)`` mesh.

    uint8 input stays uint8 through the cut and the halo exchange and
    converts inside the per-shard kernel, which runs the device's certified
    rung (``api._u8_dma_precision``) there; float input runs float32.
    ``out_u8`` rounds in the kernel and returns uint8. An indivisible batch
    or height is zero-padded to the mesh and cropped after. Returns on the
    input's device.
    """
    _check(planar, plan, mesh)
    b, c, h, w = planar.shape
    n_dp, n_sp = mesh.shape["dp"], mesh.shape["sp"]
    # indivisible batch/height: zero-pad up to the mesh grid and crop after.
    # The padded rows never leak into real outputs: the halo arithmetic
    # reflects against the TRUE height
    pad_b, pad_h = (-b) % n_dp, (-h) % n_sp
    if pad_b or pad_h:
        planar = F.pad(planar, (0, 0, 0, pad_h, 0, 0, 0, pad_b))
    h_loc = (h + pad_h) // n_sp
    r = plan.col.support_radius
    local_plan = _local_plan(plan, h_loc, w)
    shard_device = mesh.devices[0][0]
    spec = device_spec(shard_device)

    is_u8 = planar.dtype == torch.uint8
    precision = "int8" if is_u8 else "bf16x3"

    # Wide-radius routing: the distributed FFT where (a) no fused form
    # serves the per-shard plan, (b) the radius is past the device's
    # fused/FFT crossover (single-device AUTO runs FFT_MXU there), or (c)
    # the whole-block gather would copy close to the frame into every shard
    if r > 0:
        in_bytes = 1 if is_u8 else 4
        r_max = spec.auto_fused_max_radius_u8 if is_u8 else spec.auto_fused_max_radius_f32
        k = min(-(-r // h_loc), n_sp - 1)
        ctx_bytes = ((b + pad_b) // n_dp) * c * (2 * k + 1) * h_loc * w * in_bytes
        if (not haloed_fused_feasible(local_plan, in_bytes, precision, shard_device)
                or r > r_max or ctx_bytes > spec.split_hbm_budget // 2):
            if pad_b or pad_h:  # delegate the original, unpadded frames
                planar = planar[:b, :, :h, :]
            return blur_fft_sharded(planar, plan, mesh, out_u8=out_u8)
    if not is_u8:
        planar = planar.to(torch.float32)

    # per-shard compute: uint8 shards take the single-device precision
    # ladder; blur_fused_haloed picks the kernel as blur_fused_u8 does (the
    # haloed split where it wins on this device, else K1a on caller-supplied
    # rows where K1 serves the rung, else K2)
    if is_u8:
        from blur_algorithms_tpu_torch.api import _u8_dma_precision

        precision = _u8_dma_precision(local_plan, spec)
    outs = [[blur_fused_haloed(x, local_plan, precision=precision, out_u8=out_u8)
             for x in _haloed_row(row, mesh.devices[i], r, h_loc, pad_h, h)]
            for i, row in enumerate(_blocks(planar, mesh))]
    out = _gather(outs, planar.device)
    if pad_b or pad_h:
        out = out[:b, :, :h, :].contiguous()
    return out


def blur_sharded_u8(img: torch.Tensor, plan: BlurPlan, mesh: Mesh) -> torch.Tensor:
    """uint8 frames ``(B, H, W, C)`` in -> uint8 out, sharded pipeline:
    uint8 end to end, rounded in the per-shard kernel."""
    planar = img.movedim(-1, -3).contiguous()
    return blur_sharded(planar, plan, mesh, out_u8=True).movedim(-3, -1).contiguous()


def blur_fft_sharded(planar: torch.Tensor, plan: BlurPlan, mesh: Mesh,
                     out_u8: bool = False) -> torch.Tensor:
    """FFT-engine blur of planar ``(B, C, H, W)`` over a ``(dp, sp)`` mesh.

    The distributed-FFT decomposition: the rows pass on H-sharded blocks
    (every row whole on one device), one ``all_to_all`` to W-sharded blocks,
    the columns pass, and the inverse flip; no halo exchange, and no device
    holds a whole frame. Semantics are ``fft_tiles``' (``ops/fft_conv.
    _tile_pass``, over ``torch.fft``). Indivisible B/H/W pad-and-crop: each
    pass slices its axis back to the true length first and re-pads after.
    """
    from blur_algorithms_tpu_torch.ops.fft_conv import _tile_pass
    from blur_algorithms_tpu_torch.ops.layout import round_to_u8

    _check(planar, plan, mesh)
    b, c, h, w = planar.shape
    n_dp, n_sp = mesh.shape["dp"], mesh.shape["sp"]
    pad_b, pad_h, pad_w = (-b) % n_dp, (-h) % n_sp, (-w) % n_sp
    if pad_b or pad_h or pad_w:
        planar = F.pad(planar, (0, pad_w, 0, pad_h, 0, 0, 0, pad_b))

    outs = []
    for i, row in enumerate(_blocks(planar, mesh)):
        devices = mesh.devices[i]
        ys = []
        for block in row:
            y = _tile_pass(block[..., :w].to(torch.float32), plan.row, -1)
            ys.append(F.pad(y, (0, pad_w)) if pad_w else y)
        if n_sp > 1:  # H-sharded -> W-sharded
            ys = all_to_all(ys, 3, 2, devices)
        ys = [_tile_pass(y[..., :h, :], plan.col, -2) for y in ys]
        if pad_h:
            ys = [F.pad(y, (0, 0, 0, pad_h)) for y in ys]
        if n_sp > 1:  # and back
            ys = all_to_all(ys, 2, 3, devices)
        outs.append([round_to_u8(y) if out_u8 else y for y in ys])
    out = _gather(outs, planar.device)
    if pad_b or pad_h or pad_w:
        out = out[:b, :, :h, :w].contiguous()
    return out


def blur_fft_sharded_u8(img: torch.Tensor, plan: BlurPlan, mesh: Mesh) -> torch.Tensor:
    """uint8 frames ``(B, H, W, C)`` through the sharded FFT pipeline."""
    planar = img.movedim(-1, -3).contiguous()
    return blur_fft_sharded(planar, plan, mesh, out_u8=True).movedim(-3, -1).contiguous()
