"""The int8 forms of the two-pass wide-radius split (K2's ``_kernel_int8``).

The port of the JAX ``pallas_kernels/fused_blur._kernel_int8`` in its
split forms, through the CUDA kernels of ``csrc/fused_split.cu`` on a CUDA
tensor and their plain PyTorch versions on a CPU tensor:

- ``fused_split_rows_int8``: the rows-only pass over uint8 planes
  (a plan whose column axis has radius 0). ``out_e32=True`` emits the
  14-bit intermediate ``E = 127 (rows_conv(x) - 128)`` as int16 (the JAX
  ``e32="out"``, rows scale stepped by powers of two so that ``E`` is a
  shift of the exact int32 sum); ``out_e32=False`` emits float32
  ``fma(R, f32(1 / Sr), 128)`` (any adaptive scale), the split's pass 1 where pass 2
  cannot run int8. The kernel is a band product on the int8 tensor cores;
  its sums are exact integers, so it is bit-equal to its plain version.
- ``fused_split_cols_int8``: the cols-only pass over int16 ``E`` (a plan
  whose row axis has radius 0): base-128 digits, exact digit products and
  K1's f32 epilogue, uint8 or float32 out (the JAX ``e32="in"``). The
  kernel is a band product on the int8 tensor cores over the digits of
  ``E``, transposed into column-major digit planes as it stages them; its
  sums are exact integers, so it is bit-equal to its plain version.
- ``fused_split_cols_hybrid``: the hybrid pass 2 over the same ``E`` (the
  JAX ``hybrid_cols``): ``y = bf16(f32(E))``, the bf16 column taps summed
  in f32, ``fma(acc, f32(1 / 127), 128)``. The kernel is a band product on
  the bf16 tensor cores that adds each output row's taps in aligned groups
  of 16 of its own tap index (``hybrid_groups``), whatever its tile or
  shard; the plain version adds them one by one in ascending order, so the
  two agree within 2e-2 at 0..255 scale on the f32 store and 1 count on the
  uint8 store, and a shard's pass 2 is bit-equal to the single-card call.

Both cols passes take ``pre_padded_col=True`` (the JAX ``e32="in"`` with
``pre_padded_col``, the sharded path's haloed split,
``fused_blur._blur_fused_haloed_split``): ``E`` then has ``H + 2 rh`` rows,
the caller's halo rows, read as they are and never reflected.

They share the integer taps, quantiser and epilogue constants of K1
(``cuda_kernels/fused_dma.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from blur_algorithms_tpu_torch.cuda_kernels.fused_blur import (
    _INT8_SCALE,
    _PAST_SPLIT,
    SPLIT_MAX_RADIUS,
    pick_int8_scale,
)
from blur_algorithms_tpu_torch.cuda_kernels.fused_dma import (
    _axis_taps,
    _bf16_taps,
    _pack_int8_words,
    _padded_f32,
    bf16_correlate_ref,
    bf16_round_ref,
    epilogue_constants,
    fma_f32_ref,
    int8_cols_ref,
    int8_rows_ref,
    store_u8_ref,
)
from blur_algorithms_tpu_torch.ops.pad import reflect_101
from blur_algorithms_tpu_torch.ops.plan import BlurPlan
from blur_algorithms_tpu_torch.utils import trace

__all__ = [
    "cols_geometry",
    "fused_split_cols_hybrid",
    "fused_split_cols_hybrid_ref",
    "fused_split_cols_int8",
    "fused_split_cols_int8_ref",
    "fused_split_rows_int8",
    "fused_split_rows_int8_ref",
    "hybrid_groups",
    "rows_geometry",
]

# The kernels' tiling (csrc/fused_split.cu), for the models of the tests:
# the rows pass runs blocks of ROWS_TILE (image rows, output columns), the
# int8 cols pass blocks of COLS_TILE and the hybrid pass 2 blocks of
# HYBRID_TILE (output rows, columns); the int8 cols pass streams its window
# in chunks of COLS_CHUNK rows through a ring of COLS_RING rows, column j of
# a digit plane at byte cols_column(j).
ROWS_TILE = (64, 128)
COLS_TILE = (256, 32)
COLS_CHUNK, COLS_RING = 256, 768
COLS_PITCH = COLS_RING + 16
HYBRID_TILE = (256, 64)


def rows_geometry(rw: int) -> tuple[int, int]:
    """``(delta, steps)`` of the rows pass: the taps take ``delta = (-rw)
    mod 16`` leading zeros (each window then starts 16-byte aligned) and run
    in ``steps`` k-steps of 32 window columns, enough for every row of a
    16-column block (``rows_geometry`` in the source)."""
    delta = (16 - rw % 16) % 16
    return delta, (delta + 2 * rw + 1 + 15 + 31) // 32


def rows_smem_bytes(rw: int) -> int:
    """Dynamic shared memory of a rows-pass block: the 64-row window ring
    (1024 + 16 bytes a row) and the four shifted copies of both digits'
    taps (``rows_smem`` in the source)."""
    _, steps = rows_geometry(rw)
    need = 8 * steps + 4
    return ROWS_TILE[0] * 1040 + 2 * 4 * 4 * (need + (8 - need) % 32)


def cols_geometry(rh: int) -> tuple[int, int]:
    """``(steps, words)`` of the int8 cols pass: ``steps`` k-steps of 32
    input rows cover the 2rh + 1 taps of every row of a 16-row block, and
    each of the four shifted copies of a digit's taps has ``words`` words,
    a count = 8 (mod 32) (``cols_geometry`` in the source)."""
    steps = (2 * rh + 1 + 15 + 31) // 32
    need = 8 * steps + 4
    return steps, need + (8 - need) % 32


def cols_column(j: int) -> int:
    """Byte offset of column ``j`` in a digit plane of the int8 cols pass:
    784 bytes a column, each group of 8 columns 64 bytes past the one
    before (``cols_col`` in the source)."""
    return j * COLS_PITCH + (j >> 3) * 64


def cols_smem_bytes(rh: int) -> int:
    """Dynamic shared memory of an int8 cols block: the two digit planes
    (32 columns of 784 bytes, + 192), the 256 threads' staging slots (80
    bytes each) and the tap copies (``cols_smem`` in the source)."""
    plane = cols_column(COLS_TILE[1] - 1) + COLS_PITCH
    return 2 * plane + 256 * 80 + 2 * 4 * 4 * cols_geometry(rh)[1]


def hybrid_smem_bytes(rh: int) -> int:
    """Dynamic shared memory of a hybrid pass 2 block: the 384-row bf16 ring
    (144 bytes a row), the int16 staging chunk and the tap groups
    (``hyb_smem`` in the source)."""
    return 384 * 144 + 128 * 64 * 2 + (hybrid_groups(rh)[0] + 30) * 48


def hybrid_groups(rh: int) -> tuple[int, int]:
    """``(groups, steps)`` of the hybrid pass 2: the column taps in groups
    of 16 and the k-steps of a fragment, whose row ``m`` adds group ``s - m``
    at step ``s``."""
    groups = (2 * rh + 1 + 15) // 16
    return groups, groups + 15


@functools.lru_cache(maxsize=64)
def rows_operands(plan: BlurPlan, out_e32: bool) -> tuple[np.ndarray, int, int]:
    """``(q_row, rows_scale, rows_shift)`` of the rows-only pass, as the JAX
    ``_blur_fused_planar`` picks them for a plan with ``rh == 0``."""
    rows_scale = pick_int8_scale(plan.row.taps, pow2=out_e32)
    shift = 7 + (rows_scale // _INT8_SCALE).bit_length() - 1
    return _axis_taps(plan.row.taps, rows_scale), rows_scale, shift


@functools.lru_cache(maxsize=64)
def cols_operands(plan: BlurPlan) -> tuple[np.ndarray, tuple]:
    """``(q_col, (c1, c2, c3))`` of the cols-only pass."""
    cols_scale = pick_int8_scale(plan.col.taps)
    return _axis_taps(plan.col.taps, cols_scale), epilogue_constants(cols_scale)


def _check(planar: torch.Tensor, plan: BlurPlan, dtype: torch.dtype, axis: str,
           pre_padded_col: bool = False) -> None:
    if planar.dtype != dtype:
        raise TypeError(f"the {axis} split pass takes {dtype} planes, got {planar.dtype}")
    rh, rw = plan.col.support_radius, plan.row.support_radius
    h, w = plan.shape
    want = (h + 2 * rh, w) if pre_padded_col else (h, w)
    if planar.ndim < 2 or tuple(planar.shape[-2:]) != want:
        raise ValueError(
            f"planes of shape {tuple(planar.shape)} do not match the plan's {plan.shape}"
            + (f" with {rh} halo rows each side" if pre_padded_col else "")
        )
    r, other = (rw, rh) if axis == "rows" else (rh, rw)
    if other != 0 or r == 0:
        raise ValueError(f"the {axis}-only split pass takes a plan with only a {axis} radius")
    if r > SPLIT_MAX_RADIUS:
        raise ValueError(f"support radius {r} > {SPLIT_MAX_RADIUS}: {_PAST_SPLIT}")
    taps = plan.row.taps if axis == "rows" else plan.col.taps
    if float(np.min(taps)) < 0.0 or abs(float(np.sum(taps)) - 1.0) >= 1e-5:
        raise ValueError("the int8 split takes non-negative unit-sum taps")


def fused_split_rows_int8_ref(planar_u8: torch.Tensor, plan: BlurPlan,
                              out_e32: bool = True) -> torch.Tensor:
    """Plain version of the rows-only pass: uint8 ``(..., H, W)`` -> int16
    ``E`` (``out_e32``) or float32 ``fma(R, f32(1 / Sr), 128)``."""
    _check(planar_u8, plan, torch.uint8, "rows")
    h, w = plan.shape
    rw = plan.row.support_radius
    q, scale, shift = rows_operands(plan, out_e32)
    x = planar_u8.reshape(-1, h, w)
    r = int8_rows_ref(reflect_101(x, [(rw, rw)]), q, w)
    if out_e32:
        out = ((r + (1 << (shift - 1))) >> shift).to(torch.int16)
    else:
        # one fused multiply-add, as XLA and the kernel round it: the f32
        # product is exact in float64 and the sum rounds (but for a rare
        # double rounding) as the fma's one rounding
        c = float(np.float32(1.0 / scale))
        out = (r.to(torch.float32).to(torch.float64) * c + 128.0).to(torch.float32)
    return out.reshape(planar_u8.shape)


def _cols_input(e16: torch.Tensor, plan: BlurPlan, pre_padded_col: bool) -> torch.Tensor:
    """``(n, H + 2 rh, W)``: ``E`` reflect-101 padded by the column radius,
    or as it is where the caller supplied the halo rows."""
    h, w = plan.shape
    rh = plan.col.support_radius
    if pre_padded_col:
        return e16.reshape(-1, h + 2 * rh, w)
    return reflect_101(e16.reshape(-1, h, w), [(rh, rh)], axes=[-2])


def _out_shape(e16: torch.Tensor, plan: BlurPlan) -> tuple[int, ...]:
    return (*e16.shape[:-2], *plan.shape)


def fused_split_cols_int8_ref(e16: torch.Tensor, plan: BlurPlan,
                              out_u8: bool = True,
                              pre_padded_col: bool = False) -> torch.Tensor:
    """Plain version of the cols-only pass: int16 ``E`` ``(..., H, W)``, or
    ``(..., H + 2 rh, W)`` with ``pre_padded_col``, -> ``(..., H, W)`` uint8
    (``out_u8``) or float32."""
    _check(e16, plan, torch.int16, "cols", pre_padded_col)
    q, constants = cols_operands(plan)
    e = _cols_input(e16, plan, pre_padded_col).to(torch.int32)
    y = int8_cols_ref(e, q, constants, plan.shape[0], out_u8)
    return (store_u8_ref(y) if out_u8 else y).reshape(_out_shape(e16, plan))


# the hybrid epilogue's f32(1 / 127): E = 127 (rows_conv(x) - 128)
_HYBRID_SCALE = np.float32(1.0 / 127.0)


def fused_split_cols_hybrid_ref(e16: torch.Tensor, plan: BlurPlan,
                                out_u8: bool = True,
                                pre_padded_col: bool = False) -> torch.Tensor:
    """Plain version of the hybrid pass 2: int16 ``E`` ``(..., H, W)``, or
    ``(..., H + 2 rh, W)`` with ``pre_padded_col``, -> ``(..., H, W)`` uint8
    (``out_u8``) or float32."""
    _check(e16, plan, torch.int16, "cols", pre_padded_col)
    y = bf16_round_ref(_cols_input(e16, plan, pre_padded_col).to(torch.float32))
    out = fma_f32_ref(bf16_correlate_ref(y, _bf16_taps(plan.col.taps), plan.shape[0], -2),
                      _HYBRID_SCALE, 128.0)
    return (store_u8_ref(out) if out_u8 else out).reshape(_out_shape(e16, plan))


@functools.lru_cache(maxsize=64)
def _device_f32_taps(plan: BlurPlan, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_padded_f32(_bf16_taps(plan.col.taps))).to(device)


@functools.lru_cache(maxsize=64)
def _device_taps(q: bytes, device: torch.device) -> torch.Tensor:
    # hi digits | lo digits, four int8 taps a word
    taps = np.frombuffer(q, dtype=np.int32)
    words = np.concatenate([_pack_int8_words(d.astype(np.int8))
                            for d in (taps >> 7, taps & 127)])
    return torch.from_numpy(words).to(device)


def _launch(name: str, fn, x: torch.Tensor, out: torch.Tensor,
            taps: torch.Tensor, *args) -> None:
    """One launch of the C entry ``name`` over ``x`` (``(n, ., W)``) into
    ``out`` (``(n, H, W)``), which gives the kernel its ``H``; counted on
    ``fn`` (``utils.trace.launched``)."""
    from blur_algorithms_tpu_torch.utils.build import load_library

    if x.shape[0] > 65535:
        raise ValueError(f"the split takes at most 65535 planes, got {x.shape[0]}")
    lib = load_library()
    with torch.cuda.device(x.device):
        rc = getattr(lib, name)(
            x.data_ptr(), out.data_ptr(), taps.data_ptr(), x.shape[0],
            out.shape[1], out.shape[2], *args,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc:
        msg = lib.blur_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
    trace.launched(fn, name, trace.nbytes(x, out, taps))


def _int8_taps(q: np.ndarray, device: torch.device) -> torch.Tensor:
    return _device_taps(np.ascontiguousarray(q, np.int32).tobytes(), device)


def _on_cuda(planar: torch.Tensor, name: str) -> bool:
    if planar.device.type == "cpu":
        return False
    if planar.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {planar.device}")
    if not planar.is_contiguous():
        raise ValueError(f"{name} needs contiguous planes")
    return True


def fused_split_rows_int8(planar_u8: torch.Tensor, plan: BlurPlan,
                          out_e32: bool = True) -> torch.Tensor:
    """The split's int8 pass 1 on uint8 ``(..., H, W)``: int16 ``E``
    (``out_e32``) or float32. A CUDA tensor launches the kernel of
    ``csrc/fused_split.cu``, a CPU tensor runs the plain version;
    ``fused_split_rows_int8.launches`` counts launches."""
    _check(planar_u8, plan, torch.uint8, "rows")
    if not _on_cuda(planar_u8, "fused_split_rows_int8"):
        return fused_split_rows_int8_ref(planar_u8, plan, out_e32)
    with trace.span("launch.fused_split_rows_int8"):
        h, w = plan.shape
        x = planar_u8.reshape(-1, h, w)
        out = torch.empty(x.shape, dtype=torch.int16 if out_e32 else torch.float32,
                          device=x.device)
        if x.shape[0]:
            q, scale, shift = rows_operands(plan, out_e32)
            _launch("fused_split_rows_int8", fused_split_rows_int8, x, out,
                    _int8_taps(q, x.device),
                    plan.row.support_radius, int(out_e32), shift,
                    float(np.float32(1.0 / scale)))
    return out.reshape(planar_u8.shape)


fused_split_rows_int8.launches = 0


def _cols_launch_shapes(e16: torch.Tensor, plan: BlurPlan,
                        out_u8: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``(n, ., W)`` input view and the ``(n, H, W)`` output of a cols pass."""
    x = e16.reshape(-1, *e16.shape[-2:])
    out = torch.empty((x.shape[0], *plan.shape),
                      dtype=torch.uint8 if out_u8 else torch.float32, device=x.device)
    return x, out


def fused_split_cols_int8(e16: torch.Tensor, plan: BlurPlan, out_u8: bool = True,
                          pre_padded_col: bool = False) -> torch.Tensor:
    """The split's int8 pass 2 on int16 ``E`` ``(..., H, W)`` (``(..., H +
    2 rh, W)`` with the caller's halo rows, ``pre_padded_col``): uint8
    (``out_u8``) or float32 ``(..., H, W)``. A CUDA tensor launches the
    kernel of ``csrc/fused_split.cu``, a CPU tensor runs the plain version;
    ``fused_split_cols_int8.launches`` counts launches."""
    _check(e16, plan, torch.int16, "cols", pre_padded_col)
    if not _on_cuda(e16, "fused_split_cols_int8"):
        return fused_split_cols_int8_ref(e16, plan, out_u8, pre_padded_col)
    with trace.span("launch.fused_split_cols_int8"):
        x, out = _cols_launch_shapes(e16, plan, out_u8)
        if x.shape[0]:
            q, constants = cols_operands(plan)
            _launch("fused_split_cols_int8", fused_split_cols_int8, x, out,
                    _int8_taps(q, x.device), plan.col.support_radius, int(out_u8),
                    int(pre_padded_col), *map(float, constants))
    return out.reshape(_out_shape(e16, plan))


fused_split_cols_int8.launches = 0


def fused_split_cols_hybrid(e16: torch.Tensor, plan: BlurPlan, out_u8: bool = True,
                            pre_padded_col: bool = False) -> torch.Tensor:
    """The split's hybrid pass 2 on int16 ``E`` ``(..., H, W)`` (``(..., H +
    2 rh, W)`` with ``pre_padded_col``): uint8 (``out_u8``) or float32
    ``(..., H, W)``. A CUDA tensor launches the kernel of
    ``csrc/fused_split.cu``, a CPU tensor runs the plain version;
    ``fused_split_cols_hybrid.launches`` counts launches."""
    _check(e16, plan, torch.int16, "cols", pre_padded_col)
    if not _on_cuda(e16, "fused_split_cols_hybrid"):
        return fused_split_cols_hybrid_ref(e16, plan, out_u8, pre_padded_col)
    with trace.span("launch.fused_split_cols_hybrid"):
        x, out = _cols_launch_shapes(e16, plan, out_u8)
        if x.shape[0]:
            _launch("fused_split_cols_hybrid", fused_split_cols_hybrid, x, out,
                    _device_f32_taps(plan, x.device), plan.col.support_radius,
                    int(out_u8), int(pre_padded_col), float(_HYBRID_SCALE))
    return out.reshape(_out_shape(e16, plan))


fused_split_cols_hybrid.launches = 0
