"""Published peaks of one NVIDIA H100 SXM and the blur's least work.

A frozen copy of ``chip_smoke.py``'s constants and ``_bound_ms`` (NVIDIA's
data sheet, dense rates without sparsity, at the full 700 W power limit), so
that a later change to the port cannot move the yardstick.
"""

from __future__ import annotations

__all__ = [
    "BF16_FLOP_PER_S",
    "F32_FLOP_PER_S",
    "HBM_BYTES_PER_S",
    "INT8_OP_PER_S",
    "TF32_FLOP_PER_S",
    "blur_f32_least_bytes",
    "blur_u8_least_bytes",
    "bound_s",
]

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOP_PER_S = 67e12  # float32 outside the tensor cores
INT8_OP_PER_S = 1979e12  # dense int8 tensor-core rate
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor-core rate
TF32_FLOP_PER_S = 495e12  # dense TF32 tensor-core rate


def bound_s(nbytes: float, ops: float = 0.0, op_rate: float = F32_FLOP_PER_S) -> float:
    """Least time for the work: bytes over the memory rate or operations
    over the peak rate, whichever is larger (``chip_smoke._bound_ms``, in
    seconds)."""
    return max(nbytes / HBM_BYTES_PER_S, ops / op_rate)


def blur_u8_least_bytes(values: int) -> int:
    """The blur's least device traffic on ``values`` uint8 values: each
    input value read once and each output value written once, whatever
    kernels implement it."""
    return 2 * int(values)


def blur_f32_least_bytes(values: int, backward: bool) -> int:
    """The float32 blur's least device traffic on ``values`` values: the
    input read and the output written, 8 bytes a value; with the backward
    also the cotangent read and the gradient written, 16 a value."""
    return (16 if backward else 8) * int(values)
