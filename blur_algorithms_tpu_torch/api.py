"""Public API of the port: uint8 Gaussian blurs on PyTorch tensors.

The counterpart of the JAX package's ``api.py`` for its main path:
``blur_u8`` / ``gaussian_blur`` with the AUTO or ``"fused"`` engine on
uint8 ``(..., H, W, C)`` tensors. AUTO resolves to the fused engine, the
precision ladder picks the exact int8 rung (the only one certified on a
CUDA device, ``utils/hw.py``), and the frames go planar through the fused
int8 kernel (K1, ``cuda_kernels/fused_dma.py``) and back.

The device is the input's: a CUDA tensor runs the CUDA kernel, a CPU tensor
its plain PyTorch version, and nothing is moved between devices. Every call
outside that domain raises ``NotImplementedError`` naming the ROADMAP.md
item that will port it; no other path is substituted silently.
"""

from __future__ import annotations

import enum
import functools

import torch

from blur_algorithms_tpu_torch.cuda_kernels.fused_blur import int8_applicable
from blur_algorithms_tpu_torch.cuda_kernels.fused_dma import (
    MAX_RADIUS,
    blur_fused_u8_dma,
)
from blur_algorithms_tpu_torch.ops.layout import from_planar, to_planar
from blur_algorithms_tpu_torch.ops.plan import BlurPlan, make_plan
from blur_algorithms_tpu_torch.utils.hw import DeviceSpec, device_spec

__all__ = [
    "Engine",
    "blur",
    "blur_u8",
    "box_blur",
    "convolve_separable",
    "dft_spectrum",
    "gaussian_blur",
]


class Engine(str, enum.Enum):
    """The JAX package's engine names; only AUTO and FUSED are ported."""

    FFT2 = "fft2"
    FFT_TILES = "fft_tiles"
    PFFFT = "pffft"
    CONV = "conv"
    BAND = "band"
    FUSED = "fused"
    BOX = "box"
    BOX_SCAN = "box_scan"
    FFT_MXU = "fft_mxu"
    FFT_STREAM = "fft_stream"
    CASCADE = "cascade"
    DERICHE = "deriche"
    AUTO = "auto"


def _resolve_engine(engine: Engine | str, plan: BlurPlan) -> Engine:
    """AUTO -> FUSED inside the fused kernel's radius domain.

    The JAX package moves AUTO to its MXU FFT past a fused/FFT crossover it
    measured on a TPU; the port's FFT engines are not ported, and the H100
    crossover is not measured yet."""
    engine = Engine(engine)
    if engine is not Engine.AUTO:
        return engine
    r = max(plan.col.support_radius, plan.row.support_radius)
    if r > MAX_RADIUS:
        raise NotImplementedError(
            f"AUTO at support radius {r} > {MAX_RADIUS} routes the wide-radius "
            "split or FFT engines (ROADMAP.md Queue 1 items 6 and 7)"
        )
    return Engine.FUSED


def _u8_dma_precision(plan: BlurPlan, spec: DeviceSpec) -> str:
    """Precision rung for uint8 frames on this device and plan: the fastest
    rung certified on the device, else exact ``"int8"`` where the
    fixed-point path applies, else ``"bf16x3"`` (signed or custom taps)."""
    r = min(plan.col.support_radius, plan.row.support_radius)
    if plan.kernel in ("gaussian", "box_fast"):
        for rung, floor in (("hybrid", spec.hybrid_cert_min_radius),
                            ("bf16", spec.bf16_cert_min_radius)):
            if floor is not None and r >= floor:
                return rung
    return "int8" if int8_applicable(plan, torch.uint8) else "bf16x3"


def _fused_u8_interleaved(img: torch.Tensor, plan: BlurPlan) -> torch.Tensor:
    """uint8 (..., H, W, C) -> uint8 via the fused engine."""
    prec = _u8_dma_precision(plan, device_spec(img.device))
    if prec != "int8":
        raise NotImplementedError(
            f"the {prec} rung of the fused kernel is not ported yet "
            "(ROADMAP.md Queue 2, K1 hybrid/bf16x3 bodies)"
        )
    return from_planar(blur_fused_u8_dma(to_planar(img, torch.uint8), plan))


def _norm_nsmooth(nsmooth) -> float | tuple[float, float]:
    """Hashable nsmooth: float, or (sigma_y, sigma_x) for anisotropic
    gaussian requests (collapsed to a float when the two agree)."""
    if isinstance(nsmooth, (tuple, list)):
        if len(nsmooth) != 2:
            raise ValueError(
                f"anisotropic sigma needs (sigma_y, sigma_x), got {nsmooth}"
            )
        sy, sx = float(nsmooth[0]), float(nsmooth[1])
        return sy if sy == sx else (sy, sx)
    return float(nsmooth)


@functools.lru_cache(maxsize=256)
def _plan_for(
    h: int, w: int, nsmooth, engine: Engine, kernel: str, size_mode: str
) -> tuple[BlurPlan, Engine]:
    plan = make_plan((h, w), nsmooth, kernel=kernel, size_mode=size_mode)
    return plan, _resolve_engine(engine, plan)


def blur_u8(
    img: torch.Tensor,
    nsmooth: float,
    engine: Engine | str = Engine.AUTO,
    kernel: str = "gaussian",
    size_mode: str = "auto",
    precision: str | None = None,
) -> torch.Tensor:
    """Blur interleaved uint8 ``(..., H, W, C)``; returns uint8 on the same
    device.

    ``nsmooth`` is sigma, or a ``(sigma_y, sigma_x)`` pair. ``engine`` AUTO
    or ``"fused"`` runs the fused int8 kernel for support radii up to 600;
    ``precision=`` pins are not ported yet.
    """
    if not isinstance(img, torch.Tensor):
        raise TypeError(f"blur_u8 expects a torch.Tensor, got {type(img)}")
    if img.dtype != torch.uint8:
        raise TypeError(f"blur_u8 expects uint8, got {img.dtype}")
    if img.ndim < 3:
        raise ValueError("blur_u8 expects (..., H, W, C)")
    if precision is not None:
        raise NotImplementedError(
            "precision= pins are not ported yet (ROADMAP.md Queue 2, K1 "
            "hybrid/bf16x3 bodies)"
        )
    plan, eng = _plan_for(
        img.shape[-3], img.shape[-2], _norm_nsmooth(nsmooth), Engine(engine),
        kernel, size_mode,
    )
    if eng is not Engine.FUSED:
        raise NotImplementedError(
            f"engine {eng.value!r} is not ported yet (ROADMAP.md Queue 1)"
        )
    return _fused_u8_interleaved(img, plan)


def gaussian_blur(img: torch.Tensor, sigma: float, **kwargs) -> torch.Tensor:
    """True Gaussian blur of uint8 interleaved frames (float planar input
    is not ported yet)."""
    if isinstance(img, torch.Tensor) and img.dtype == torch.uint8:
        return blur_u8(img, sigma, **kwargs)
    return blur(img, sigma, **kwargs)


def blur(planar, nsmooth, **kwargs):
    """Float planar blur: not ported yet."""
    raise NotImplementedError(
        "float planar blur is not ported yet (ROADMAP.md Queue 1 item 5)"
    )


def box_blur(img, nsmooth, passes: int = 2, size_mode: str = "auto"):
    """FastBoxBlur-parity box blur: not ported yet."""
    raise NotImplementedError("box_blur is not ported yet (ROADMAP.md Queue 1 item 8)")


def convolve_separable(img, taps_row, taps_col=None, **kwargs):
    """Custom separable filters: not ported yet."""
    raise NotImplementedError(
        "custom taps are not ported yet (ROADMAP.md Queue 1 item 5)"
    )


def dft_spectrum(img, nsmooth: float = 1.0, size_mode: str = "auto"):
    """Log-magnitude spectrum export: not ported yet."""
    raise NotImplementedError(
        "dft_spectrum is not ported yet (ROADMAP.md Queue 1 item 7)"
    )
