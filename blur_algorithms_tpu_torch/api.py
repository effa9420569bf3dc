"""Public API of the port: blurs and separable filters on PyTorch tensors.

The counterpart of the JAX package's ``api.py`` for the fused and band
engines:

- ``blur_u8`` / ``gaussian_blur`` on uint8 ``(..., H, W, C)`` frames: AUTO
  resolves to the fused engine, the precision ladder picks the exact int8
  rung (K1, ``cuda_kernels/fused_dma.py``) where it applies and the bf16x3
  rung (K2, ``cuda_kernels/fused_blur.py``) elsewhere; ``precision=`` pins
  a rung;
- ``blur`` / ``gaussian_blur`` on float planar ``(..., H, W)``: K2 with the
  blur's adjoint as its backward pass (``torch.autograd``), or the band
  engine;
- ``convolve_separable`` (custom odd taps per axis) and ``box_blur`` on
  both layouts, through the same engines.

The device is the input's: a CUDA tensor runs the CUDA kernels, a CPU
tensor their plain PyTorch versions, and nothing is moved between devices.
Every call outside that domain raises ``NotImplementedError`` naming the
ROADMAP.md item that will port it; no other path is substituted silently.
"""

from __future__ import annotations

import enum
import functools

import torch

import numpy as np

from blur_algorithms_tpu_torch.cuda_kernels.fused_blur import (
    MAX_RADIUS,
    blur_fused,
    blur_fused_u8,
    int8_applicable,
)
from blur_algorithms_tpu_torch.ops.band_matmul import blur_band_matmul
from blur_algorithms_tpu_torch.ops.layout import from_planar, to_planar
from blur_algorithms_tpu_torch.ops.plan import BlurPlan, make_custom_plan, make_plan
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
    """The JAX package's engine names; AUTO, FUSED and BAND are ported."""

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
    fixed-point path applies, else ``"bf16x3"`` (signed or custom taps, a
    radius-0 row axis)."""
    r = min(plan.col.support_radius, plan.row.support_radius)
    if plan.kernel in ("gaussian", "box_fast"):
        for rung, floor in (("hybrid", spec.hybrid_cert_min_radius),
                            ("bf16", spec.bf16_cert_min_radius)):
            if floor is not None and r >= floor:
                return rung
    return "int8" if int8_applicable(plan, torch.uint8) else "bf16x3"


def _fused_u8_interleaved(img: torch.Tensor, plan: BlurPlan,
                          precision: str | None = None) -> torch.Tensor:
    """uint8 (..., H, W, C) -> uint8 via the fused engine (K1 or K2)."""
    prec = precision or _u8_dma_precision(plan, device_spec(img.device))
    if prec not in ("int8", "bf16x3"):
        raise NotImplementedError(
            f"the {prec} rung of the fused kernel is not ported yet "
            "(ROADMAP.md Queue 2, K1 hybrid/bf16 bodies)"
        )
    return from_planar(blur_fused_u8(to_planar(img, torch.uint8), plan, prec))


# the ROADMAP.md Queue 1 item that ports each engine not ported yet
_ENGINE_ITEMS = {
    Engine.FFT2: 7, Engine.FFT_TILES: 7, Engine.PFFFT: 7, Engine.FFT_MXU: 7,
    Engine.FFT_STREAM: 7, Engine.BOX: 8, Engine.BOX_SCAN: 8, Engine.CONV: 9,
    Engine.CASCADE: 9, Engine.DERICHE: 9,
}


def _check_ported(engine: Engine) -> None:
    if engine not in (Engine.FUSED, Engine.BAND):
        raise NotImplementedError(
            f"engine {engine.value!r} is not ported yet "
            f"(ROADMAP.md Queue 1 item {_ENGINE_ITEMS[engine]})"
        )


def _blur_planar(x: torch.Tensor, plan: BlurPlan, engine: Engine) -> torch.Tensor:
    """Float planar ``(..., H, W)`` through a ported engine -> float32."""
    _check_ported(engine)
    if engine is Engine.FUSED:
        return blur_fused(x, plan)
    return blur_band_matmul(x, plan)


def _band_u8_interleaved(img: torch.Tensor, plan: BlurPlan) -> torch.Tensor:
    """uint8 (..., H, W, C) through the band engine, rounded back to uint8."""
    return from_planar(blur_band_matmul(to_planar(img), plan))


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


_PRECISIONS = ("int8", "hybrid", "bf16x3")


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
    or ``"fused"`` runs the fused kernels for support radii up to 600
    (``"band"`` the band engine). ``precision`` pins a rung of the fused
    engine: ``"int8"`` (K1, falling back to ``"bf16x3"`` where the exact
    int8 path does not apply) or ``"bf16x3"`` (K2); ``"hybrid"`` is not
    ported yet.
    """
    if not isinstance(img, torch.Tensor):
        raise TypeError(f"blur_u8 expects a torch.Tensor, got {type(img)}")
    if img.dtype != torch.uint8:
        raise TypeError(f"blur_u8 expects uint8, got {img.dtype}")
    if img.ndim < 3:
        raise ValueError("blur_u8 expects (..., H, W, C)")
    engine = Engine(engine)
    if precision is not None:
        if precision not in _PRECISIONS:
            raise ValueError(
                f"precision= must be one of {_PRECISIONS}; got {precision!r}"
            )
        if engine not in (Engine.AUTO, Engine.FUSED):
            raise ValueError(
                "precision= applies to the fused engine (AUTO/FUSED), "
                f"not {engine.value!r}"
            )
        if precision == "hybrid":
            raise NotImplementedError(
                "precision='hybrid' waits for K1's hybrid body and its H100 "
                "certification (ROADMAP.md Next steps 2)"
            )
        engine = Engine.FUSED
    plan, eng = _plan_for(
        img.shape[-3], img.shape[-2], _norm_nsmooth(nsmooth), engine,
        kernel, size_mode,
    )
    _check_ported(eng)
    if eng is Engine.FUSED:
        return _fused_u8_interleaved(img, plan, precision)
    return _band_u8_interleaved(img, plan)


def gaussian_blur(img: torch.Tensor, sigma: float, **kwargs) -> torch.Tensor:
    """True Gaussian blur; uint8 interleaved or float planar, auto-detected."""
    if isinstance(img, torch.Tensor) and img.dtype == torch.uint8:
        return blur_u8(img, sigma, **kwargs)
    return blur(img, sigma, **kwargs)


def blur(
    planar: torch.Tensor,
    nsmooth,
    engine: Engine | str = Engine.AUTO,
    kernel: str = "gaussian",
    size_mode: str = "auto",
) -> torch.Tensor:
    """Blur float planar data ``(..., H, W)``; returns float32 on the same
    device.

    ``nsmooth`` is sigma, or a ``(sigma_y, sigma_x)`` pair. AUTO and
    ``"fused"`` run K2 (differentiable: the backward pass is the blur's
    adjoint), ``"band"`` the band engine, for support radii up to 600.
    """
    if not isinstance(planar, torch.Tensor):
        raise TypeError(f"blur expects a torch.Tensor, got {type(planar)}")
    if planar.ndim < 2:
        raise ValueError("blur expects planar (..., H, W)")
    plan, eng = _plan_for(
        planar.shape[-2], planar.shape[-1], _norm_nsmooth(nsmooth),
        Engine(engine), kernel, size_mode,
    )
    return _blur_planar(planar.to(torch.float32), plan, eng)


def box_blur(img: torch.Tensor, nsmooth: float, passes: int = 2,
             size_mode: str = "auto") -> torch.Tensor:
    """FastBoxBlur-parity box blur: radius = nsmooth^2, default 2 passes.

    ``passes`` sequential reflect-101 box passes are folded into one
    effective-taps pass (``ops/kernels.py``), run by the fused kernels:
    uint8 interleaved ``(..., H, W, C)`` -> uint8 (K1, exact int8), float
    planar ``(..., H, W)`` -> float32 (K2). Past support radius 600 the JAX
    package runs its prefix-scan kernel (K4), not ported yet.
    """
    if not isinstance(img, torch.Tensor):
        raise TypeError(f"box_blur expects a torch.Tensor, got {type(img)}")
    radius = int(float(nsmooth) * float(nsmooth))
    is_u8 = img.dtype == torch.uint8
    if img.ndim < (3 if is_u8 else 2):
        raise ValueError("box_blur expects uint8 (..., H, W, C) or float (..., H, W)")
    h, w = (img.shape[-3], img.shape[-2]) if is_u8 else (img.shape[-2], img.shape[-1])
    plan = _box_plan(h, w, radius, int(passes), size_mode)
    r = max(plan.col.support_radius, plan.row.support_radius)
    if r > MAX_RADIUS:
        raise NotImplementedError(
            f"box_blur at support radius {r} > {MAX_RADIUS} runs the box_scan "
            "kernel K4 (ROADMAP.md Queue 1 item 8)"
        )
    if is_u8:
        return _fused_u8_interleaved(img, plan)
    return blur_fused(img.to(torch.float32), plan)


@functools.lru_cache(maxsize=256)
def _box_plan(h: int, w: int, radius: int, passes: int, size_mode: str) -> BlurPlan:
    return make_plan((h, w), radius, kernel="box_fast", size_mode=size_mode,
                     box_passes=passes)


@functools.lru_cache(maxsize=128)
def _custom_setup(h: int, w: int, tr_bytes: bytes, tc_bytes: bytes,
                  engine: Engine, size_mode: str) -> tuple[BlurPlan, Engine]:
    tr = np.frombuffer(tr_bytes, dtype=np.float32)
    tc = np.frombuffer(tc_bytes, dtype=np.float32)
    plan = make_custom_plan((h, w), tr, tc, size_mode)
    if engine in (Engine.BOX, Engine.BOX_SCAN, Engine.CASCADE):
        raise ValueError(f"engine {engine.value} does not take custom taps")
    return plan, _resolve_engine(engine, plan)


def convolve_separable(
    img: torch.Tensor,
    taps_row,
    taps_col=None,
    engine: Engine | str = Engine.AUTO,
    size_mode: str = "auto",
) -> torch.Tensor:
    """Arbitrary separable correlation filter with reflect-101 borders.

    Any odd-length 1-D taps per axis (sharpen, difference-of-Gaussians,
    derivative filters; ``ops.plan.make_custom_plan`` gives the exact
    semantics), through the fused or band engine. uint8 interleaved
    ``(..., H, W, C)`` rounds back to uint8 (exact int8 K1 for non-negative
    unit-sum taps, K2 otherwise); float planar ``(..., H, W)`` returns
    float32 and is differentiable.
    """
    if not isinstance(img, torch.Tensor):
        raise TypeError(f"convolve_separable expects a torch.Tensor, got {type(img)}")
    taps_col = taps_row if taps_col is None else taps_col
    tr = np.ascontiguousarray(np.asarray(taps_row, np.float32).reshape(-1))
    tc = np.ascontiguousarray(np.asarray(taps_col, np.float32).reshape(-1))
    is_u8 = img.dtype == torch.uint8
    if img.ndim < (3 if is_u8 else 2):
        raise ValueError(
            f"uint8 input must be interleaved (..., H, W, C) and float input "
            f"planar (..., H, W), got {tuple(img.shape)}"
        )
    h, w = (img.shape[-3], img.shape[-2]) if is_u8 else (img.shape[-2], img.shape[-1])
    plan, eng = _custom_setup(h, w, tr.tobytes(), tc.tobytes(), Engine(engine),
                              size_mode)
    _check_ported(eng)
    if not is_u8:
        return _blur_planar(img.to(torch.float32), plan, eng)
    if eng is Engine.FUSED:
        return _fused_u8_interleaved(img, plan)
    return _band_u8_interleaved(img, plan)


def dft_spectrum(img, nsmooth: float = 1.0, size_mode: str = "auto"):
    """Log-magnitude spectrum export: not ported yet."""
    raise NotImplementedError(
        "dft_spectrum is not ported yet (ROADMAP.md Queue 1 item 7)"
    )
