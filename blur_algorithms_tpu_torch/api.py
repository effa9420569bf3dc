"""Public API of the port: blurs, separable filters and the spectrum export
on PyTorch tensors.

The counterpart of the JAX package's ``api.py`` for the fused, band and FFT
engines:

- ``blur_u8`` / ``gaussian_blur`` on uint8 ``(..., H, W, C)`` frames: AUTO
  resolves to the fused engine up to the device's fused/FFT crossover
  (``utils/hw.DeviceSpec.auto_fused_max_radius_u8``) and to FFT_MXU past
  it. In the fused engine the precision ladder picks the hybrid rung (K1's
  hybrid body, ``cuda_kernels/fused_dma.py``), then the bf16 rung (K1's
  bf16 body), each only inside the floor the device certified for the
  plan's tap family (``utils/hw.DeviceSpec``), else the exact int8 rung
  (K1) where it applies and the bf16x3 rung (K2,
  ``cuda_kernels/fused_blur.py``) elsewhere; ``precision=`` pins a rung. FFT_MXU runs the four-step FFT convolution (K3f/K3,
  ``cuda_kernels/fft4step.py``) on planar float32 and rounds back to uint8;
- ``blur`` / ``gaussian_blur`` on float planar ``(..., H, W)``: the same
  routing (``auto_fused_max_radius_f32``); K2 and FFT_MXU are
  differentiable with the blur's adjoint as their backward pass;
- the reference engines ``"fft2"``, ``"fft_tiles"`` and ``"pffft"``
  (``ops/fft_conv.py``, over ``torch.fft``), and ``"band"``, by name;
- ``"fused"`` past support radius 600 runs the two-pass split (int8
  through an int16 intermediate for uint8 frames, f32 otherwise; up to
  r 4096); ``"box"`` / ``"box_scan"`` run the FastBoxBlur box (radius
  nsmooth^2, 2 passes) on the fused engine or the prefix-scan kernel K4
  (``cuda_kernels/box_blur.py``); ``"cascade"`` composes fused blurs
  (``ops/cascade.py``);
- ``convolve_separable`` (custom odd taps per axis, asymmetric ones too)
  and ``box_blur`` on both layouts, ``dft_spectrum`` (the reference's
  ``DFT_image`` mode).

AUTO follows the JAX rule: the fused engine up to the device's fused/FFT
crossover where it serves the frame (its single kernels to r 600, the
two-pass split to r 4096 within ``DeviceSpec.split_hbm_budget``), FFT_MXU
past it; where FFT_MXU's whole-frame intermediates exceed
``DeviceSpec.fft_mxu_byte_budget`` it strip-streams
(``ops/streamed.blur_fft_mxu_streamed(_u8)``) and AUTO reads the streamed
crossover (``auto_fused_max_radius_*_streamed``) in its place, whether it
lies above or below (JAX reads it only above). K3/K3f take every transform
length the JAX package plans (the cluster form past 16384, on 16 CTAs at
262144; the staged form past 262144), so FFT_MXU, its streamer and AUTO serve every axis length.
``"fft_stream"`` runs the
strip-streamed ``torch.fft`` tiles. ``"conv"`` runs ``F.conv1d``
(``ops/direct_conv``, the JAX engine is XLA's convolution) and
``"deriche"`` the recursive Gaussian (``ops/deriche``: K2's single-axis
form for its 511-tap bands, torch ops for the tails); AUTO routes neither,
as in JAX. ``FLAG_TO_ENGINE`` maps the reference CLI's flags 1-5 to
engines. The device is the
input's: a CUDA tensor runs the CUDA kernels, a CPU tensor their plain
PyTorch versions. Where more than one card is visible, AUTO shards a batch
(or a frame past ``DeviceSpec.auto_sp_min_px``) over them through
``parallel/`` (``_auto_sharded_fn``, the JAX rule; the output lands on the
input's card); a CPU tensor and a single card never shard, and a float call
that needs gradients stays on one device. Every call outside that domain
raises ``NotImplementedError`` naming the ROADMAP.md item that will port
it; no other path is substituted silently.
"""

from __future__ import annotations

import enum
import functools
import math

import torch

import numpy as np

from blur_algorithms_tpu_torch.cuda_kernels.box_blur import (
    box_blur_scan,
    box_blur_scan_u8,
)
from blur_algorithms_tpu_torch.cuda_kernels.fft4step import blur_fft_mxu_cuda
from blur_algorithms_tpu_torch.cuda_kernels.fused_dma import (
    blur_fused_u8_dma,
    dma_form_applicable,
)
from blur_algorithms_tpu_torch.cuda_kernels.fused_blur import (
    MAX_RADIUS,
    SPLIT_MAX_RADIUS,
    blur_fused,
    blur_fused_u8,
    int8_applicable,
    split_feasible,
    split_hbm_bytes,
)
from blur_algorithms_tpu_torch.ops import fft_conv
from blur_algorithms_tpu_torch.ops.cascade import blur_cascade, blur_cascade_u8
from blur_algorithms_tpu_torch.ops.band_matmul import blur_band_matmul
from blur_algorithms_tpu_torch.ops.deriche import blur_deriche, blur_deriche_u8
from blur_algorithms_tpu_torch.ops.direct_conv import blur_conv
from blur_algorithms_tpu_torch.ops.fft_mxu import estimate_bytes
from blur_algorithms_tpu_torch.ops.layout import from_planar, to_planar
from blur_algorithms_tpu_torch.ops.plan import BlurPlan, make_custom_plan, make_plan
from blur_algorithms_tpu_torch.ops.spectrum import dft_spectrum_planar
from blur_algorithms_tpu_torch.ops.streamed import (
    blur_fft_mxu_streamed,
    blur_fft_mxu_streamed_u8,
    blur_fft_tiles_streamed,
    blur_fft_tiles_streamed_u8,
)
from blur_algorithms_tpu_torch.utils.hw import DeviceSpec, device_spec
from blur_algorithms_tpu_torch.utils.trace import span

__all__ = [
    "Engine",
    "FLAG_TO_ENGINE",
    "blur",
    "blur_u8",
    "box_blur",
    "convolve_separable",
    "dft_spectrum",
    "gaussian_blur",
]


class Engine(str, enum.Enum):
    """The JAX package's engine names, every one of them ported."""

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


# the reference CLI's flags (``Source.cpp:574-608``), as in the JAX package:
# 5 pocketfft_1D tiles, 4 FastBoxBlur, 3 pffft tiles, 2 pocketfft_2D,
# 1 the cv::GaussianBlur baseline
FLAG_TO_ENGINE = {
    5: Engine.FFT_TILES,
    4: Engine.BOX,
    3: Engine.FFT_TILES,
    2: Engine.FFT2,
    1: Engine.CONV,
}


def _fft_mxu_streams(plan: BlurPlan, lead: int, spec: DeviceSpec) -> bool:
    """Whether FFT_MXU strip-streams this frame: its whole-frame
    intermediates (``estimate_bytes`` over ``lead`` planes) exceed the
    device's byte budget (the JAX rule)."""
    return estimate_bytes(plan, max(1, lead)) > spec.fft_mxu_byte_budget


def _fused_refusal(plan: BlurPlan, in_bytes: int, spec: DeviceSpec,
                   lead: int) -> str | None:
    """Why the fused engine cannot serve this plan on this device, or None.

    Up to ``MAX_RADIUS`` the single kernels serve; past it the two-pass
    split, where it reaches the radius and its peak memory (the JAX
    per-frame estimate, scaled from an RGB frame to ``lead`` planes) fits
    the device's budget (the JAX ``_fused_tile_ok``)."""
    r = max(plan.col.support_radius, plan.row.support_radius)
    if r <= MAX_RADIUS:
        return None
    if not split_feasible(plan, in_bytes):
        return (
            f"the fused engine's two-pass split reaches support radius "
            f"{SPLIT_MAX_RADIUS}, not {r}: no fused tile serves it; use the "
            "fft_mxu, fft_stream or cascade engine"
        )
    prec = "int8" if in_bytes == 1 and int8_applicable(plan, torch.uint8) else None
    need = split_hbm_bytes(plan, in_bytes, prec) * max(1, lead) // 3
    if need > spec.split_hbm_budget:
        return (
            f"the two-pass split needs ~{need} bytes, past the device's budget "
            f"of {spec.split_hbm_budget}: use the fft_mxu or fft_stream engine"
        )
    return None


def _resolve_with_spec(engine: Engine | str, plan: BlurPlan, in_bytes: int,
                       spec: DeviceSpec, lead: int) -> Engine:
    engine = Engine(engine)
    if engine is not Engine.AUTO:
        return engine
    r = max(plan.col.support_radius, plan.row.support_radius)
    u8 = in_bytes == 1
    if _fft_mxu_streams(plan, lead, spec):
        # the FFT side would strip-stream: the crossover measured against
        # the streamer, above or below the whole-frame one
        crossover = (spec.auto_fused_max_radius_u8_streamed if u8
                     else spec.auto_fused_max_radius_f32_streamed)
    else:
        crossover = (spec.auto_fused_max_radius_u8 if u8
                     else spec.auto_fused_max_radius_f32)
    if r <= crossover and _fused_refusal(plan, in_bytes, spec, lead) is None:
        return Engine.FUSED
    return Engine.FFT_MXU


def _resolve_engine(engine: Engine | str, plan: BlurPlan, in_bytes: int = 1,
                    device: torch.device | str = "cpu", lead: int = 3) -> Engine:
    """AUTO -> FUSED up to the device's fused/FFT crossover where the fused
    engine serves the frame, FFT_MXU otherwise (the JAX ``_resolve_engine``).

    ``in_bytes`` is 1 for uint8 frames and 4 for floats (their crossovers
    differ), ``lead`` the number of planes. Where FFT_MXU would strip-stream
    (past its byte budget) the crossover is the device's streamed one.
    FFT_MXU serves every transform length, as in JAX."""
    return _resolve_with_spec(engine, plan, in_bytes, device_spec(device), lead)


def _box_engine(plan: BlurPlan, in_bytes: int, spec: DeviceSpec, lead: int) -> Engine:
    """The engine of a box plan (the JAX ``_compiled_box`` / ``_plan_for``
    rule): AUTO's choice, but the prefix scan (BOX_SCAN, K4) wherever AUTO
    would pick an FFT engine or the fused engine past the device's
    ``box_scan_crossover_radius``."""
    eng = _resolve_with_spec(Engine.AUTO, plan, in_bytes, spec, lead)
    r = max(plan.col.support_radius, plan.row.support_radius)
    if eng in (Engine.FFT_TILES, Engine.FFT_MXU, Engine.FFT_STREAM) or (
        eng is Engine.FUSED and r > spec.box_scan_crossover_radius
    ):
        return Engine.BOX_SCAN
    return eng


def _route(engine: Engine | str, plan: BlurPlan, in_bytes: int,
           device: torch.device, lead: int) -> Engine:
    """Resolve ``engine`` and raise where it cannot serve the call, before
    any data is converted."""
    spec = device_spec(device)
    eng = _resolve_with_spec(engine, plan, in_bytes, spec, lead)
    if eng is Engine.DERICHE and (plan.kernel != "gaussian" or plan.sigma_x is not None):
        raise ValueError("deriche engine approximates isotropic gaussian kernels only")
    if eng is Engine.FUSED and (refusal := _fused_refusal(plan, in_bytes, spec, lead)):
        # past the split's reach or budget, as the JAX ``_pick_tile`` refuses
        raise ValueError(refusal)
    return eng


def _scalar(nsmooth, engine: Engine) -> float:
    """The single scalar nsmooth the box and cascade engines take."""
    if isinstance(nsmooth, tuple):
        what = "cascade engine takes a single scalar sigma"
        if engine is not Engine.CASCADE:
            what = "box engines take a single scalar nsmooth"
        raise ValueError(what)
    return float(nsmooth)


def _box_radius(nsmooth, engine: Engine) -> int:
    """FastBoxBlur call-site semantics: radius = nsmooth^2 (Source.cpp:587)."""
    s = _scalar(nsmooth, engine)
    return int(s * s)


def _streamer(engine: Engine, plan: BlurPlan, lead: int, device: torch.device, *,
              u8: bool):
    """The strip streamer that serves ``engine`` on ``lead`` planes, or None
    for the whole-frame path: FFT_STREAM always, FFT_MXU past the device's
    byte budget (``_fft_mxu_streams``); the uint8 forms take uint8 planes."""
    if engine is Engine.FFT_STREAM:
        return blur_fft_tiles_streamed_u8 if u8 else blur_fft_tiles_streamed
    if engine is Engine.FFT_MXU and _fft_mxu_streams(plan, lead, device_spec(device)):
        return blur_fft_mxu_streamed_u8 if u8 else blur_fft_mxu_streamed
    return None


def _blur_planar(x: torch.Tensor, plan: BlurPlan, engine: Engine) -> torch.Tensor:
    """Float planar ``(..., H, W)`` through a ported engine -> float32."""
    if engine is Engine.FUSED:
        return blur_fused(x, plan)
    if engine is Engine.BOX_SCAN:
        if plan.kernel != "box_fast":
            raise ValueError("box_scan engine requires a box_fast plan")
        return box_blur_scan(x, int(plan.sigma), plan.box_passes)
    if (streamer := _streamer(engine, plan, math.prod(x.shape[:-2]), x.device,
                              u8=False)) is not None:
        return streamer(x, plan)
    if engine is Engine.FFT_MXU:
        return blur_fft_mxu_cuda(x, plan)
    if engine is Engine.FFT2:
        return fft_conv.blur_fft2(x, plan)
    if engine is Engine.FFT_TILES:
        return fft_conv.blur_fft_tiles(x, plan)
    if engine is Engine.PFFFT:
        return fft_conv.blur_fft_tiles(x, plan, pffft_quirk=True)
    if engine is Engine.BAND:
        return blur_band_matmul(x, plan)
    if engine is Engine.CONV:
        return blur_conv(x, plan)
    if engine is Engine.DERICHE:
        return blur_deriche(x, plan.sigma)
    raise ValueError(f"engine {engine} is not a planar blur engine")


def _u8_dma_precision(plan: BlurPlan, spec: DeviceSpec) -> str:
    """Precision rung for uint8 frames on this device and plan (the JAX
    rule): ``"hybrid"`` where the device's hybrid floor for the plan's tap
    family is set, the taps are gaussian or box, the min-axis radius is at
    or past the floor and K1's hybrid body serves the plan; then ``"bf16"``
    under the same rule with the device's bf16 floor (one floor for both
    families, as in the JAX package); else exact ``"int8"`` where the
    fixed-point path applies, else ``"bf16x3"`` (signed or custom taps, a
    radius-0 row axis)."""
    r = min(plan.col.support_radius, plan.row.support_radius)
    if plan.kernel in ("gaussian", "box_fast"):
        for rung, floor in (("hybrid", spec.hybrid_min_radius_for(plan.kernel)),
                            ("bf16", spec.bf16_min_radius)):
            if (floor is not None and r >= floor
                    and dma_form_applicable(torch.uint8, plan, rung)):
                return rung
    return "int8" if int8_applicable(plan, torch.uint8) else "bf16x3"


def _u8_rung(plan: BlurPlan, precision: str | None,
             device: torch.device) -> tuple[str, bool]:
    """The fused engine's rung for uint8 frames, and whether K1 serves it
    directly (``blur_fused_u8_dma``) rather than through ``blur_fused_u8``:
    the rung AUTO routes (``_u8_dma_precision``), or a pinned rung. The
    ``"hybrid"`` pin runs K1's hybrid body (in the form the device's rule
    picks) whatever the split radius, and the ``"int8"`` pin K1's exact int8
    body wherever ``dma_form_applicable`` holds (past it,
    ``blur_fused_u8``'s blocked rule), as the JAX pins run only K1 where it
    applies: exactness is the point of the pin, so the split's hybrid pass 2
    never serves it."""
    direct = precision == "hybrid" or (precision == "int8"
                                       and dma_form_applicable(torch.uint8, plan, "int8"))
    return precision or _u8_dma_precision(plan, device_spec(device)), direct


def _fused_u8_on_rung(img: torch.Tensor, plan: BlurPlan, rung: str,
                      direct: bool) -> torch.Tensor:
    """uint8 (..., H, W, C) -> uint8 via the fused engine on the rung
    ``_u8_rung`` gives."""
    planar = to_planar(img, torch.uint8)
    if direct:
        return from_planar(blur_fused_u8_dma(planar, plan, precision=rung))
    return from_planar(blur_fused_u8(planar, plan, rung))


def _fused_u8_interleaved(img: torch.Tensor, plan: BlurPlan,
                          precision: str | None = None) -> torch.Tensor:
    """uint8 (..., H, W, C) -> uint8 via the fused engine: the rung AUTO
    routes, or the pinned ``precision`` (``_u8_rung``)."""
    return _fused_u8_on_rung(img, plan, *_u8_rung(plan, precision, img.device))


def _auto_sp_min_px(device: torch.device | str) -> int:
    """AUTO shards a frame's rows over devices only from this pixel count
    (``DeviceSpec.auto_sp_min_px``): below it one device finishes fast and
    the halo exchange would not pay."""
    return device_spec(device).auto_sp_min_px


def _auto_sharded_fn(shape: tuple[int, ...], plan: BlurPlan, is_u8: bool,
                     device: torch.device | str):
    """Multi-device AUTO routing (the JAX function of the same name): a
    sharded callable, or None to stay on one device.

    The devices are ``parallel.mesh.visible_devices(device)``: every visible
    card for a CUDA tensor, the CPU alone for a CPU tensor, so AUTO on the
    CPU and on one card never shards. Batches (4-D) shard dp over frames,
    the batch padded and cropped inside ``blur_sharded``, with spare
    devices sharding rows (sp) when the frames clear
    ``_auto_sp_min_px``, else staying dp-only on a subset of the devices; a
    single frame (3-D) from that floor shards its rows over all devices."""
    from blur_algorithms_tpu_torch.parallel import (
        blur_sharded,
        blur_sharded_u8,
        make_mesh,
        mesh as mesh_mod,
    )

    devices = mesh_mod.visible_devices(device)
    ndev = len(devices)
    if ndev <= 1:
        return None
    px = plan.shape[0] * plan.shape[1]
    if len(shape) == 4 and shape[0] >= 2:
        dp = max(d for d in range(1, ndev + 1) if ndev % d == 0 and d <= shape[0])
        sp = ndev // dp
        if sp > 1 and px < _auto_sp_min_px(device):
            # dp-only on a subset: the spare devices idle, which beats a
            # halo exchange on frames too small to amortise it
            mesh = make_mesh(dp=dp, sp=1, devices=devices[:dp])
        else:
            mesh = make_mesh(dp=dp, sp=sp, devices=devices)
    elif len(shape) == 3 and px >= _auto_sp_min_px(device):
        mesh = make_mesh(dp=1, sp=ndev, devices=devices)
    else:
        return None

    if is_u8:
        if len(shape) == 3:
            def fn_sharded(img):
                return blur_sharded_u8(img[None], plan, mesh)[0]
        else:
            def fn_sharded(img):
                return blur_sharded_u8(img, plan, mesh)
    elif len(shape) == 3:
        def fn_sharded(x):
            return blur_sharded(x.to(torch.float32)[None], plan, mesh)[0]
    else:
        def fn_sharded(x):
            return blur_sharded(x.to(torch.float32), plan, mesh)

    fn_sharded._sharded = True  # observable routing marker
    return fn_sharded


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
def _plan_for(h: int, w: int, nsmooth, kernel: str, size_mode: str) -> BlurPlan:
    return make_plan((h, w), nsmooth, kernel=kernel, size_mode=size_mode)


def _u8_lead(img: torch.Tensor) -> int:
    """Planes of an interleaved ``(..., H, W, C)`` frame batch."""
    return math.prod(img.shape[:-3]) * img.shape[-1]


def _through_planar_u8(img: torch.Tensor, plan: BlurPlan, eng: Engine) -> torch.Tensor:
    """uint8 (..., H, W, C) -> planar float32 -> ``eng`` -> uint8 with the
    reference's +0.5 rounding (the JAX package's generic uint8 path); the
    streamed engines (FFT_STREAM, and FFT_MXU past its byte budget) take
    the uint8 planes and convert and round each strip (JAX ``api.py``
    ``_compiled_u8``)."""
    streamer = _streamer(eng, plan, _u8_lead(img), img.device, u8=True)
    if streamer is not None:
        return from_planar(streamer(to_planar(img, torch.uint8), plan))
    return from_planar(_blur_planar(to_planar(img), plan, eng))


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
    runs the fused kernels up to the device's fused/FFT crossover and
    FFT_MXU past it; ``"fused"`` serves support radii up to 600 in one
    kernel and to 4096 through the two-pass split (past that it raises
    ``ValueError``); ``"fft_mxu"`` (strip-streamed from uint8 planes past
    its byte budget) and ``"fft_stream"`` (strip-streamed ``torch.fft``)
    convert and round strip by strip; ``"fft2"``, ``"fft_tiles"``,
    ``"pffft"`` and ``"band"`` run those
    engines on planar float32 and round back; ``"box"`` and ``"box_scan"``
    run the FastBoxBlur box (radius ``nsmooth**2``, 2 passes, as
    ``box_blur``); ``"cascade"`` composes fused blurs with float
    intermediates and one rounding; ``"conv"`` runs the direct convolution
    (``ops/direct_conv``) on planar float32 and rounds back; ``"deriche"``
    the recursive Gaussian (``ops/deriche``, isotropic gaussian only, sigma
    >= 16 on frames that hold its 4.75 sigma reflect pad; else
    ``ValueError``) with one rounding. ``precision`` pins a rung of the fused
    engine: ``"int8"`` (K1, falling back to ``"bf16x3"`` where the exact
    int8 path does not apply), ``"hybrid"`` (K1's hybrid body, support radii
    1..600 and non-negative unit-sum taps; elsewhere it raises
    ``ValueError``, as the JAX pin does) or ``"bf16x3"`` (K2). AUTO routes
    the hybrid and bf16 rungs only inside the device's certified floors.
    The call runs in the span ``api.blur_u8``, its checks and routing in
    ``api.route`` (``utils/trace.py``).
    """
    with span("api.blur_u8"):
        with span("api.route"):
            run, args = _route_u8(img, nsmooth, engine, kernel, size_mode, precision)
        return run(img, *args)


def _route_u8(img, nsmooth, engine, kernel: str, size_mode: str, precision):
    """``blur_u8``'s checks and routing, before any data is touched: the
    function that blurs ``img`` and its further arguments."""
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
        engine = Engine.FUSED
    nsmooth = _norm_nsmooth(nsmooth)
    h, w = img.shape[-3], img.shape[-2]
    if engine is Engine.CASCADE:
        return _cascade_u8, (_scalar(nsmooth, engine), size_mode)
    if engine in (Engine.BOX, Engine.BOX_SCAN):
        return _box_u8, (_box_plan(h, w, _box_radius(nsmooth, engine), 2, size_mode), engine)
    plan = _plan_for(h, w, nsmooth, kernel, size_mode)
    if precision == "hybrid" and not dma_form_applicable(torch.uint8, plan, "hybrid"):
        # the rung exists only as K1's body: raise rather than substitute
        # another rung
        raise ValueError(
            "precision='hybrid' cannot be honored: K1's hybrid body serves "
            "support radii 1..600 with non-negative unit-sum taps, not radii "
            f"{(plan.col.support_radius, plan.row.support_radius)} of this "
            f"{plan.kernel!r} plan; use precision='int8' or let AUTO route"
        )
    if engine is Engine.AUTO and _resolve_engine(
            engine, plan, 1, img.device, _u8_lead(img)) in (Engine.FUSED, Engine.FFT_MXU):
        # multi-device AUTO: the sharded router runs the fused kernels per
        # shard where they serve and the distributed FFT past them
        fn_sharded = _auto_sharded_fn(tuple(img.shape), plan, True, img.device)
        if fn_sharded is not None:
            return fn_sharded, ()
    eng = _route(engine, plan, 1, img.device, _u8_lead(img))
    if eng is Engine.FUSED:
        return _fused_u8_on_rung, (plan, *_u8_rung(plan, precision, img.device))
    if eng is Engine.DERICHE:
        return _deriche_u8, (plan.sigma,)
    return _through_planar_u8, (plan, eng)


def _cascade_u8(img: torch.Tensor, sigma: float, size_mode: str) -> torch.Tensor:
    return from_planar(blur_cascade_u8(to_planar(img, torch.uint8), sigma, size_mode))


def _deriche_u8(img: torch.Tensor, sigma: float) -> torch.Tensor:
    # uint8 planes straight into the rows band; one rounding at the end
    return from_planar(blur_deriche_u8(to_planar(img, torch.uint8), sigma))


def _box_u8(img: torch.Tensor, plan: BlurPlan, engine: Engine) -> torch.Tensor:
    """uint8 ``(..., H, W, C)`` through a box plan: BOX resolves by the box
    rule; the fused engine rounds in its kernel, the scan (K4) rounds in
    its columns pass."""
    if engine is Engine.BOX:
        engine = _box_engine(plan, 1, device_spec(img.device), _u8_lead(img))
    if engine is Engine.BOX_SCAN:
        out = box_blur_scan_u8(to_planar(img, torch.uint8), int(plan.sigma),
                               plan.box_passes)
        return from_planar(out)
    _route(engine, plan, 1, img.device, _u8_lead(img))
    return _fused_u8_interleaved(img, plan)


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

    ``nsmooth`` is sigma, or a ``(sigma_y, sigma_x)`` pair. AUTO runs K2 up
    to the device's fused/FFT crossover and FFT_MXU (K3f/K3) past it, both
    differentiable (the backward pass is the blur's adjoint; FFT_MXU
    strip-streams past its byte budget, as ``"fft_stream"`` always does);
    ``"fused"`` serves support radii up to 600 in one kernel and to 4096
    through the f32 two-pass split; ``"fft2"``, ``"fft_tiles"``, ``"pffft"`` and
    ``"band"`` run those engines (differentiable through ``torch.fft`` and
    ``torch.matmul``); ``"box"`` / ``"box_scan"`` the FastBoxBlur box
    (radius ``nsmooth**2``, 2 passes) and ``"cascade"`` composed fused
    blurs, ``"conv"`` the direct convolution and ``"deriche"`` the
    recursive Gaussian, all differentiable. The call runs in the span
    ``api.blur``, its checks and routing in ``api.route``
    (``utils/trace.py``).
    """
    with span("api.blur"):
        with span("api.route"):
            run, args = _route_planar(planar, nsmooth, engine, kernel, size_mode)
        return run(planar, *args)


def _route_planar(planar, nsmooth, engine, kernel: str, size_mode: str):
    """``blur``'s checks and routing, before any data is touched: the
    function that blurs ``planar`` and its further arguments."""
    if not isinstance(planar, torch.Tensor):
        raise TypeError(f"blur expects a torch.Tensor, got {type(planar)}")
    if planar.ndim < 2:
        raise ValueError("blur expects planar (..., H, W)")
    engine, nsmooth = Engine(engine), _norm_nsmooth(nsmooth)
    h, w = planar.shape[-2], planar.shape[-1]
    lead = math.prod(planar.shape[:-2])
    if engine is Engine.CASCADE:
        return _cascade_f32, (_scalar(nsmooth, engine), size_mode)
    if engine in (Engine.BOX, Engine.BOX_SCAN):
        plan = _box_plan(h, w, _box_radius(nsmooth, engine), 2, size_mode)
        if engine is Engine.BOX:
            engine = _box_engine(plan, 4, device_spec(planar.device), lead)
    else:
        plan = _plan_for(h, w, nsmooth, kernel, size_mode)
        if (engine is Engine.AUTO and not (planar.requires_grad and torch.is_grad_enabled())
                and _resolve_engine(engine, plan, 4, planar.device, lead)
                in (Engine.FUSED, Engine.FFT_MXU)):
            # multi-device AUTO, as blur_u8; a call that needs gradients
            # stays on one device, where the engines have their adjoint
            fn_sharded = _auto_sharded_fn(tuple(planar.shape), plan, False, planar.device)
            if fn_sharded is not None:
                return fn_sharded, ()
    return _blur_f32, (plan, _route(engine, plan, 4, planar.device, lead))


def _cascade_f32(planar: torch.Tensor, sigma: float, size_mode: str) -> torch.Tensor:
    return blur_cascade(planar.to(torch.float32), sigma, size_mode)


def _blur_f32(planar: torch.Tensor, plan: BlurPlan, engine: Engine) -> torch.Tensor:
    return _blur_planar(planar.to(torch.float32), plan, engine)


def box_blur(img: torch.Tensor, nsmooth: float, passes: int = 2,
             size_mode: str = "auto") -> torch.Tensor:
    """FastBoxBlur-parity box blur: radius = nsmooth^2, default 2 passes.

    Routed as the JAX ``_compiled_box``: AUTO's choice on the box plan
    (with the uint8 crossover for both layouts, as there), but the prefix
    scan K4 (``cuda_kernels/box_blur.py``) wherever AUTO would pick an FFT
    engine or the fused engine past the device's
    ``box_scan_crossover_radius``. On the fused engine the ``passes``
    sequential reflect-101 box passes are folded into one effective-taps
    pass (``ops/kernels.py``): uint8 interleaved ``(..., H, W, C)`` ->
    uint8 on AUTO's rung (``blur_u8``'s: K1's hybrid or int8 body, the
    two-pass split from the device's split radius), float planar
    ``(..., H, W)`` -> float32 (K2);
    K4 runs the passes as they are. Float input is differentiable.
    """
    if not isinstance(img, torch.Tensor):
        raise TypeError(f"box_blur expects a torch.Tensor, got {type(img)}")
    radius = int(float(nsmooth) * float(nsmooth))
    is_u8 = img.dtype == torch.uint8
    if img.ndim < (3 if is_u8 else 2):
        raise ValueError("box_blur expects uint8 (..., H, W, C) or float (..., H, W)")
    h, w = (img.shape[-3], img.shape[-2]) if is_u8 else (img.shape[-2], img.shape[-1])
    plan = _box_plan(h, w, radius, int(passes), size_mode)
    lead = _u8_lead(img) if is_u8 else math.prod(img.shape[:-2])
    eng = _box_engine(plan, 1, device_spec(img.device), lead)
    if is_u8:
        return _box_u8(img, plan, eng)
    _route(eng, plan, 1, img.device, lead)
    return _blur_planar(img.to(torch.float32), plan, eng)


@functools.lru_cache(maxsize=256)
def _box_plan(h: int, w: int, radius: int, passes: int, size_mode: str) -> BlurPlan:
    return make_plan((h, w), radius, kernel="box_fast", size_mode=size_mode,
                     box_passes=passes)


@functools.lru_cache(maxsize=128)
def _custom_plan(h: int, w: int, tr_bytes: bytes, tc_bytes: bytes,
                 size_mode: str) -> BlurPlan:
    tr = np.frombuffer(tr_bytes, dtype=np.float32)
    tc = np.frombuffer(tc_bytes, dtype=np.float32)
    return make_custom_plan((h, w), tr, tc, size_mode)


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
    semantics), through the fused, band or FFT engines; asymmetric taps
    run through every FFT engine on the full complex spectrum, but
    ``"pffft"`` (the reference's real-spectrum multiply). uint8 interleaved
    ``(..., H, W, C)`` rounds back to uint8 (exact int8 K1 for non-negative
    unit-sum taps, K2 otherwise, in the fused engine: custom taps are no
    certified tap family, so the hybrid and bf16 rungs never run); float planar
    ``(..., H, W)`` returns float32 and is differentiable.
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
    engine = Engine(engine)
    if engine in (Engine.BOX, Engine.BOX_SCAN, Engine.CASCADE):
        raise ValueError(f"engine {engine.value} does not take custom taps")
    h, w = (img.shape[-3], img.shape[-2]) if is_u8 else (img.shape[-2], img.shape[-1])
    plan = _custom_plan(h, w, tr.tobytes(), tc.tobytes(), size_mode)
    if not is_u8:
        eng = _route(engine, plan, 4, img.device, math.prod(img.shape[:-2]))
        return _blur_planar(img.to(torch.float32), plan, eng)
    eng = _route(engine, plan, 1, img.device, _u8_lead(img))
    if eng is Engine.FUSED:
        return _fused_u8_interleaved(img, plan)
    return _through_planar_u8(img, plan, eng)


@functools.lru_cache(maxsize=128)
def _spectrum_plan(h: int, w: int, nsmooth: float, size_mode: str) -> BlurPlan:
    return make_plan((h, w), nsmooth, size_mode=size_mode)


def dft_spectrum(img: torch.Tensor, nsmooth: float = 1.0,
                 size_mode: str = "auto") -> torch.Tensor:
    """``DFT_image`` mode: log-magnitude spectrum of each channel.

    Accepts uint8 ``(..., H, W, C)`` or float planar ``(..., H, W)``; pads
    exactly like the fft2 blur at the same ``nsmooth`` (the reference reuses
    the blur geometry, ``Source.cpp:240-252``). Returns float32
    ``(..., C, fft_h, fft_w)`` or ``(..., fft_h, fft_w)``.
    """
    if not isinstance(img, torch.Tensor):
        raise TypeError(f"dft_spectrum expects a torch.Tensor, got {type(img)}")
    if img.dtype == torch.uint8:
        if img.ndim < 3:
            raise ValueError("uint8 input must be interleaved (..., H, W, C)")
        planar = to_planar(img)
    else:
        if img.ndim < 2:
            raise ValueError("float input must be planar (..., H, W)")
        planar = img.to(torch.float32)
    plan = _spectrum_plan(planar.shape[-2], planar.shape[-1], float(nsmooth),
                          size_mode)
    return dft_spectrum_planar(planar, plan)
