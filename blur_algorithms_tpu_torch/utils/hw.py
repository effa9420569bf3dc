"""What the port knows of the device it runs on.

The JAX package keys routing budgets and certified precision rungs by TPU
kind (its ``utils/hw.py``). None of those numbers carries over: each was
measured on a TPU. The port reads the CUDA device's own properties, and
takes its precision floors and ceilings from ``_MEASURED_PRECISION``, the
port's run of the JAX certification protocol on the card
(``python -m blur_algorithms_tpu_torch.certify``). A device that was not
measured keeps every floor at ``None``, so AUTO routes only the
always-exact int8 rung there.

The routing radii are per device name, from the interleaved sweeps of
``chip_smoke.py`` (phase 10: fused against FFT_MXU; phase 13: box scan
against the fused engine, and the two-pass split against the single
kernel; phase 15: K1's staging forms against its direct form) recorded in
PERF.md. A device that was not measured keeps the
fused engine up to its single-kernel domain (support radius 600), runs
FFT_MXU past it, runs the box scan only past 600 and the split only where
the single kernels cannot serve (past 600).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

__all__ = ["DeviceSpec", "device_spec", "spec_for"]

# Whole-frame FFT_MXU intermediates on the CPU: a fixed budget, since the
# host's free memory is no property of the tensor's device.
CPU_FFT_MXU_BYTE_BUDGET = 4 << 30
# Peak bytes of the two-pass split on the CPU, fixed for the same reason.
CPU_SPLIT_HBM_BUDGET = 4 << 30

# Largest swept support radius at which the fused engine as routed (K1 on
# its AUTO rung, or K2; the two-pass split from ``fused_split_min_radius``)
# is still at least as fast as FFT_MXU, by device name: the chip_smoke.py
# phase 10 sweep at batch 4 RGB 2160x3840 (PERF.md, "Routing sweeps"). NVIDIA
# H100 80GB HBM3 at 700 W, the radix-32 K3f against the split on the tensor
# cores: the uint8 split won at every swept radius, 5.3140 vs FFT_MXU 6.1319
# ms at r 1830 and 5.5449 vs 6.1203 at r 1920, the largest radius of a plan
# on 3840 columns (past it unmeasured); the float split on 3xTF32 tensor
# cores 2.3999 vs 3.0173 ms at r 119, 3.3431 vs 3.0985 at r 165.
_MEASURED_CROSSOVERS: dict[str, tuple[int, int]] = {
    "NVIDIA H100 80GB HBM3": (1920, 119),
}

# Largest swept box support radius at which a box on the fused engine is
# at least as fast as the box scan (K4), for uint8 (K1) and float (K2)
# alike (the smaller of the two), by device name: the chip_smoke.py phase
# 13 sweep at batch 4 RGB 2160x3840 (PERF.md, "Routing sweeps"), K1 on its
# AUTO rung and form. NVIDIA H100 80GB HBM3 at 700 W, K1 on the tensor
# cores: uint8 K1 0.8681 vs K4 1.8618 ms at support 32, 1.2383 vs 1.8037 at
# 82, 2.0107 vs 1.7546 at 164 (uint8 alone would take K1 to 82); float K2 on
# 3xTF32 tensor cores 1.1395 vs 1.4847 at 32, 4.1107 vs 1.5369 at 82.
_MEASURED_BOX_SCAN: dict[str, int] = {
    "NVIDIA H100 80GB HBM3": 32,
}

# Smallest swept support radius from which the two-pass split is faster
# than the single fused kernel at every swept radius, for float (and for
# uint8 where the device has no entry of its own below), by device name:
# the chip_smoke.py phase 13 sweep (r 2..332), K2 against the f32 split
# (PERF.md, "Routing sweeps"). NVIDIA H100 80GB HBM3 at 700 W, both on
# 3xTF32 tensor cores: K2 0.7417 vs the f32 split 0.7770 ms at r 15, 0.8987
# vs 0.8245 at r 19, 1.1495 vs 0.9986 at r 32, 1.8237 vs 1.2825 at r 49.
# Absent: the split runs past 600 only.
_MEASURED_SPLIT_MIN: dict[str, int] = {
    "NVIDIA H100 80GB HBM3": 19,
}

# The same for K1's uint8 path alone (the int8, hybrid and bf16 rungs),
# where it differs: the smallest swept support radius from which the int8
# split beats K1 (on AUTO's rung, in the form the card's rule picks) at
# every swept radius, for gaussian and box taps alike, by device name: the
# chip_smoke.py phase 13 uint8 sweep from r 1 (PERF.md, "Routing sweeps");
# MAX_RADIUS + 1 (601) where the split never wins under K1's domain. Absent:
# the uint8 path splits where the float path does. NVIDIA H100 80GB HBM3 at
# 700 W, K1 on the tensor cores: gaussian K1 (hybrid) 0.4382 vs the split
# 0.6438 ms at r 32, 0.6675 vs 0.7441 at r 65, 0.8093 vs 0.7791 at r 82,
# 1.5859 vs 0.9543 at r 165; box taps alike (support 66: 0.6674 vs 0.7440,
# 82: 0.8097 vs 0.7740).
_MEASURED_SPLIT_MIN_U8: dict[str, int] = {
    "NVIDIA H100 80GB HBM3": 82,
}

# The certified precision ladder, by device name: the DeviceSpec fields of
# the same names, from ``python -m blur_algorithms_tpu_torch.certify``
# (PERF.md, "Certification of the precision ladder"). Absent: every floor
# None, AUTO runs int8.
# NVIDIA H100 80GB HBM3 at 700 W, K1 on the tensor cores: hybrid max 1
# count at every gaussian radius 3..498 and box support 2..600; bf16 max 2
# at r 5 and 9 and box support 2, max 1 from r 12 and support 4; the
# split's hybrid pass 2 max 1 at column radius 1..4094 (gaussian) and
# support 2..1022 (box). In turns on 4 RGB 4K frames, K1 direct: hybrid
# faster than int8 at every radius under the uint8 split radius (0.3297 vs
# 0.3686 ms at r 6, 0.4412 vs 0.5192 at r 32, 0.6662 vs 0.6999 at r 64;
# past it, where AUTO runs the split, 1.1212 vs 1.0450 at r 104 and 31.58
# vs 20.30 at r 597), bf16 slower at every one (1.41 ms at r 32), the
# hybrid pass 2 faster than the int8 one (1.40 vs 2.29 ms at r 831). The
# split's pass 2 sweep starts under the hybrid floors (column radius 1, box
# support 2): the split runs from r 82 here, and at any column radius on an
# anisotropic plan.
_MEASURED_PRECISION: dict[str, dict[str, int | None]] = {
    "NVIDIA H100 80GB HBM3": {
        "hybrid_cert_min_radius": 3,
        "hybrid_cert_min_radius_box": 2,
        "hybrid_route_min_radius": 0,
        "bf16_cert_min_radius": 12,
        "bf16_route_min_radius": None,
        "hybrid_split_cert_max_radius": 4094,
        "hybrid_split_cert_max_radius_box": 1022,
    },
}

# Device memory bandwidth in GB/s, by device name (NVIDIA's data sheet):
# what ``auto_sp_min_px`` scales by.
_HBM_GBPS: dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}

# The pixel floor of AUTO's row sharding on a device of ``hbm_gbps`` GB/s:
# the JAX ``DeviceSpec.auto_sp_min_px`` formula (2^24 pixels at 819 GB/s,
# scaled by the bandwidth, at least 2^22). Not measured: where row sharding
# pays depends on the copies between distinct cards, and the port has been
# measured on one card only.
_SP_MIN_PX_BASE = 1 << 24


def _auto_sp_min_px(hbm_gbps: float | None) -> int:
    """AUTO's row-sharding pixel floor for a device of ``hbm_gbps`` GB/s
    (None: the formula's base)."""
    if hbm_gbps is None:
        return _SP_MIN_PX_BASE
    return max(1 << 22, round(_SP_MIN_PX_BASE * hbm_gbps / 819.0))


# Where K1's other staging forms beat its direct form, by device name: the
# DeviceSpec field ``k1_forms`` (see ``DeviceSpec.k1_form``), from the
# chip_smoke.py phase 15 sweep in turns on 3, 6 and 12 planes of 2160x3840,
# support radius 6..598, hybrid and int8 (PERF.md, "K1's forms"). Per rung
# and plane count, each step names the form that measured fastest at that
# swept radius, where it differs from the step below; absent: K1 direct
# everywhere. The strip form K1s lost at every swept point and is never
# routed (``strip=True`` reaches it). NVIDIA H100 80GB HBM3 at 700 W, K1 on
# the tensor cores, 12 planes: hybrid direct 0.4453 vs resident 0.5206 ms
# at r 32, 0.7079 vs 0.6766 at r 65, 31.58 vs 11.41 at r 598. AUTO runs K1
# under the uint8 split radius (82) only; the forms past it serve the pins
# and K1's own callers.
_MEASURED_K1_FORM: dict[str, dict] = {
    "NVIDIA H100 80GB HBM3": {
        "k1_forms": (
            ("hybrid", 3, ((248, "assembled"), (332, "resident"))),
            ("hybrid", 6, ((65, "resident"), (99, "direct"), (248, "resident"))),
            ("hybrid", 12, ((65, "resident"),)),
            ("int8", 3, ((248, "assembled"), (448, "resident"))),
            ("int8", 6, ((248, "resident"),)),
            ("int8", 12, ((99, "resident"),)),
        ),
    },
}


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """A device's name and the properties the kernels size themselves by."""

    name: str
    sm_count: int  # 0 on the CPU
    smem_optin_bytes: int  # largest dynamic shared memory per block; 0 on the CPU
    # Whole-frame FFT_MXU intermediates (``ops.fft_mxu.estimate_bytes``)
    # past which the engine would have to strip-stream (not ported): 10/16
    # of the card's memory, as the JAX field of the same name.
    fft_mxu_byte_budget: int = CPU_FFT_MXU_BYTE_BUDGET
    # AUTO keeps the fused engine up to this support radius and runs
    # FFT_MXU past it (the JAX fields of the same meaning), for uint8 and
    # float inputs.
    auto_fused_max_radius_u8: int = 600
    auto_fused_max_radius_f32: int = 600
    # The certified precision ladder (the JAX DeviceSpec fields of the same
    # names). ``*_cert_min_radius``: smallest support radius from which the
    # rung holds the <=1-count oracle gate on this device, per tap family
    # (``_box``: box/tent taps, measured on their own); None = uncertified,
    # AUTO never routes it. ``*_route_min_radius``: smallest radius from
    # which the rung also beats int8 on time; 0 = at every radius, None =
    # at none (AUTO keeps int8). ``hybrid_split_cert_max_radius(_box)``:
    # largest radius at which the split's hybrid pass 2 is certified (and
    # not slower than its int8 pass 2); None = the split keeps its exact
    # int8 pass 2.
    hybrid_cert_min_radius: int | None = None
    hybrid_cert_min_radius_box: int | None = None
    hybrid_route_min_radius: int | None = 0
    bf16_cert_min_radius: int | None = None
    bf16_route_min_radius: int | None = 0
    hybrid_split_cert_max_radius: int | None = None
    hybrid_split_cert_max_radius_box: int | None = None
    # Box blur runs the fused engine up to this support radius and the box
    # scan (K4) past it, or wherever AUTO would pick an FFT engine (the JAX
    # field of the same name).
    box_scan_crossover_radius: int = 600
    # Peak bytes of the two-pass split (``fused_blur.split_hbm_bytes``)
    # past which it is not routed: 11/16 of the card's memory, as the JAX
    # field of the same name.
    split_hbm_budget: int = CPU_SPLIT_HBM_BUDGET
    # Support radius from which ``blur_fused`` prefers the two-pass split
    # to the single kernel; None = only past the single kernels' domain.
    fused_split_min_radius: int | None = None
    # The same for K1's uint8 path (``blur_fused_u8``'s int8, hybrid and
    # bf16 rungs, the int8 split against K1); None = fused_split_min_radius.
    fused_split_min_radius_u8: int | None = None
    # AUTO shards a single frame's rows over the devices (``parallel/``) only
    # from this many pixels, and a batch's rows over its spare devices
    # likewise (the JAX field of the same name).
    # Unmeasured: the H100's value (68,624,754 px) is the JAX formula at
    # 3.35 TB/s.
    auto_sp_min_px: int = _SP_MIN_PX_BASE
    # K1's staging forms (``cuda_kernels/fused_dma.py``) where they beat its
    # direct form: rows ``(rung, planes, ((from_radius, form), ...))``, read
    # by ``k1_form``; empty = K1 direct everywhere.
    k1_forms: tuple = ()

    @staticmethod
    def _floor(cert: int | None, route: int | None) -> int | None:
        if cert is None or route is None:
            return None
        return max(cert, route)

    @property
    def bf16_min_radius(self) -> int | None:
        """Routing boundary of the bf16 rung: accuracy and time floors."""
        return self._floor(self.bf16_cert_min_radius, self.bf16_route_min_radius)

    @property
    def hybrid_min_radius(self) -> int | None:
        return self._floor(self.hybrid_cert_min_radius, self.hybrid_route_min_radius)

    def hybrid_min_radius_for(self, kernel: str) -> int | None:
        """Per-tap-family hybrid floor: box/tent taps use their own measured
        certification floor, not the gaussian sweep's."""
        base = self.hybrid_min_radius
        if base is None:
            return None
        if kernel == "box_fast":
            if self.hybrid_cert_min_radius_box is None:
                return None
            return max(base, self.hybrid_cert_min_radius_box)
        return base

    def hybrid_split_cert_max_radius_for(self, kernel: str) -> int | None:
        """Per-tap-family ceiling of the split's hybrid pass 2."""
        if kernel == "box_fast":
            return self.hybrid_split_cert_max_radius_box
        return self.hybrid_split_cert_max_radius

    def k1_form(self, rung: str, planes: int, radius: int) -> str:
        """The form K1 runs on ``rung`` for ``planes`` planes at support
        ``radius``: the step of the largest measured plane count not above
        ``planes`` and, in it, of the largest swept radius not above
        ``radius``; "direct" below the smallest of either, or without a row."""
        form, best = "direct", 0
        for row_rung, row_planes, steps in self.k1_forms:
            if row_rung != rung or not best <= row_planes <= planes:
                continue
            best, form = row_planes, "direct"
            for from_radius, step in steps:
                if from_radius <= radius:
                    form = step
        return form


def spec_for(name: str, sm_count: int, smem_optin_bytes: int,
             total_memory: int) -> DeviceSpec:
    """The spec of a CUDA device of this name and memory, with the routing
    radii measured for that name (or the unmeasured defaults)."""
    u8, f32 = _MEASURED_CROSSOVERS.get(name, (600, 600))
    return DeviceSpec(
        name=name,
        sm_count=sm_count,
        smem_optin_bytes=smem_optin_bytes,
        fft_mxu_byte_budget=total_memory * 10 // 16,
        auto_fused_max_radius_u8=u8,
        auto_fused_max_radius_f32=f32,
        box_scan_crossover_radius=_MEASURED_BOX_SCAN.get(name, 600),
        split_hbm_budget=total_memory * 11 // 16,
        fused_split_min_radius=_MEASURED_SPLIT_MIN.get(name),
        fused_split_min_radius_u8=_MEASURED_SPLIT_MIN_U8.get(name),
        auto_sp_min_px=_auto_sp_min_px(_HBM_GBPS.get(name)),
        **_MEASURED_PRECISION.get(name, {}),
        **_MEASURED_K1_FORM.get(name, {}),
    )


@functools.lru_cache(maxsize=16)
def _cuda_spec(index: int) -> DeviceSpec:
    props = torch.cuda.get_device_properties(index)
    return spec_for(
        props.name, props.multi_processor_count,
        int(getattr(props, "shared_memory_per_block_optin", 0)),
        int(props.total_memory),
    )


def device_spec(device: torch.device | str) -> DeviceSpec:
    """The spec of ``device`` (a CUDA device, or the CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return DeviceSpec(name=device.type, sm_count=0, smem_optin_bytes=0)
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _cuda_spec(index)
