"""What the port knows of the device it runs on.

The JAX package keys routing budgets and certified precision rungs by TPU
kind (its ``utils/hw.py``). None of those numbers carries over: each was
measured on a TPU. The port reads the CUDA device's own properties, and
every certification rung stays ``None`` until an H100 run of the JAX
package's certification protocol (``benchmarks/default_prec_cert.py``)
measures one, so AUTO routes only the always-exact int8 rung.

The routing radii are per device name, from the interleaved sweeps of
``chip_smoke.py`` (phase 10: fused against FFT_MXU; phase 13: box scan
against the fused engine, and the two-pass split against the single
kernel) recorded in PERF.md. A device that was not measured keeps the
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

# Largest swept support radius at which the fused engine (K1 for uint8, K2
# for float) is still at least as fast as FFT_MXU, by device name: the
# chip_smoke.py phase 10 sweep at batch 4 RGB 2160x3840 (PERF.md,
# "Crossover"). NVIDIA H100 80GB HBM3 at 700 W: uint8 K1 7.28 vs FFT_MXU
# 8.43 ms at r 165, 17.97 vs 8.42 at r 332; float K2 4.03 vs 6.14 ms at
# r 82, 7.93 vs 6.14 at r 119.
_MEASURED_CROSSOVERS: dict[str, tuple[int, int]] = {
    "NVIDIA H100 80GB HBM3": (165, 82),
}

# Largest swept box support radius at which a box on the fused engine is
# at least as fast as the box scan (K4), for uint8 (K1) and float (K2)
# alike, by device name: the chip_smoke.py phase 13 sweep at batch 4 RGB
# 2160x3840 (PERF.md, "Box sweep"). NVIDIA H100 80GB HBM3 at 700 W: uint8
# K1 1.90 vs K4 2.32 ms at support 32, 3.67 vs 2.39 at 82; float K2 1.27
# vs 1.94 at 32, 4.03 vs 2.06 at 82.
_MEASURED_BOX_SCAN: dict[str, int] = {
    "NVIDIA H100 80GB HBM3": 32,
}

# Smallest swept support radius from which the two-pass split is faster
# than the single fused kernel at every swept radius, for uint8 and float
# alike, by device name: the chip_smoke.py phase 13 sweep (PERF.md, "Split
# sweep"). NVIDIA H100 80GB HBM3 at 700 W, r 332: int8 split 8.97 vs K1
# 17.55 ms, f32 split 7.26 vs K2 35.45 ms. Absent: the split runs past 600
# only.
_MEASURED_SPLIT_MIN: dict[str, int] = {
    "NVIDIA H100 80GB HBM3": 332,
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
    # Certified precision rungs (the JAX DeviceSpec fields of the same
    # meaning): smallest support radius at which the hybrid / bf16 rung is
    # certified against the <=1-count oracle gate on this device. None =
    # uncertified -> AUTO never routes it.
    hybrid_cert_min_radius: int | None = None
    bf16_cert_min_radius: int | None = None
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
