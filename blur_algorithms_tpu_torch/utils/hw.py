"""What the port knows of the device it runs on.

The JAX package keys routing budgets and certified precision rungs by TPU
kind (its ``utils/hw.py``). None of those numbers carries over: each was
measured on a TPU. The port reads the CUDA device's own properties, and
every certification rung stays ``None`` until an H100 run of the JAX
package's certification protocol (``benchmarks/default_prec_cert.py``)
measures one, so AUTO routes only the always-exact int8 rung.

AUTO's fused/FFT crossovers are per device name, from the interleaved
sweep of ``chip_smoke.py`` phase 10 (PERF.md); a device that was not
measured keeps the fused engine up to its whole domain (support radius
600) and runs FFT_MXU past it.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

__all__ = ["DeviceSpec", "device_spec"]

# Whole-frame FFT_MXU intermediates on the CPU: a fixed budget, since the
# host's free memory is no property of the tensor's device.
CPU_FFT_MXU_BYTE_BUDGET = 4 << 30

# Largest swept support radius at which the fused engine (K1 for uint8, K2
# for float) is still at least as fast as FFT_MXU, by device name: the
# chip_smoke.py phase 10 sweep at batch 4 RGB 2160x3840 (PERF.md,
# "Crossover"). NVIDIA H100 80GB HBM3 at 700 W: uint8 K1 7.28 vs FFT_MXU
# 8.43 ms at r 165, 17.97 vs 8.42 at r 332; float K2 4.03 vs 6.14 ms at
# r 82, 7.93 vs 6.14 at r 119.
_MEASURED_CROSSOVERS: dict[str, tuple[int, int]] = {
    "NVIDIA H100 80GB HBM3": (165, 82),
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


@functools.lru_cache(maxsize=16)
def _cuda_spec(index: int) -> DeviceSpec:
    props = torch.cuda.get_device_properties(index)
    u8, f32 = _MEASURED_CROSSOVERS.get(props.name, (600, 600))
    return DeviceSpec(
        name=props.name,
        sm_count=props.multi_processor_count,
        smem_optin_bytes=int(getattr(props, "shared_memory_per_block_optin", 0)),
        fft_mxu_byte_budget=int(props.total_memory) * 10 // 16,
        auto_fused_max_radius_u8=u8,
        auto_fused_max_radius_f32=f32,
    )


def device_spec(device: torch.device | str) -> DeviceSpec:
    """The spec of ``device`` (a CUDA device, or the CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return DeviceSpec(name=device.type, sm_count=0, smem_optin_bytes=0)
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _cuda_spec(index)
