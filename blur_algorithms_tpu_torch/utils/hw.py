"""What the port knows of the device it runs on.

The JAX package keys routing budgets and certified precision rungs by TPU
kind (its ``utils/hw.py``). None of those numbers carries over: each was
measured on a TPU. The port reads the CUDA device's own properties, and
every certification rung stays ``None`` until an H100 run of the JAX
package's certification protocol (``benchmarks/default_prec_cert.py``)
measures one, so AUTO routes only the always-exact int8 rung.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["DeviceSpec", "device_spec"]


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """A device's name and the properties the kernels size themselves by."""

    name: str
    sm_count: int  # 0 on the CPU
    smem_optin_bytes: int  # largest dynamic shared memory per block; 0 on the CPU
    # Certified precision rungs (the JAX DeviceSpec fields of the same
    # meaning): smallest support radius at which the hybrid / bf16 rung is
    # certified against the <=1-count oracle gate on this device. None =
    # uncertified -> AUTO never routes it.
    hybrid_cert_min_radius: int | None = None
    bf16_cert_min_radius: int | None = None


def device_spec(device: torch.device | str) -> DeviceSpec:
    """The spec of ``device`` (a CUDA device, or the CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return DeviceSpec(name=device.type, sm_count=0, smem_optin_bytes=0)
    props = torch.cuda.get_device_properties(device)
    return DeviceSpec(
        name=props.name,
        sm_count=props.multi_processor_count,
        smem_optin_bytes=int(getattr(props, "shared_memory_per_block_optin", 0)),
    )
