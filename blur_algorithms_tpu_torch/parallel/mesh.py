"""Device meshes of the sharded path: a ``(dp, sp)`` grid of torch devices.

The JAX package builds a ``jax.sharding.Mesh`` and runs ``shard_map`` over
it in one process. The port keeps that single-controller design: a
``Mesh`` is a grid of ``torch.device``s, and ``parallel/sharded.py`` runs
each shard's step in turn with explicit copies between them. Entries may
repeat (``[cuda:0] * 4``): such virtual devices run every shard's step, the
halo exchange and the gathers on one card, as the JAX tests run on 8
virtual host devices.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["Mesh", "make_mesh", "visible_devices"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(dp, sp)`` grid of devices: frames over ``dp``, image rows over
    ``sp`` (the JAX mesh's axis names)."""

    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict[str, int]:
        return {"dp": len(self.devices), "sp": len(self.devices[0])}


def visible_devices(device: torch.device | str) -> list[torch.device]:
    """The devices AUTO may shard a tensor on ``device`` over: every visible
    CUDA card once for a CUDA tensor, the CPU alone for a CPU tensor (so
    AUTO on the CPU and on one card never shards, as JAX with one
    device)."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(device.type)]


def make_mesh(dp: int | None = None, sp: int = 1, devices: list | None = None) -> Mesh:
    """Build a ``(dp, sp)`` mesh: frames over ``dp``, image rows over ``sp``.

    With ``dp=None`` all remaining devices go to ``dp``. ``devices=None``
    means every CUDA device once; with none visible it raises (there is no
    fallback to the CPU). Repeated entries are virtual devices; all must be
    of one type."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("make_mesh(devices=None) needs a CUDA device; none is "
                               "visible (pass devices= for a CPU mesh)")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if n == 0:
        raise ValueError("a mesh needs at least one device")
    if dp is None:
        if n % sp:
            raise ValueError(f"{n} devices not divisible by sp={sp}")
        dp = n // sp
    if dp * sp != n:
        raise ValueError(f"dp*sp = {dp}*{sp} != {n} devices")
    if len({d.type for d in devices}) > 1:
        raise ValueError(f"the mesh's devices must be of one type, got "
                         f"{sorted({d.type for d in devices})}")
    return Mesh(tuple(tuple(devices[i * sp:(i + 1) * sp]) for i in range(dp)))
