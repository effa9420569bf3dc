"""Multi-device scaling: device meshes, sharded blur with halo exchange.

The port of the JAX package's ``parallel/``: data parallelism over frames
(``dp``) and row sharding within a frame (``sp``) with reflect-aware halo
exchange, and the distributed FFT past the fused radius. One process runs
every shard's step over a mesh of ``torch.device``s (``mesh.py``), with the
JAX collectives written as explicit copies (``sharded.ppermute``,
``sharded.all_to_all``); a mesh may repeat a device.
"""

from blur_algorithms_tpu_torch.parallel.mesh import make_mesh
from blur_algorithms_tpu_torch.parallel.sharded import (
    blur_fft_sharded,
    blur_fft_sharded_u8,
    blur_sharded,
    blur_sharded_u8,
)

__all__ = [
    "make_mesh",
    "blur_sharded",
    "blur_sharded_u8",
    "blur_fft_sharded",
    "blur_fft_sharded_u8",
]
