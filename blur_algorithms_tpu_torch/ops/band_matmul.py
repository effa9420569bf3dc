"""Banded block matrices (host side, NumPy).

Only ``band_block_matrix`` is ported: the fused kernel's int8 operands are
quantised from it (``cuda_kernels.fused_dma.int8_operands``). The banded
matmul engine itself (``band`` in the JAX package) is not part of the port
yet.
"""

from __future__ import annotations

import numpy as np

__all__ = ["band_block_matrix"]


def band_block_matrix(taps: np.ndarray, block: int) -> np.ndarray:
    """Banded block matrix ``B[(block + 2r) x block]``: ``B[k, j] = taps[k - j]``.

    ``window @ B`` convolves every length-``block + 2r`` input window down to
    ``block`` outputs ("valid" convolution with correlation orientation —
    symmetric taps make conv == corr; taps from the kernel factory are
    symmetric by construction).
    """
    width = int(taps.shape[0])
    r = (width - 1) // 2
    rows = block + 2 * r
    mat = np.zeros((rows, block), dtype=np.float32)
    for j in range(block):
        mat[j : j + width, j] = taps
    return mat
