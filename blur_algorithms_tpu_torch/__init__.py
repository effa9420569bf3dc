"""blur_algorithms_tpu_torch — the PyTorch + CUDA port of blur_algorithms_tpu.

The JAX package ``blur_algorithms_tpu`` is the reference this port is held
against, module for module. It serves ``blur_u8`` / ``gaussian_blur`` on
uint8 ``(..., H, W, C)`` frames, ``blur`` on float planar ``(..., H, W)``
data (differentiable), ``convolve_separable`` and ``box_blur``, through
every engine of the JAX package (fused, with its two-pass split to support
radius 4096; band, conv, the FFT engines, box scan, cascade and the
Deriche recursive Gaussian), ``dft_spectrum``, ``blur_multi_sigma(_u8)``,
and the ``models`` (``BlurPipeline`` with its streaming ``stream``,
``GaussianBlur``, ``FastBoxBlur``, ``SpectrumAnalyzer``,
``channel_smooth``, ``unsharp_mask``, ``high_pass``,
``wiener_deconvolve``): hand-written Hopper kernels on a CUDA tensor and
their plain PyTorch versions on a CPU tensor. ``python -m
blur_algorithms_tpu_torch`` is the CLI (``cli.py``), and
``blur_algorithms_tpu_torch.examples.serve`` the HTTP service; both run on
the card unless ``--device cpu`` is given. ``blur_algorithms_tpu_torch.parallel``
(imported on its own, as in the JAX package) shards frames and rows over a
mesh of devices.
"""

from blur_algorithms_tpu_torch.api import (
    Engine,
    blur,
    blur_u8,
    box_blur,
    convolve_separable,
    dft_spectrum,
    gaussian_blur,
)
from blur_algorithms_tpu_torch.ops.multi_sigma import blur_multi_sigma, blur_multi_sigma_u8
from blur_algorithms_tpu_torch.ops.plan import BlurPlan, make_custom_plan, make_plan

__version__ = "0.1.0"

__all__ = [
    "BlurPlan",
    "Engine",
    "blur",
    "blur_multi_sigma",
    "blur_multi_sigma_u8",
    "blur_u8",
    "box_blur",
    "convolve_separable",
    "dft_spectrum",
    "gaussian_blur",
    "make_custom_plan",
    "make_plan",
    "__version__",
]
