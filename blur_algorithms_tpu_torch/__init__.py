"""blur_algorithms_tpu_torch — the PyTorch + CUDA port of blur_algorithms_tpu.

The JAX package ``blur_algorithms_tpu`` is the reference this port is held
against. The port goes one slice at a time (ROADMAP.md); it now serves
``blur_u8`` / ``gaussian_blur`` on uint8 ``(..., H, W, C)`` frames, ``blur``
on float planar ``(..., H, W)`` data (differentiable), ``convolve_separable``
and ``box_blur``, through the fused engine (with its two-pass split to
support radius 4096), the band, FFT, box-scan and cascade engines, and
``dft_spectrum``, the strip-streamed ``"fft_stream"`` engine and FFT_MXU past
its byte budget (``ops/streamed``), ``blur_multi_sigma(_u8)`` (a sigma sweep
in one call) and ``models.wiener_deconvolve``: hand-written Hopper kernels on
a CUDA tensor and their plain PyTorch versions on a CPU tensor. ``blur_algorithms_tpu_torch.parallel``
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
