"""Configured blur pipelines (the JAX package's ``models``)."""

from blur_algorithms_tpu_torch.models.channel_smooth import channel_smooth
from blur_algorithms_tpu_torch.models.deconvolve import wiener_deconvolve
from blur_algorithms_tpu_torch.models.filters import high_pass, unsharp_mask
from blur_algorithms_tpu_torch.models.pipeline import (
    BlurPipeline,
    FastBoxBlur,
    GaussianBlur,
    SpectrumAnalyzer,
)

__all__ = [
    "BlurPipeline",
    "GaussianBlur",
    "FastBoxBlur",
    "SpectrumAnalyzer",
    "channel_smooth",
    "wiener_deconvolve",
    "unsharp_mask",
    "high_pass",
]
