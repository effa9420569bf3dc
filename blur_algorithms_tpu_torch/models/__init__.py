"""Configured blur pipelines (the JAX package's ``models``): ported so far,
``wiener_deconvolve``."""

from blur_algorithms_tpu_torch.models.deconvolve import wiener_deconvolve

__all__ = ["wiener_deconvolve"]
