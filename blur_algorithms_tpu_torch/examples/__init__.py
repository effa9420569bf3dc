"""Runnable examples of the port: ``python -m blur_algorithms_tpu_torch.examples.<name>``
(``serve``, ``sharpen``, ``deblur``, ``spectrum_sweep``, ``multichip``)."""
