"""blur_algorithms_tpu_torch — the PyTorch + CUDA port of blur_algorithms_tpu.

The JAX package ``blur_algorithms_tpu`` is the reference this port is held
against. The port goes one slice at a time (ROADMAP.md); it now serves the
main path: ``blur_u8`` / ``gaussian_blur`` with the AUTO or fused engine on
uint8 ``(..., H, W, C)`` tensors, through a hand-written Hopper kernel on a
CUDA tensor and its plain PyTorch version on a CPU tensor.
"""

from blur_algorithms_tpu_torch.api import Engine, blur_u8, gaussian_blur
from blur_algorithms_tpu_torch.ops.plan import BlurPlan, make_custom_plan, make_plan

__version__ = "0.1.0"

__all__ = [
    "BlurPlan",
    "Engine",
    "blur_u8",
    "gaussian_blur",
    "make_custom_plan",
    "make_plan",
    "__version__",
]
