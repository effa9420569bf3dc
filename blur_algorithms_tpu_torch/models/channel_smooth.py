"""Per-channel smoothing recipes — the reference's colour-cleanup workflow.

The port of the JAX package's ``models/channel_smooth.py``. The
reference's evaluation corpora compare recipes that smooth each channel of
a Lab / YCrCb image with its own sigma ("Smooth 5-5-7", "9-9-9",
"1-11-11"). ``channel_smooth`` converts, blurs channel c with sigma[c]
through the engine AUTO (or the named engine) routes for that channel
(``api._route``, ``api._blur_planar``), rounds once, and converts back. The
colour conversion stays on the host with OpenCV, imported only for ``lab``
and ``ycrcb``: where OpenCV is absent those raise ``ImportError``, and
``rgb`` runs everywhere.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from blur_algorithms_tpu_torch import api
from blur_algorithms_tpu_torch.api import Engine
from blur_algorithms_tpu_torch.ops.layout import round_to_u8
from blur_algorithms_tpu_torch.ops.plan import make_plan
from blur_algorithms_tpu_torch.utils.hw import entry_device

__all__ = ["channel_smooth"]

_CSPACES = ("rgb", "lab", "ycrcb")


@functools.lru_cache(maxsize=64)
def _recipe(h: int, w: int, sigmas: tuple, engine: Engine, size_mode: str,
            device: torch.device) -> tuple:
    """Per channel: (plan, engine) for a sigma > 0, else None."""
    plans = []
    for sigma in sigmas:
        if sigma > 0:
            plan = make_plan((h, w), sigma, size_mode=size_mode)
            plans.append((plan, api._route(engine, plan, 4, device, 1)))
        else:
            plans.append(None)
    return tuple(plans)


def channel_smooth(
    img_u8: np.ndarray,
    sigmas,
    colorspace: str = "rgb",
    engine: Engine | str = Engine.AUTO,
    size_mode: str = "auto",
    device: torch.device | str = "cuda",
) -> np.ndarray:
    """Blur each channel with its own sigma, optionally in Lab/YCrCb.

    ``img_u8``: (H, W, 3) uint8 RGB. ``sigmas``: one per channel; 0 or None
    leaves a channel untouched. ``device`` (default the card; with no card
    it raises ``RuntimeError`` unless ``"cpu"`` is asked for) runs the
    blurs. Returns uint8 RGB as a NumPy array.
    """
    img_u8 = np.asarray(img_u8)
    if img_u8.dtype != np.uint8 or img_u8.ndim != 3 or img_u8.shape[-1] != 3:
        raise ValueError("channel_smooth expects (H, W, 3) uint8 RGB")
    if colorspace not in _CSPACES:
        raise ValueError(f"colorspace must be one of {_CSPACES}")
    sigmas = tuple(float(s) if s else 0.0 for s in sigmas)
    if len(sigmas) != 3:
        raise ValueError("need exactly 3 sigmas")
    dev = entry_device(device)

    if colorspace == "rgb":
        work = img_u8
    else:
        import cv2

        code = cv2.COLOR_RGB2Lab if colorspace == "lab" else cv2.COLOR_RGB2YCrCb
        work = cv2.cvtColor(img_u8, code)

    h, w = work.shape[:2]
    plans = _recipe(h, w, sigmas, Engine(engine), size_mode, dev)
    planes = torch.from_numpy(np.ascontiguousarray(np.moveaxis(work, -1, 0))).to(dev)
    planes = planes.to(torch.float32)
    out = []
    for c, pe in enumerate(plans):
        plane = planes[c]
        out.append(plane if pe is None else api._blur_planar(plane, *pe))
    # round on the device so only uint8 crosses back to the host
    out_u8 = np.moveaxis(round_to_u8(torch.stack(out)).cpu().numpy(), 0, -1)
    if colorspace == "rgb":
        return np.ascontiguousarray(out_u8)
    import cv2

    code = cv2.COLOR_Lab2RGB if colorspace == "lab" else cv2.COLOR_YCrCb2RGB
    return cv2.cvtColor(np.ascontiguousarray(out_u8), code)
