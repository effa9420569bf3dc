"""What the three probes share: the device a run takes, the check of a
launch's return code, and their JSON lines."""

from __future__ import annotations

import argparse
import json

import torch


def device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default: the kernels) or cpu (the plain versions)")


def device_of(name: str) -> torch.device:
    """The run's device; a CUDA run with no card raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the probes run on a CUDA card (none is available); "
                           "--device cpu runs the plain versions")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"the probes run on cuda or cpu, not {device}")
    return device


def check_launch(rc: int, what: str) -> None:
    """Raise on a C entry's nonzero cudaError_t."""
    if rc:
        from blur_algorithms_tpu_torch.utils.build import load_library

        msg = load_library().blur_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)
