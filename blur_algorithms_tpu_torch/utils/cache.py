"""The kernel library on disk, ready before the first frame.

The counterpart of the JAX package's ``utils/cache.py``. There, what
persists across processes is XLA's compiled programs; here it is the
kernel library that ``utils/build.py`` compiles from ``csrc/*.cu`` with
``nvcc`` into ``build/`` at the repository root, keyed by a hash of the
sources and flags. A fresh process (a CLI run, a restarted server) loads
it in milliseconds when it is there and pays the build (about a minute)
only when it is not. ``enable_persistent_cache`` loads it, building it if
it is absent, so the CLI and the server have it before their first frame.

Opt-out with ``BLUR_TPU_NO_COMPILE_CACHE=1`` (the JAX package's variable):
then nothing is loaded ahead, and the first launch builds or loads the
library itself.
"""

from __future__ import annotations

import os

import torch

__all__ = ["enable_persistent_cache"]


def enable_persistent_cache(device: torch.device | str = "cuda") -> str | None:
    """Load the kernel library for ``device``, building it into ``build/``
    if it is absent; return that directory.

    Returns None without building on a CPU device (the plain versions need
    no library) and where the environment opts out. A build that fails
    raises: no path carries on without the kernels.
    """
    # affirmative opt-out only: =1/true disables, =0/"" does not
    if os.environ.get("BLUR_TPU_NO_COMPILE_CACHE", "").lower() not in (
        "", "0", "false",
    ):
        return None
    if torch.device(device).type != "cuda":
        return None
    from blur_algorithms_tpu_torch.utils import build

    build.load_library()
    return str(build.build_dir())
