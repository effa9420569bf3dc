"""What the probes that time a kernel against an earlier version of its
source share: the earlier source built into a library of its own, and
timing in turns.

``library`` compiles one ``.cu`` (e.g. the parent commit's, unpacked into
``build/`` with ``git show`` or ``git archive``) with the package's nvcc
flags into ``build/probe/<name>.so``; the caller declares the entries it
calls. ``in_turns`` times each function in the order given, then in the
reverse order, and reports the mean of its two medians of CUDA-event
timings, so that a drift of the card's clocks falls on both alike.
``ptxas`` picks one kernel's register and spill lines out of a build's log.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess

import numpy as np

from blur_algorithms_tpu_torch.utils import build, timing

ITERS = 20


def library(src: pathlib.Path, name: str) -> tuple[ctypes.CDLL, str]:
    """``src`` built on its own into ``build/probe/<name>.so``: the loaded
    library and what nvcc and ptxas printed."""
    out_dir = build.build_dir() / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{name}.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(path), str(src)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{done.stdout}{done.stderr}")
    return ctypes.CDLL(str(path)), done.stdout + done.stderr


def in_turns(label: str, fns: dict, iters: int = ITERS) -> dict:
    """``{key: ms}``: each function of ``fns`` timed in turns (in order,
    then reversed), the mean of its two medians over ``iters`` calls."""
    t = {k: [] for k in fns}
    for k in (*fns, *reversed(fns)):
        t[k].append(timing.time_cuda(fns[k], iters=iters, name=f"{label} {k}").median_ms)
    return {k: float(np.mean(v)) for k, v in t.items()}


def ptxas(log: str, name: str) -> list[str]:
    """``Compiling entry function`` lines of ``name`` with their register /
    spill lines, from a build's ``-Xptxas -v`` output."""
    out, on = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            on = name in ln
            if on:
                out.append(ln.split("'")[1] if "'" in ln else ln)
        elif on and ("Used" in ln or "spill" in ln):
            out[-1] += " | " + ln.replace("ptxas info    :", "").strip()
    return out
