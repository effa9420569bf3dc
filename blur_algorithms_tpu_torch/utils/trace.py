"""The port's spans and launch counters.

``span(name)`` marks a stretch of the port's host code. While a
``torch.profiler`` (or the autograd profiler) records, it is a
``torch.profiler.record_function``: the span lands in the profiler's trace,
on the clock of the CUDA kernels, copies and runtime launch calls, so the
device work a span launched and the idle time while the host was in it can
be read off that trace. While nothing records, it returns one shared
context that does nothing, after one read of the flag PyTorch's profilers
set (``torch.autograd.profiler._is_profiler_enabled``): no call into the
dispatcher (``record_function`` itself costs microseconds even with no
profiler) and no Python frame beyond ``span`` itself.

The spans:

- ``api.blur_u8`` and ``api.blur``: the whole call of the public entry;
- ``api.route``: its checks and routing (plan, engine, sharding, the fused
  engine's rung), everything before the first data is touched;
- ``layout.to_planar`` and ``layout.from_planar``: the layout moves
  (``ops/layout.py``): the launch of the port's kernel for a uint8 RGB
  move on the card (a ``launch.layout_*`` span inside), else the dispatch
  of PyTorch's copy;
- ``launch.<C entry>``: each launch of a kernel of the library: the
  wrapper's work on the CUDA path (checks, tap tables, the output's
  allocation) up to the return of the C entry.

``launched(fn, name, nbytes)`` counts one launch of the C entry ``name``:
on the wrapper's ``fn.launches`` and in ``counters()``, which also adds up
the bytes of the tensors each launch passes a pointer to (``nbytes``, each
tensor once). ``counters()`` covers every launch of the process since the
last ``reset_counters()``.
"""

from __future__ import annotations

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["counters", "launched", "nbytes", "reset_counters", "span"]


class _Off:
    """The span while no profiler records. ``with`` looks ``__enter__`` and
    ``__exit__`` up on the type and calls an attribute that is no descriptor
    without ``self``: ``"".format`` takes any arguments and returns "" (false,
    so no exception is suppressed) in C, where ``contextlib.nullcontext``
    would run two Python frames a span (measured: several microseconds a
    call on a busy host)."""

    __slots__ = ()
    __enter__ = __exit__ = "".format


_OFF = _Off()
_counters: dict[str, dict[str, int]] = {}


def span(name: str):
    """A ``record_function(name)`` while a profiler records, else a shared
    context that does nothing."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def nbytes(*tensors) -> int:
    """The bytes of ``tensors`` (None skipped), each counted once."""
    total = 0
    for t in tensors:
        if t is not None:
            total += t.nbytes
    return total


def launched(fn, name: str, nbytes: int, also: str | None = None) -> None:
    """Count one launch of the C entry ``name`` that passed ``nbytes`` of
    tensors: one more on ``fn.launches`` (and on ``fn.<also>``, a form's
    own count), one more launch and ``nbytes`` more bytes under ``name`` in
    ``counters()``."""
    fn.launches += 1
    if also is not None:
        setattr(fn, also, getattr(fn, also) + 1)
    entry = _counters.get(name)
    if entry is None:
        entry = _counters[name] = {"launches": 0, "bytes": 0}
    entry["launches"] += 1
    entry["bytes"] += nbytes


def counters() -> dict[str, dict[str, int]]:
    """A copy of the launch counts: C entry -> ``{"launches", "bytes"}``."""
    return {name: dict(entry) for name, entry in _counters.items()}


def reset_counters() -> None:
    """Forget every launch counted in ``counters()`` (the wrappers'
    ``.launches`` are left as they are)."""
    _counters.clear()
