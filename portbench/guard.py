"""The import guard: the measured process may hold neither JAX nor the JAX
package. Modules are compared by their whole top-level name (the part before
the first dot), so ``blur_algorithms_tpu_torch``, the port, passes while
``blur_algorithms_tpu`` does not."""

from __future__ import annotations

__all__ = ["FORBIDDEN", "forbidden_modules"]

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "blur_algorithms_tpu"})


def forbidden_modules(modules) -> list[str]:
    """The loaded module names (keys of ``sys.modules``) whose top-level
    name is forbidden, sorted."""
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)
