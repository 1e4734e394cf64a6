"""The run must not load JAX or the JAX package: the names are compared
whole, by the part of each module name before its first dot (the port's
package name begins with the JAX package's)."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "hevc_tpu")


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def jax_modules(modules=None) -> list:
    """Sorted top-level names of loaded modules that are forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(n) for n in names
                   if top_level(n) in FORBIDDEN})
