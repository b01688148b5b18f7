"""The import rule: nothing the benchmark runs may load JAX or the JAX
package.  Modules are compared by their whole top-level name, the part
before the first dot, so the port (``qoaudio_tpu_torch``) never trips it."""

from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "qoaudio_tpu"})


def forbidden_modules(names: Optional[Iterable[str]] = None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: every module
    this process has loaded)."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".")[0] for n in names} & FORBIDDEN)
