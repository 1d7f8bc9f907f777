"""What the result may not have loaded: JAX, its libraries and the JAX
package, compared by the whole top-level name of each loaded module (the
port's name, multilevel_gnn_tpu_torch, begins with the JAX package's)."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "multilevel_gnn_tpu")


def forbidden_loaded(names: Iterable[str] = None) -> List[str]:
    """The loaded modules whose top-level name is a forbidden one."""
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
