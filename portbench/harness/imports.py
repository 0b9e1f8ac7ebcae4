"""The check that nothing of JAX ran in the measured process.

Names are compared by their top-level part (before the first dot), whole:
``canny_edge_tpu_torch`` (the port) begins with ``canny_edge_tpu`` (the JAX
package) and is not it.
"""

from __future__ import annotations

FOREIGN = frozenset({"jax", "jaxlib", "flax", "canny_edge_tpu"})


def foreign(module_names) -> list[str]:
    """The names among ``module_names`` whose top-level part is JAX's, its
    compiler's, Flax's or the JAX package's, sorted."""
    return sorted(n for n in module_names if n.split(".")[0] in FOREIGN)
