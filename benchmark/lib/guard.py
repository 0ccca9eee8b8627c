"""The import guard: the benchmark measures the PyTorch port alone.

A module counts by its whole top-level name (the part before the first
dot): ``headtrackr_tpu_torch`` is the port, ``headtrackr_tpu`` the JAX
package it was ported from, though the one name begins with the other."""

import sys

__all__ = ["FORBIDDEN", "forbidden_loaded"]

FORBIDDEN = frozenset(("jax", "jaxlib", "flax", "headtrackr_tpu", "bench",
                       "bench_torch"))


def forbidden_loaded(names=None):
    """The sorted top-level names among ``names`` (default: the loaded
    modules) that are in FORBIDDEN."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & FORBIDDEN)
