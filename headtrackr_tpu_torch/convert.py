"""Tracker state across the two packages.

The reference package's ``TrackerState`` pytree (with the band audit and
sparse model off) flattens with ``jax.tree_util.tree_leaves`` to the same
leaves, in the same order, as this package's ``TrackerState`` flattens field
by field.  Leaves travel as NumPy arrays, so neither side imports the other.
"""

import numpy as np
import torch

from .models.camshift import CamshiftState
from .models.facetracker import TrackerState

__all__ = ["state_from_numpy", "state_to_numpy", "N_LEAVES"]

_CS_AT = TrackerState._fields.index("cs")
N_LEAVES = len(TrackerState._fields) - 1 + len(CamshiftState._fields)


def state_from_numpy(leaves, device="cpu"):
    """Flat leaves (NumPy arrays, reference pytree order) -> TrackerState."""
    leaves = list(leaves)
    if len(leaves) != N_LEAVES:
        raise ValueError(f"expected {N_LEAVES} leaves, got {len(leaves)}")
    t = [torch.tensor(np.asarray(a), device=device) for a in leaves]
    n_cs = len(CamshiftState._fields)
    cs = CamshiftState(*t[_CS_AT:_CS_AT + n_cs])
    return TrackerState(*t[:_CS_AT], cs, *t[_CS_AT + n_cs:])


def state_to_numpy(state):
    """TrackerState -> flat leaves (NumPy arrays, reference pytree order)."""
    out = []
    for v in state:
        for t in (v if isinstance(v, CamshiftState) else (v,)):
            out.append(t.detach().cpu().numpy())
    return out
