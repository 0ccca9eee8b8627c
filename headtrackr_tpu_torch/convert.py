"""Tracker state across the two packages.

The reference package's ``TrackerState`` pytree (sparse model off) flattens
with ``jax.tree_util.tree_leaves`` to the same leaves, in the same order, as
this package's ``TrackerState`` flattens field by field: the optional
``band_dirty`` leaf (bandHist audit on) is the last leaf of the camshift
state in both, and absent in both when the audit is off.  Leaves travel as
NumPy arrays, so neither side imports the other.
"""

import numpy as np
import torch

from .device import resolve_device
from .models.camshift import CamshiftState
from .models.facetracker import TrackerState

__all__ = ["state_from_numpy", "state_to_numpy", "n_leaves", "N_LEAVES"]

_CS_AT = TrackerState._fields.index("cs")


def n_leaves(band_audit=False):
    """Leaf count of a state with or without the ``band_dirty`` leaf."""
    n_cs = len(CamshiftState._fields) - (0 if band_audit else 1)
    return len(TrackerState._fields) - 1 + n_cs


N_LEAVES = n_leaves()


def state_from_numpy(leaves, device=None):
    """Flat leaves (NumPy arrays, reference pytree order) -> TrackerState on
    ``device`` (default: the card; see device.resolve_device).  Whether the
    leaves carry ``band_dirty`` follows from their count."""
    leaves = list(leaves)
    band_audit = len(leaves) == n_leaves(True)
    if len(leaves) != n_leaves(band_audit):
        raise ValueError(f"expected {n_leaves(False)} or {n_leaves(True)} "
                         f"leaves, got {len(leaves)}")
    dev = resolve_device(device)
    t = [torch.tensor(np.asarray(a), device=dev) for a in leaves]
    n_cs = len(CamshiftState._fields) - (0 if band_audit else 1)
    cs = CamshiftState(*t[_CS_AT:_CS_AT + n_cs])
    return TrackerState(*t[:_CS_AT], cs, *t[_CS_AT + n_cs:])


def state_to_numpy(state):
    """TrackerState -> flat leaves (NumPy arrays, reference pytree order)."""
    out = []
    for v in state:
        for t in (v if isinstance(v, CamshiftState) else (v,)):
            if t is not None:
                out.append(t.detach().cpu().numpy())
    return out
