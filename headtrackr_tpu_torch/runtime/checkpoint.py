"""Checkpoint / resume for tracker state (the port of
headtrackr_tpu/runtime/checkpoint.py; files move between the two packages).

The reference has no checkpointing -- all state lives in JS closures
(SURVEY §5).  Here per-stream state is an explicit tree of tensors, so
serving state (N streams mid-track: mode, model histograms, search windows,
smoother, FOV caches) round-trips through a flat .npz and a BatchedTracker
can be stopped and resumed without re-detection.

Format (v2): leaves are keyed by their TrackerState field paths
(``state/cs/model_hist`` ...), alongside a format version and shape metadata,
and loading validates paths/shapes/dtypes against the target -- a checkpoint
from a different n_streams, frame geometry, or state schema fails loudly
instead of silently unflattening mismatched leaves.  v1 positional ``leaf_i``
checkpoints are still readable (structure validated by leaf count only).
The state schema does not depend on placement, so a file saved from a
tracker on a mesh of any size (or none) loads into a tracker on another.
"""

import numpy as np
import torch

from ..models import facetracker as ft
from .host import HostCopy

__all__ = ["save_state", "load_state", "save_tracker", "load_tracker"]

FORMAT_VERSION = 2

# Leaves addable without breaking old checkpoints: absent paths default to
# zeros of the template leaf (state/pend_age is ephemeral scheduler state --
# a resumed tracker just restarts its wait counters).
_OPTIONAL_PATHS = {"state/pend_age", "state/cs/band_dirty"}
# The reference's sparse-model leaves (a tracker with sparseHist=K): the
# port carries no sparse model, so they are dropped on load.  The same
# file's dense model_hist gives the reference's results (its sparse path is
# value-identical, and an overflowed sparse model is served full-frame).
_SPARSE_PATHS = {"state/cs/model_bins", "state/cs/model_counts",
                 "state/cs/model_overflow"}
# Non-zero defaults for absent optional leaves.  band_dirty defaults DIRTY
# (true): a pre-audit checkpoint resumed into an audited bandHist config was
# never content-audited, so its streams are conservatively served by the
# reference-exact full-frame fallback until their next relock re-audits.
_OPTIONAL_DEFAULTS = {"state/cs/band_dirty": 1}


def _keyed_leaves(state, prefix="state"):
    """[(path_string, leaf)] in tree order (None leaves skipped)."""
    out = []
    for name, v in zip(state._fields, state):
        path = f"{prefix}/{name}"
        if isinstance(v, tuple):
            out += _keyed_leaves(v, path)
        elif v is not None:
            out.append((path, v))
    return out


def _unflatten(like, leaves):
    """``like``'s tree with its leaves taken in order from the iterator."""
    return type(like)(*(
        _unflatten(v, leaves) if isinstance(v, tuple)
        else None if v is None else next(leaves) for v in like))


def _np_dtype(t):
    return torch.empty((), dtype=t.dtype).numpy().dtype


def _save(path, state, extra):
    keyed = _keyed_leaves(state)
    names = [k for k, _ in keyed]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate leaf paths in {names}")
    arrays = HostCopy([v for _, v in keyed]).arrays()
    np.savez_compressed(
        path, __format__=np.int32(FORMAT_VERSION),
        __paths__=np.asarray(names),
        **dict(zip(names, arrays)), **extra)


def _load(path, like):
    """(state shaped like ``like`` on its device, metadata arrays)."""
    want = _keyed_leaves(like)
    with np.load(path) as d:
        files = set(d.files)
        meta = {k: d[k] for k in ("n_streams", "frame_shape", "host_modes")
                if k in files}
        if "__format__" not in files:  # v1 positional fallback
            n = int(d["n_leaves"])
            if len(want) != n:
                raise ValueError(
                    f"v1 checkpoint has {n} leaves, target state has "
                    f"{len(want)} — incompatible schema")
            leaves = [d[f"leaf_{i}"] for i in range(n)]
        else:
            have = set(np.asarray(d["__paths__"]).tolist())
            missing = [k for k, _ in want
                       if k not in have and k not in _OPTIONAL_PATHS]
            extra = have - {k for k, _ in want} - _SPARSE_PATHS
            if missing or extra:
                raise ValueError(
                    f"checkpoint schema mismatch: missing {missing}, "
                    f"unknown {sorted(extra)}")
            leaves = []
            for k, tmpl in want:
                tshape = tuple(tmpl.shape)
                tdtype = _np_dtype(tmpl)
                if k not in have:  # optional leaf absent in an older file
                    leaves.append(np.full(tshape, _OPTIONAL_DEFAULTS.get(k, 0),
                                          tdtype))
                    continue
                v = d[k]
                if tuple(v.shape) != tshape:
                    raise ValueError(
                        f"checkpoint leaf {k!r} has shape {tuple(v.shape)}, "
                        f"target expects {tshape} (different n_streams or "
                        f"frame geometry?)")
                if v.dtype != tdtype:
                    raise ValueError(
                        f"checkpoint leaf {k!r} has dtype {v.dtype}, "
                        f"target expects {tdtype}")
                leaves.append(v)
    tensors = (torch.as_tensor(np.asarray(v)).to(t.device)
               for v, (_, t) in zip(leaves, want))
    return _unflatten(like, tensors), meta


def save_state(path, state):
    """Write a TrackerState (a batch of N streams) to ``path`` (.npz)."""
    _save(path, state, {})


def load_state(path, like=None, device=None):
    """Load a TrackerState from ``path``.  ``like``: template state providing
    the tree structure AND the expected leaf shapes/dtypes/device (defaults
    to a fresh single-stream state on ``device``, see
    device.resolve_device)."""
    if like is None:
        like = ft.init_state(1, device=device)
    state, _ = _load(path, like)
    return state


def save_tracker(path, bt):
    """Checkpoint a BatchedTracker's streams (state + host mode mirror)."""
    modes = bt.modes  # drains the pending mode read
    _save(path, bt.state, dict(host_modes=modes,
                               n_streams=np.int32(bt.n),
                               frame_shape=np.asarray(bt.frame_shape)))


def load_tracker(path, bt):
    """Restore a checkpoint into an existing BatchedTracker (same n_streams
    and frame shape -- validated) through its state-write path
    (``BatchedTracker.set_state``: a captured CUDA graph takes the new
    state into its buffers at its next replay), with the host mode view.
    ``set_state`` re-applies the target's placement, as the reference's
    load does: a tracker on a mesh splits the state over its shards, each
    slice on its shard's device; a meshless one keeps it on its device."""
    state, meta = _load(path, bt.state)
    if "n_streams" in meta and int(meta["n_streams"]) != bt.n:
        raise ValueError(f"checkpoint has {int(meta['n_streams'])} streams, "
                         f"tracker has {bt.n}")
    if ("frame_shape" in meta
            and tuple(meta["frame_shape"]) != tuple(bt.frame_shape)):
        raise ValueError(
            f"checkpoint frame shape {tuple(meta['frame_shape'])} != "
            f"tracker {tuple(bt.frame_shape)}")
    bt.set_state(state, meta.get("host_modes"))
    return bt
