"""Cascade model container, the bundled frontal-face model, and the toy model.

The model data is the reference package's (``headtrackr_tpu/data/
frontalface.npz``: 16 stages, 2,015 weak classifiers, 24x24 window), read by
path so that this package never imports the JAX one.  A weak classifier k
votes ``alpha[k, 1]`` iff min(valid positive pixels) > max(valid negative
pixels), else ``alpha[k, 0]``; a stage rejects a window when its vote sum is
below ``stage_thresh``.  Feature-pixel slot f of weak k is valid iff
``pz[k, f] >= 0`` (resp. nz).
"""

import dataclasses
import functools
import os

import numpy as np
import torch

from .device import resolve_device

__all__ = ["Cascade", "frontalface", "toy_cascade", "cascade_to_torch",
           "DATA_DIR", "ARRAY_FIELDS"]

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "headtrackr_tpu", "data")
MAX_SIZE = 5
ARRAY_FIELDS = ("stage_counts", "stage_thresh", "alpha", "size",
                "px", "py", "pz", "nx", "ny", "nz", "stage_of")


@dataclasses.dataclass(frozen=True)
class Cascade:
    """Padded cascade model data (NumPy arrays)."""
    count: int                # number of stages
    width: int                # detection window width (full-plane px)
    height: int               # detection window height
    stage_counts: np.ndarray  # (S,) i32
    stage_thresh: np.ndarray  # (S,) f32
    alpha: np.ndarray         # (K, 2) f32 [fail, pass] votes
    size: np.ndarray          # (K,) i32
    px: np.ndarray            # (K, 5) i16, -1 pad
    py: np.ndarray
    pz: np.ndarray
    nx: np.ndarray
    ny: np.ndarray
    nz: np.ndarray
    stage_of: np.ndarray      # (K,) i32

    @property
    def n_weak(self):
        return self.alpha.shape[0]

    def __getitem__(self, key):  # dict-style access for the oracle
        return getattr(self, key)

    def stage_slice(self, s):
        """Stage s's weak classifiers as the range [k0, k1) of K."""
        k0 = int(self.stage_counts[:s].sum())
        return k0, k0 + int(self.stage_counts[s])


@functools.lru_cache(maxsize=1)
def frontalface():
    """The bundled frontal-face model (reference parity target)."""
    with np.load(os.path.join(DATA_DIR, "frontalface.npz")) as d:
        return Cascade(count=int(d["count"]), width=int(d["width"]),
                       height=int(d["height"]),
                       **{k: d[k] for k in ARRAY_FIELDS})


def toy_cascade(threshold=0.5):
    """A tiny 1-stage cascade that fires on windows whose center (quarter-plane
    pixels (2,2)..(3,3)) is strictly brighter than the window corners.

    Drives the WB->VJ->CS machine on synthetic clips with a bright square."""
    K = 1
    px, py, pz, nx, ny, nz = (np.full((K, MAX_SIZE), -1, np.int16)
                              for _ in range(6))
    for i, (x, y) in enumerate([(2, 2), (3, 2), (2, 3), (3, 3)]):
        px[0, i], py[0, i], pz[0, i] = x, y, 2
    for i, (x, y) in enumerate([(0, 0), (5, 0), (0, 5), (5, 5)]):
        nx[0, i], ny[0, i], nz[0, i] = x, y, 2
    return Cascade(
        count=1, width=24, height=24,
        stage_counts=np.array([1], np.int32),
        stage_thresh=np.array([threshold], np.float32),
        alpha=np.array([[-1.0, 1.0]], np.float32),
        size=np.array([4], np.int32),
        px=px, py=py, pz=pz, nx=nx, ny=ny, nz=nz,
        stage_of=np.zeros((1,), np.int32),
    )


def cascade_to_torch(arrays, device=None):
    """Model arrays (a ``Cascade`` of either package, or a dict of NumPy
    arrays with the ``ARRAY_FIELDS`` keys) -> dict of tensors on ``device``
    (see device.resolve_device: None is the card, and raises with none)
    with the same values: integers as int64, floats as float32."""
    device = resolve_device(device)
    out = {}
    for k in ARRAY_FIELDS:
        a = np.asarray(arrays[k])
        dtype = torch.float32 if a.dtype.kind == "f" else torch.int64
        out[k] = torch.as_tensor(a).to(device=device, dtype=dtype)
    return out
