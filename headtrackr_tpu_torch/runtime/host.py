"""Bring a group of device tensors to the host in one copy per dtype.

A per-tensor ``.cpu()`` is one synchronous device-to-host copy each: ~20
for a StepOutput.  ``HostCopy`` packs the tensors of each dtype into one
flat buffer on their device and copies that, asynchronously on the card
(into pinned memory, behind an event on the current stream), so the caller
may enqueue more device work before it waits in ``arrays()``.
"""

import math

import numpy as np
import torch

__all__ = ["HostCopy", "to_host"]


class HostCopy:
    """The host copy of ``leaves`` (tensors, or arrays taken as they are),
    started at construction; ``arrays()`` waits for it and returns NumPy
    arrays of the leaves' shapes, in order."""

    def __init__(self, leaves):
        groups = {}  # dtype -> flat tensors
        self._where = []  # per leaf: (dtype, offset, shape) or (None, array)
        for leaf in leaves:
            if torch.is_tensor(leaf):
                g = groups.setdefault(leaf.dtype, [])
                off = sum(t.numel() for t in g)
                self._where.append((leaf.dtype, off, tuple(leaf.shape)))
                g.append(leaf.reshape(-1))
            else:
                self._where.append((None, np.asarray(leaf), None))
        self._host = {}
        self._event = None
        cuda = None  # the device of the copies to wait for
        for dt, g in groups.items():
            packed = torch.cat(g)
            if packed.is_cuda:
                buf = torch.empty(packed.shape, dtype=dt, pin_memory=True)
                buf.copy_(packed, non_blocking=True)
                self._host[dt] = buf
                cuda = packed.device
            else:
                self._host[dt] = packed  # torch.cat made it a copy already
        if cuda is not None:  # after every copy, on the stream they ran on
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(cuda))

    def arrays(self):
        if self._event is not None:
            self._event.synchronize()
        out = []
        for dt, at, shape in self._where:
            if dt is None:
                out.append(at)
            else:
                n = math.prod(shape)
                out.append(self._host[dt][at:at + n].numpy().reshape(shape))
        return out


def to_host(tree):
    """A NamedTuple of tensors (e.g. a StepOutput) as the same NamedTuple of
    NumPy arrays, by one copy per dtype."""
    return type(tree)(*HostCopy(list(tree)).arrays())
