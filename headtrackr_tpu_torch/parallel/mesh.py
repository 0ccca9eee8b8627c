"""Stream meshes: the stream batch split over devices, one slice a shard.

The counterpart of headtrackr_tpu/parallel/mesh.py.  The tracking algorithm
has no cross-stream communication (SURVEY §2), so serving on several devices
is a 1-D mesh with the stream batch split over it: each shard steps its own
slice of the streams on its own device, and only frames go in and results
come out.

A mesh here is a 1-D array of ``torch.device``, one entry a shard.  An entry
may repeat: each shard then holds its own state slice and its own CUDA graph
on the one device.  That is how a CPU test gets 8 shards (the reference's
tests use 8 virtual CPU devices) and one card gets 4.

Usage:
    mesh = stream_mesh()                       # every visible card
    bt = BatchedTracker(256, mesh=mesh)        # state and frames split
"""

import numpy as np
import torch

__all__ = ["StreamMesh", "stream_mesh", "split_streams", "shard_streams",
           "gather_streams"]


class StreamMesh:
    """A 1-D mesh: ``devices`` (a NumPy object array of ``torch.device``,
    one entry a shard) along the axis ``axis_names[0]``."""

    def __init__(self, devices, axis_name="streams"):
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("a stream mesh needs at least one device")
        self.devices = np.empty(len(devs), dtype=object)
        self.devices[:] = devs
        self.axis_names = (axis_name,)

    def __repr__(self):
        return (f"StreamMesh({[str(d) for d in self.devices]}, "
                f"axis_name={self.axis_names[0]!r})")


def stream_mesh(devices=None, axis_name="streams"):
    """1-D mesh over the given devices (default: every visible CUDA device;
    with no card this raises: a CPU mesh is asked for by name)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices=['cpu'] * k for "
                               "a mesh of k shards on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return StreamMesh(devices, axis_name)


def split_streams(x, k, axis=0):
    """``x`` (tensor or array) cut into k equal slices along ``axis``, views
    where it can; a length that does not divide raises ``ValueError``."""
    n = x.shape[axis]
    if n % k:
        raise ValueError(f"a stream axis of length {n} does not split into "
                         f"{k} equal shards")
    per = n // k
    if torch.is_tensor(x):
        return [x.narrow(axis, j * per, per) for j in range(k)]
    lead = (slice(None),) * axis
    return [np.asarray(x)[lead + (slice(j * per, (j + 1) * per),)]
            for j in range(k)]


def _place(x, device):
    """A fresh contiguous tensor of ``x`` on ``device`` (never a view of
    the caller's tensor or array)."""
    if torch.is_tensor(x):
        return x.to(device, copy=True).contiguous()
    return torch.as_tensor(np.ascontiguousarray(x)).to(device, copy=True)


def shard_streams(tree, mesh, axis_name="streams"):
    """Split a stream-batched tree (a NamedTuple tree, a tensor or an array;
    None leaves stay None) along its leading stream axis into the mesh's
    equal slices.  Returns one tree a shard, each on its shard's device.  A length
    that does not divide raises ``ValueError``, and so does an
    ``axis_name`` that is not the mesh's axis."""
    if axis_name != mesh.axis_names[0]:
        raise ValueError(f"the mesh's axis is {mesh.axis_names[0]!r}, not "
                         f"{axis_name!r}")
    k = mesh.devices.size

    def cut(t):
        if isinstance(t, tuple):
            parts = [cut(v) for v in t]
            return [type(t)(*row) for row in zip(*(
                p if p is not None else [None] * k for p in parts))]
        if t is None:
            return None
        return [_place(s, d) for s, d in zip(split_streams(t, k),
                                             mesh.devices.flat)]

    return cut(tree)


def gather_streams(parts, device):
    """The inverse of ``shard_streams``: the shards' trees joined along the
    leading stream axis, in shard order, on ``device``."""
    first = parts[0]
    if isinstance(first, tuple):
        return type(first)(*(gather_streams(list(leaves), device)
                             for leaves in zip(*parts)))
    if first is None:
        return None
    return torch.cat([p.to(device) for p in parts])
