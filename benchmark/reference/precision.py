"""Roundings for the reference's floats: ``exact`` keeps float64, ``bf16``
rounds each value to bfloat16 (8 significant bits, round to nearest even),
the precision of the lower-precision control."""

import numpy as np

__all__ = ["exact", "bf16", "ROUNDINGS"]


def exact(x):
    """float64 as it is."""
    return x


def bf16(x):
    """x rounded to the nearest bfloat16 (ties to even), as float64; NaN
    and infinities pass through."""
    a = np.asarray(x, dtype=np.float64)
    bits = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    r = bits.astype(np.uint32).view(np.float32).astype(np.float64)
    r = np.where(np.isfinite(a), r, a)
    return r if r.ndim else np.float64(r)


ROUNDINGS = {"f64": exact, "bf16": bf16}
