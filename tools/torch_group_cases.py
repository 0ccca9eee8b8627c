"""Candidate slot sets for the ``group`` kernel (csrc/group.cu) and its twin
(ops/detect.py group_plain): NumPy only, so the CPU tests, the card tests
and chip_smoke.py phase 3 share them.

``cases(rng)`` returns {name: (x, y, w, h, conf, valid)}, each (n, 256)
(f32 and bool): boxes clustered around a few centres, a 256-slot chain
(each box overlaps only its two neighbours: the longest component), the
chain with its boxes shuffled over the slots, 256 singletons, every slot
valid in a dense grid, streams whose last valid slot is k - 1 for k = 1,
32, 33 and 256, equal confidences, a non-prefix valid mask (garbage in the
invalid slots) and a small cluster inside a larger one.  Coordinates are
the detector's kind: 0 or at least 2, below 2^12.
"""

import numpy as np

K = 256  # the kernel's most slots a stream


def _empty(n, k=K):
    x = np.zeros((n, k), np.float32)
    return x, x.copy(), x.copy(), x.copy(), x.copy(), np.zeros((n, k), bool)


def clustered(rng, n, k=K, m=None):
    """Boxes around three centres, widths from the pyramid's scales; the
    valid slots a prefix of m (random when None)."""
    x, y, w, _, c, valid = _empty(n, k)
    for s in range(n):
        ms = int(rng.integers(0, k + 1)) if m is None else m
        centres = rng.uniform(20, 200, (3, 2))
        pick = rng.integers(0, 3, ms)
        scale = (2.0 ** (1 / 6)) ** rng.integers(0, 6, ms)
        x[s, :ms] = (2 * np.round(centres[pick, 0] + rng.normal(0, 2, ms))
                     * scale).astype(np.float32)
        y[s, :ms] = (2 * np.round(centres[pick, 1] + rng.normal(0, 2, ms))
                     * scale).astype(np.float32)
        w[s, :ms] = (24 * scale).astype(np.float32)
        c[s, :ms] = rng.normal(-3, 1, ms).astype(np.float32)
        valid[s, :ms] = True
    return x, y, w, w.copy(), c, valid


def chain(rng, order=None):
    """Box p at x = 5 p (width 24: neighbours within 6 px), so each box
    overlaps only the boxes before and after it; ``order`` places box p in
    slot order[p]."""
    x, y, w, h, c, valid = _empty(1)
    slot = np.arange(K) if order is None else order
    x[0, slot] = 2 + 5 * np.arange(K, dtype=np.float32)
    y[0] = 100
    w[0] = h[0] = 24
    c[0] = rng.normal(-3, 1, K).astype(np.float32)
    valid[0] = True
    return x, y, w, h, c, valid


def singletons(rng):
    """256 boxes 40 px apart on a 16 x 16 grid: 256 components of one."""
    x, y, w, h, c, valid = _empty(1)
    i = np.arange(K)
    x[0] = 2 + 40 * (i % 16)
    y[0] = 2 + 40 * (i // 16)
    w[0] = h[0] = 24
    c[0] = rng.normal(-3, 1, K).astype(np.float32)
    valid[0] = True
    return x, y, w, h, c, valid


def dense(rng):
    """Every slot valid: 2 px grid steps at three scales (rows of many
    neighbours, a few large components)."""
    x, y, w, h, c, valid = _empty(1)
    i = np.arange(K)
    scale = np.float32(2.0 ** (1 / 6)) ** (i % 3)
    x[0] = ((100 + 2 * ((i // 3) % 9)) * scale).astype(np.float32)
    y[0] = ((100 + 2 * (i // 27)) * scale).astype(np.float32)
    w[0] = h[0] = (24 * scale).astype(np.float32)
    c[0] = rng.normal(-3, 1, K).astype(np.float32)
    valid[0] = True
    return x, y, w, h, c, valid


def last_slots(rng, ks=(1, 32, 33, 256)):
    """A stream a k: clustered slots whose last valid slot is k - 1."""
    parts = [clustered(rng, 1, m=k) for k in ks]
    return tuple(np.concatenate(a) for a in zip(*parts))


def ties():
    """Equal confidences: two equal clusters far apart (their
    representatives tie: slot 0's wins), and equal singletons."""
    x, y, w, h, c, valid = _empty(2)
    off = np.array([[0, 0], [2, 0], [0, 2], [2, 2], [4, 2]], np.float32)
    for a, (cx, cy) in enumerate(((50, 50), (200, 200))):
        sl = slice(5 * a, 5 * a + 5)
        x[0, sl] = cx + off[:, 0]
        y[0, sl] = cy + off[:, 1]
    x[1, :6] = 2 + 60 * np.arange(6)
    y[1, :6] = 30
    w[:, :10] = h[:, :10] = 24
    c[:, :10] = -1.5
    valid[0, :10] = True
    valid[1, :6] = True
    return x, y, w, h, c, valid


def holes(rng):
    """Clustered slots under a random valid mask (the last slot valid in
    one stream, not in the other); the invalid slots hold garbage."""
    x, y, w, h, c, valid = clustered(rng, 2, m=K)
    for a in (x, y, w, h, c):
        junk = rng.uniform(-1e3, 1e3, a.shape).astype(np.float32)
        a[...] = np.where(valid, a, junk)
    valid[...] = rng.random(valid.shape) < 0.4
    valid[0, -1] = True
    valid[1, -1] = False
    return x, y, w, h, c, valid


def nested():
    """A small cluster (2 boxes, width 24) inside a larger one (6 boxes,
    width 48) that is not its neighbour: the containment drops it."""
    x, y, w, h, c, valid = _empty(1)
    x[0, :6] = 100 + np.array([0, 2, 4, 0, 2, 4])
    y[0, :6] = 100 + np.array([0, 0, 0, 2, 2, 2])
    w[0, :6] = 48
    x[0, 6:8] = 110
    y[0, 6:8] = (110, 112)
    w[0, 6:8] = 24
    h[0] = w[0]
    c[0, :8] = np.linspace(-4, -1, 8, dtype=np.float32)
    valid[0, :8] = True
    return x, y, w, h, c, valid


def cases(rng):
    return {"clustered": clustered(rng, 8),
            "chain": chain(rng),
            "chain shuffled": chain(rng, rng.permutation(K)),
            "singletons": singletons(rng),
            "dense": dense(rng),
            "k = 1, 32, 33, 256": last_slots(rng),
            "ties": ties(),
            "holes": holes(rng),
            "nested": nested()}
