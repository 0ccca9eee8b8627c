"""BBF cascade face detector oracle (dense transcription of src/ccv.js:109-333).

The JS detector slides a 24x24 window (at full-plane resolution) over every scale
step and phase with an early-exit per-stage scan.  The early exit is a branch
economy only: a weak classifier votes "pass" iff ``min(valid positive pixels) >
max(valid negative pixels)`` (proof: the shortcut loop at src/ccv.js:196-218 breaks
exactly when the running min crosses the running max).  The oracle evaluates that
predicate densely, vectorized over all window positions, terminating a
(scale, phase) batch when no window remains alive.

Addressing (src/ccv.js:155-243): for scale step i and phase q (dx, dy in {0,1}^2),
window (x, y) reads feature pixel (px, py, z) from:
    z=0: plane  i          at (4x + 2dx + px, 4y + 2dy + py)
    z=1: plane  i+next     at (2x +  dx + px, 2y +  dy + py)
    z=2: plane (i+2*next,q) at ( x +       px,  y +       py)
with qw = quarter.width - 6, qh = quarter.height - 6 window positions.

The benchmark's frozen copy of the port's NumPy oracle
(headtrackr_tpu_torch/oracle/detector.py): the yardstick that decides
``correct``, kept apart from the program so that no later change to the
program changes it.  It imports numpy alone.
"""

import numpy as np

from .imageproc import build_pyramid

__all__ = ["detect_objects", "array_group", "dense_scores"]


def detect_at_scale(p0, p1, p2, cascade, dx, dy):
    """Dense cascade evaluation for one (scale step, phase).

    Returns (alive, conf): boolean (qh, qw) of surviving windows and float64
    (qh, qw) of the last-evaluated stage sum (the JS ``sum`` at src/ccv.js:227-233).
    """
    qh, qw = p2.shape[0] - 6, p2.shape[1] - 6
    if qh <= 0 or qw <= 0:
        return np.zeros((0, 0), bool), np.zeros((0, 0))

    flat_alive = np.ones(qh * qw, bool)
    conf_flat = np.zeros(qh * qw)

    # Flatten window coordinates once; evaluate stage by stage over the still-alive
    # subset only (vectorized equivalent of the JS per-window early exit).
    yy, xx = np.meshgrid(np.arange(qh), np.arange(qw), indexing="ij")
    yy = yy.ravel()
    xx = xx.ravel()
    idx_alive = np.arange(qh * qw)

    S = int(cascade["count"])
    k0 = 0
    for s in range(S):
        cnt = int(cascade["stage_counts"][s])
        if idx_alive.size == 0:
            break
        ay = yy[idx_alive]
        ax = xx[idx_alive]
        ssum = np.zeros(idx_alive.size)
        for k in range(k0, k0 + cnt):
            pmin = None
            nmax = None
            for f in range(int(cascade["size"][k])):
                z = int(cascade["pz"][k, f])
                if z >= 0:
                    fx, fy = int(cascade["px"][k, f]), int(cascade["py"][k, f])
                    if z == 0:
                        v = p0[4 * ay + 2 * dy + fy, 4 * ax + 2 * dx + fx]
                    elif z == 1:
                        v = p1[2 * ay + dy + fy, 2 * ax + dx + fx]
                    else:
                        v = p2[ay + fy, ax + fx]
                    pmin = v if pmin is None else np.minimum(pmin, v)
                z = int(cascade["nz"][k, f])
                if z >= 0:
                    fx, fy = int(cascade["nx"][k, f]), int(cascade["ny"][k, f])
                    if z == 0:
                        v = p0[4 * ay + 2 * dy + fy, 4 * ax + 2 * dx + fx]
                    elif z == 1:
                        v = p1[2 * ay + dy + fy, 2 * ax + dx + fx]
                    else:
                        v = p2[ay + fy, ax + fx]
                    nmax = v if nmax is None else np.maximum(nmax, v)
            passed = pmin > nmax
            ssum += np.where(passed, cascade["alpha"][k, 1], cascade["alpha"][k, 0])
        conf_flat[idx_alive] = ssum
        ok = ssum >= cascade["stage_thresh"][s]
        flat_alive[idx_alive[~ok]] = False
        idx_alive = idx_alive[ok]
        k0 += cnt

    return flat_alive.reshape(qh, qw), conf_flat.reshape(qh, qw)


def dense_scores(gray, cascade, interval=5, pyramid=None):
    """All surviving raw windows before grouping, in JS seq order
    (scale -> phase -> y -> x).  Each: dict(x, y, width, height, neighbor, confidence).
    src/ccv.js:154-246.

    pyramid: optional prebuilt (pyr, scale, scale_upto, next_) tuple — used by
    tools/resampler_sensitivity.py to feed resampler variants through the
    same detector (the browser's drawImage interpolation is unspecified,
    src/ccv.js:121-146; see docs/PARITY.md deviation 2)."""
    pyr, scale, scale_upto, next_ = (pyramid if pyramid is not None
                                     else build_pyramid(gray, interval))
    dxs = [0, 1, 0, 1]
    dys = [0, 0, 1, 1]
    seq = []
    scale_x = 1.0
    scale_y = 1.0
    for i in range(scale_upto):
        p0 = pyr[i * 4]
        p1 = pyr[(i + next_) * 4]
        for q in range(4):
            p2 = pyr[(i + next_ * 2) * 4 + q]
            alive, conf = detect_at_scale(p0, p1, p2, cascade, dxs[q], dys[q])
            ys, xs = np.nonzero(alive)
            for wy, wx in zip(ys, xs):
                seq.append({
                    "x": (wx * 4 + dxs[q] * 2) * scale_x,
                    "y": (wy * 4 + dys[q] * 2) * scale_y,
                    "width": 24 * scale_x,
                    "height": 24 * scale_y,
                    "neighbor": 1,
                    "confidence": conf[wy, wx],
                })
        scale_x *= scale
        scale_y *= scale
    return seq


def array_group(seq, gfunc):
    """Union-find grouping, transcribed from src/ccv.js:34-107.

    Returns (index array, number of classes); classes numbered in order of first
    appearance, like the JS ``~class_idx++`` trick."""
    n = len(seq)
    parent = [-1] * n
    rank = [0] * n

    def find(i):
        while parent[i] != -1:
            i = parent[i]
        return i

    for i in range(n):
        root = find(i)
        for j in range(n):
            if i != j and gfunc(seq[i], seq[j]):
                root2 = find(j)
                if root2 != root:
                    if rank[root] > rank[root2]:
                        parent[root2] = root
                    else:
                        parent[root] = root2
                        if rank[root] == rank[root2]:
                            rank[root2] += 1
                        root = root2
                    # path compression (behaviorally irrelevant, kept for spirit)
                    for start in (j, i):
                        node = start
                        while parent[node] != -1:
                            nxt = parent[node]
                            parent[node] = root
                            node = nxt

    idx = [0] * n
    class_idx = 0
    labels = {}
    for i in range(n):
        r = find(i)
        if r not in labels:
            labels[r] = class_idx
            class_idx += 1
        idx[i] = labels[r]
    return idx, class_idx


def _group_predicate(r1, r2):
    # src/ccv.js:252-261
    distance = int(np.floor(r1["width"] * 0.25 + 0.5))
    return (r2["x"] <= r1["x"] + distance and
            r2["x"] >= r1["x"] - distance and
            r2["y"] <= r1["y"] + distance and
            r2["y"] >= r1["y"] - distance and
            r2["width"] <= int(np.floor(r1["width"] * 1.5 + 0.5)) and
            int(np.floor(r2["width"] * 1.5 + 0.5)) >= r1["width"])


def detect_objects(gray, cascade, interval=5, min_neighbors=1, pyramid=None):
    """Full detector: dense scan + grouping + containment filter.

    Mirrors src/ccv.js:109-333.  Returns a list of dicts with keys
    x, y, width, height, neighbors, confidence (floats).
    """
    seq = dense_scores(gray, cascade, interval, pyramid=pyramid)
    if not min_neighbors > 0:
        return seq

    idx_seq, ncomp = array_group(seq, _group_predicate)
    comps = [dict(neighbors=0, x=0.0, y=0.0, width=0.0, height=0.0, confidence=0.0)
             for _ in range(ncomp + 1)]
    for i, r1 in enumerate(seq):
        idx = idx_seq[i]
        if comps[idx]["neighbors"] == 0:
            comps[idx]["confidence"] = r1["confidence"]
        comps[idx]["neighbors"] += 1
        comps[idx]["x"] += r1["x"]
        comps[idx]["y"] += r1["y"]
        comps[idx]["width"] += r1["width"]
        comps[idx]["height"] += r1["height"]
        comps[idx]["confidence"] = max(comps[idx]["confidence"], r1["confidence"])

    seq2 = []
    for i in range(ncomp):
        n = comps[i]["neighbors"]
        if n >= min_neighbors:
            seq2.append({
                "x": (comps[i]["x"] * 2 + n) / (2 * n),
                "y": (comps[i]["y"] * 2 + n) / (2 * n),
                "width": (comps[i]["width"] * 2 + n) / (2 * n),
                "height": (comps[i]["height"] * 2 + n) / (2 * n),
                "neighbors": n,
                "confidence": comps[i]["confidence"],
            })

    result_seq = []
    for i, r1 in enumerate(seq2):
        flag = True
        for j, r2 in enumerate(seq2):
            distance = int(np.floor(r2["width"] * 0.25 + 0.5))
            if (i != j and
                    r1["x"] >= r2["x"] - distance and
                    r1["y"] >= r2["y"] - distance and
                    r1["x"] + r1["width"] <= r2["x"] + r2["width"] + distance and
                    r1["y"] + r1["height"] <= r2["y"] + r2["height"] + distance and
                    (r2["neighbors"] > max(3, r1["neighbors"]) or r1["neighbors"] < 3)):
                flag = False
                break
        if flag:
            result_seq.append(r1)
    return result_seq
