"""Plain PyTorch twins of the detector's cascade and group kernels
(kernels/cascade.py, kernels/group.py): what the CPU runs and what the
kernels are held against, to the bit.

``cascade_plain`` evaluates the stages over the windows still alive, batched
over streams (one boolean compaction a stage, so it reads the host: it is a
CPU path), then keeps each stream's first ``capacity`` survivors in window
order.  ``group_plain`` is ccv's grouping over fixed candidate slots with no
host read: connected components by a transitive closure of fixed depth.
The tables are a ``models.detector.DetectorTables``.
"""

import math

import torch

__all__ = ["cascade_plain", "group_plain"]

# alive windows x weak slots per gather chunk (bounds the index tensors)
_GATHER_BUDGET = 1 << 25


def _stage_sums(buf, tables, stage, nidx, midx):
    """f64 vote sums of one stage for the alive windows (nidx, midx)."""
    base = tables.base[midx]
    rstep = tables.rowstep[midx]
    row0 = nidx * buf.shape[1]
    ext = []
    for (z, xoff, py, valid), fill, reduce in zip(
            stage.sides, (255, 0), (torch.amin, torch.amax)):
        idx = row0[:, None, None] + base[:, z] + py * rstep[:, z] + xoff
        vals = buf.view(-1)[idx].to(torch.int16)
        vals = torch.where(valid, vals, fill)
        ext.append(reduce(vals, dim=2))
    votes = torch.where(ext[0] > ext[1], stage.alpha1, stage.alpha0)
    return votes.to(torch.float64).sum(dim=1)


def cascade_plain(buf, tables, capacity):
    """The cascade over every window of the packed planes ``buf`` (N, L) u8.

    Returns dict of (N, capacity) x, y, width, height, confidence (f32; 0 in
    empty slots) and valid (bool): each stream's first ``capacity``
    survivors in window order, the confidence the f32 of the last stage
    sum; and overflow (N,) i32, the survivors beyond ``capacity``."""
    N = buf.shape[0]
    dev = buf.device
    M = tables.M
    out = torch.zeros((5, N, capacity), dtype=torch.float32, device=dev)
    valid = torch.zeros((N, capacity), dtype=torch.bool, device=dev)
    overflow = torch.zeros((N,), dtype=torch.int32, device=dev)
    if M and N:
        alive = torch.arange(N * M, dtype=torch.int64, device=dev)
        conf = torch.zeros((N * M,), dtype=torch.float32, device=dev)
        for stage in tables.stages:
            if alive.numel() == 0:
                break
            per = max(1, _GATHER_BUDGET // (10 * stage.alpha0.numel()))
            sums = torch.cat([
                _stage_sums(buf, tables, stage, a // M, a % M)
                for a in torch.split(alive, per)])
            conf[alive] = sums.to(torch.float32)
            alive = alive[sums >= stage.thresh]
        n, m = alive // M, alive % M
        counts = torch.bincount(n, minlength=N)
        slot = torch.arange(alive.numel(), device=dev) - (
            torch.cumsum(counts, 0) - counts)[n]
        keep = slot < capacity
        n, m, slot = n[keep], m[keep], slot[keep]
        for f, vals in enumerate((tables.out_x, tables.out_y, tables.out_w,
                                  tables.out_h)):
            out[f, n, slot] = vals[m]
        out[4, n, slot] = conf[alive[keep]]
        valid[n, slot] = True
        overflow = torch.clamp(counts - capacity, min=0).to(torch.int32)
    return dict(x=out[0], y=out[1], width=out[2], height=out[3],
                confidence=out[4], valid=valid, overflow=overflow)


def _labels(adj, valid):
    """(N, K, K) symmetric adjacency -> (N, K) i64 component label = the
    smallest member slot (K for invalid slots): the transitive closure by
    ceil(log2 K) squarings (0/1 products summed in f32, exact), no host
    read."""
    N, K, _ = adj.shape
    reach = adj.to(torch.float32)
    for _ in range(max(1, math.ceil(math.log2(max(K, 2))))):
        reach = (torch.bmm(reach, reach) > 0).to(torch.float32)
    idx = torch.arange(K, device=adj.device)
    return torch.where(reach > 0, idx, K).amin(dim=2)


def group_plain(x, y, w, h, conf, valid, min_neighbors=1):
    """src/ccv.js:249-331 over (N, K) candidate slots, and facetrackr's pick.

    Returns (slots, best): slots a dict of (N, K) arrays, the kept mask and
    the grouped x/y/width/height/neighbors/confidence at the components'
    representative slots (the smallest member slot), in slot order like the
    JS seq2; best = (found, x, y, width, height, confidence) (N,): the kept
    slot of the largest confidence, the first on ties (slot 0 when none is
    kept).  min_neighbors <= 0 keeps every valid candidate as it is, with 1
    neighbour.  No host read."""
    N, K = x.shape
    f32 = torch.float32
    if not min_neighbors > 0:
        slots = dict(kept=valid, x=x, y=y, width=w, height=h,
                     neighbors=valid.to(f32), confidence=conf)
    else:
        dist = torch.floor(w * 0.25 + 0.5)
        wide = torch.floor(w * 1.5 + 0.5)
        col = lambda t: t[:, :, None]  # noqa: E731  (slot i, the r1 role)
        row = lambda t: t[:, None, :]  # noqa: E731  (slot j, the r2 role)
        pred = ((row(x) <= col(x) + col(dist)) &
                (row(x) >= col(x) - col(dist)) &
                (row(y) <= col(y) + col(dist)) &
                (row(y) >= col(y) - col(dist)) &
                (row(w) <= col(wide)) & (row(wide) >= col(w)))
        eye = torch.eye(K, dtype=torch.bool, device=x.device)
        adj = (pred | pred.transpose(1, 2)) & col(valid) & row(valid)
        adj = adj | (eye & col(valid))
        label = _labels(adj, valid)

        idxv = torch.arange(K, device=x.device)
        member = (row(label) == idxv[None, :, None]) & row(valid)  # [n, rep, j]
        # member sums in f64, exact in any order, rounded once to f32: a
        # stream's boxes do not depend on the batch
        mf = member.to(torch.float64)
        msum = lambda t: (mf * row(t).to(torch.float64)).sum(dim=2).to(f32)  # noqa: E731
        n = mf.sum(dim=2).to(f32)
        sx, sy, sw, sh = msum(x), msum(y), msum(w), msum(h)
        mconf = torch.where(member, row(conf), -torch.inf).amax(dim=2)

        rep = valid & (label == idxv) & (n >= min_neighbors)
        n_safe = torch.clamp(n, min=1.0)
        gx = (sx * 2 + n) / (2 * n_safe)
        gy = (sy * 2 + n) / (2 * n_safe)
        gw = (sw * 2 + n) / (2 * n_safe)
        gh = (sh * 2 + n) / (2 * n_safe)

        # containment filter (src/ccv.js:305-331): drop r1 contained (+-dist)
        # in a kept r2 with more neighbors
        dist2 = torch.floor(gw * 0.25 + 0.5)
        inside = ((col(gx) >= row(gx) - row(dist2)) &
                  (col(gy) >= row(gy) - row(dist2)) &
                  (col(gx) + col(gw) <= row(gx) + row(gw) + row(dist2)) &
                  (col(gy) + col(gh) <= row(gy) + row(gh) + row(dist2)) &
                  ((row(n) > torch.clamp(col(n), min=3.0)) | (col(n) < 3.0)) &
                  row(rep) & ~eye)
        slots = dict(kept=rep & ~inside.any(dim=2), x=gx, y=gy, width=gw,
                     height=gh, neighbors=n, confidence=mconf)
    if K == 0:
        z = torch.zeros((N,), dtype=f32, device=x.device)
        return slots, (torch.zeros((N,), dtype=torch.bool, device=x.device),
                       z, z, z, z, torch.full_like(z, -torch.inf))
    score = torch.where(slots["kept"], slots["confidence"], -torch.inf)
    i = torch.argmax(score, dim=1, keepdim=True)
    pick = lambda k: torch.gather(slots[k], 1, i)[:, 0]  # noqa: E731
    return slots, (slots["kept"].any(dim=1), pick("x"), pick("y"),
                   pick("width"), pick("height"), pick("confidence"))
