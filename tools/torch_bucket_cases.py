"""Cases of the relock tick's bucket kernels against their plain twins:
``frame_prep`` (K9, kernels/frameprep.py), ``handoff`` (K7,
kernels/handoff.py) in both its forms and ``slot_gather`` (S5,
kernels/schedule.py), bit for bit, on seeded inputs drawn to reach every
branch: streams entering in WB (some of whose rings are stable), VJ and
CS; detections found and missed, above and below the confidence
threshold, at the frame's edges and past them, empty; a model-colored
pixel one row or one column outside the band and none; slots padded with
N.  The twins run on the same device as the kernels (on the card: the
twin run on the card).

    python3 tools/torch_bucket_cases.py [N ...]    # on the card

``check(n, dev)`` returns the counts it reached (and raises on the first
difference); ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` run it
at 1, 8, 256 and 70,000 streams.  ``check_splits(n, dev)`` holds
``frame_prep`` and ``handoff`` to their twins with each kernel's split
forced to every P the launchers can pick (``SPLITS``), the twin taking
the same split; its inputs add a model-colored pixel just outside the
band on a row where the audit's shares of the frame meet.

    python3 tools/torch_bucket_cases.py --splits [N ...]

``check_gather(n, dev)`` holds ``slot_gather`` to its twin at every slot
count from 1 to the serving tick's chunk cap (bucket 8) and at the escape
fallback's escape_bucket, under both keep rules (the bucket's and the
escape's), on a seeded state with two 1-D strided leaves (an f32 and a
bool column) and the frames gathered as an extra leaf; its grid's x
against ``gather_ctas``; one launch a call.

    python3 tools/torch_bucket_cases.py --gather [N ...]

``check_in_place(n, dev)`` holds ``frame_prep`` and ``handoff`` reading
tick k of a scan in place (``launch.frames_at`` through a device word,
the buffer they are given filled with 255) to the same kernels reading
tick k's frames directly, bit for bit: 320x240 and an odd size (57x99:
H W % 16 != 0 and W % 16 != 0), the scan staged on a 16-byte boundary
and 4 and 1 bytes past one, tick 2 of 3.

    python3 tools/torch_bucket_cases.py --in-place [N ...]
"""

import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NS = (1, 8, 256, 70000)
SLOTS = 8  # a relock bucket's slots
BIG = 4096  # past it the frames shrink to 120x160 (70,000 streams: 4 GB)
CHUNK = 8192  # streams a twin call takes at once (its temporaries' memory)
SPLITS = (1, 2, 4, 8, 16)  # every CTAs-a-stream the launchers can pick
BUCKET = 8  # the serving tick's bucket (chunk cap: up to 4 of them)
ESCAPE_BUCKET = 8  # the escape fallback's slots


IN_PLACE_SHAPES = ((240, 320), (57, 99))  # aligned rows, and neither
IN_PLACE_OFFSETS = (0, 4, 1)  # bytes past a 16-byte boundary
IN_PLACE_TICKS, IN_PLACE_TICK = 3, 2  # the scan's ticks, the one read


def frame_shape(n):
    return (240, 320) if n <= BIG else (120, 160)


def band_of(shape):
    return (96, 128) if shape[0] >= 240 else (64, 96)


def _same(x, y):
    """Bit-equal tensors (None equal to None)."""
    if x is None or y is None:
        return x is None and y is None
    if x.shape != y.shape or x.dtype != y.dtype:
        return False
    if x.is_floating_point():
        x, y = x.view(torch.int32), y.view(torch.int32)
    return torch.equal(x, y)


def _check(name, got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        if not _same(a, b):
            raise AssertionError(f"{name}: output {i} differs from the twin")


def inputs(n, dev, seed=0, shape=None):
    """Seeded frames (N, H, W, 3) u8 (of ``shape``, else frame_shape(n))
    and each stream's state rows: a face-colored box on noise, modes,
    rings, detections and rects."""
    H, W = frame_shape(n) if shape is None else shape
    rng = np.random.default_rng(seed)
    g = torch.Generator(device="cpu").manual_seed(seed)
    frames = torch.randint(0, 256, (n, H, W, 3), generator=g,
                           dtype=torch.uint8)
    frames //= 4  # dark noise: few pixels share the face's bins
    face = torch.tensor([230, 80, 60], dtype=torch.uint8)
    y0, x0 = H // 3, W // 3
    frames[:, y0:y0 + H // 4, x0:x0 + W // 4] = face
    mode = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32))
    # half the rings around the stream's own whitebalance: some stable
    from headtrackr_tpu_torch.ops.imageproc import whitebalance
    own = np.concatenate([whitebalance(frames[a:a + CHUNK]).numpy()
                          for a in range(0, n, CHUNK)])
    base = np.where(rng.random(n) < 0.5, own,
                    rng.uniform(30, 200, n)).astype(np.float32)[:, None]
    ring = base + rng.uniform(-0.9, 0.9, (n, 15)).astype(np.float32)
    wb_n = torch.from_numpy(rng.integers(12, 16, n).astype(np.int32))
    # detections: the face box, shifted, at the edges, past them, empty
    det_x = rng.uniform(-40, W, n).astype(np.float32)
    det_y = rng.uniform(-40, H, n).astype(np.float32)
    det_w = rng.uniform(0, W // 2, n).astype(np.float32)
    det_h = rng.uniform(0, H // 2, n).astype(np.float32)
    pick = rng.integers(0, 5, n)
    det_x[pick == 0], det_y[pick == 0] = x0 + 0.5, y0 + 0.25
    det_w[pick == 0], det_h[pick == 0] = W // 4, H // 4
    det_w[pick == 1] = 0.0  # empty
    det_x[pick == 2] = W - det_w[pick == 2] / 2  # past the right edge
    det_y[pick == 3] = -det_h[pick == 3] / 2  # past the top
    conf = rng.uniform(-20, 10, n).astype(np.float32)
    found = rng.random(n) < 0.7
    # model-colored pixels one row / one column outside the band placed for
    # the face's rect: streams 3k + 1 and 3k + 2
    bh, bw = band_of((H, W))
    rect = torch.tensor([x0, y0, W // 4, H // 4], dtype=torch.int32)
    from headtrackr_tpu_torch.models.camshift import band_rect
    ry, rx, bh, bw = band_rect(rect[None], (bh, bw), (H, W))
    ry, rx = int(ry[0]), int(rx[0])
    for j in range(1, n, 3):
        if ry > 0:
            frames[j, ry - 1, rx + bw // 2] = face
        elif ry + bh < H:
            frames[j, ry + bh, rx + bw // 2] = face
    for j in range(2, n, 3):
        if rx > 0:
            frames[j, ry + bh // 2, rx - 1] = face
        elif rx + bw < W:
            frames[j, ry + bh // 2, rx + bw] = face
    # and on a row where the audit's shares meet (k H / 16 or the row
    # before it), one column outside the band: streams 6k
    col = rx - 1 if rx > 0 else rx + bw
    for j in range(0, n, 6):
        if col < W:
            y = (j // 6 % 16) * H // 16 - (j // 96 % 2)
            frames[j, max(y, 0), col] = face
    rects = torch.from_numpy(np.stack([
        rng.integers(-30, W, n), rng.integers(-30, H, n),
        rng.integers(0, W, n), rng.integers(0, H, n)], 1).astype(np.int32))
    rects[pick == 0] = rect
    rects[pick == 1, 2] = 0
    t = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
    det = (t(found), t(det_x), t(det_y), t(det_w), t(det_h), t(conf))
    return dict(frames=frames.to(dev), mode=t(mode), ring=t(ring),
                wb_n=t(wb_n), det=det, rects=t(rects), band=(bh, bw))


def old_cs(n, dev, seed=1):
    """Seeded camshift rows (CamshiftState's leaves, band_dirty on)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    hist = torch.randint(0, 50, (n, 4096), generator=g).float()
    win = torch.randint(-10, 200, (n, 4), generator=g, dtype=torch.int32)
    track = [torch.randint(-5, 300, (n,), generator=g, dtype=torch.int32)
             for _ in range(4)]
    angle = torch.rand((n,), generator=g)
    dirty = torch.rand((n,), generator=g) < 0.5
    return tuple(x.to(dev) for x in (hist, win, *track, angle, dirty))


def _slots(n, dev, seed=2):
    """SLOTS slots of n streams padded with N (at least one pad)."""
    rng = np.random.default_rng(seed)
    k = min(SLOTS - 1, n)
    idx = np.full(SLOTS, n, np.int64)
    idx[:k] = np.sort(rng.choice(n, k, replace=False))
    return torch.as_tensor(idx).to(dev)


def _leaves(tree):
    if isinstance(tree, tuple):
        return [t for v in tree for t in _leaves(v)]
    return [] if tree is None else [tree]


def _chunks(n):
    return [(a, min(n, a + CHUNK)) for a in range(0, n, CHUNK)]


def _cat(parts):
    return tuple(None if p[0] is None else torch.cat(p) for p in zip(*parts))


def check(n, dev, seed=0):
    """Each kernel against its twin at n streams on ``dev``: frame_prep
    with and without the gray plane and wb_vj, over every stream and
    through padded slots; handoff's init form (band on and off) and its
    handoff form over every stream and through slots; slot_gather of a
    TrackerState of n streams.  Returns the counts reached."""
    from headtrackr_tpu_torch.kernels import launch as L
    from headtrackr_tpu_torch.kernels.frameprep import frame_prep
    from headtrackr_tpu_torch.kernels.handoff import handoff
    from headtrackr_tpu_torch.kernels.schedule import (slot_gather,
                                                       slot_gather_plain)
    from headtrackr_tpu_torch.models import facetracker as ft
    from headtrackr_tpu_torch.ops.handoff import handoff_plain
    from headtrackr_tpu_torch.ops.imageproc import frame_prep_plain

    inp = inputs(n, dev, seed)
    frames, band = inp["frames"], inp["band"]
    old = old_cs(n, dev)
    counts = dict(runs=0, stable=0, switched=0, dirty=0, clean=0, kept=0)
    before = {k: L.launches[k] for k in ("frame_prep", "handoff",
                                         "slot_gather")}
    slots = _slots(n, dev)
    safe = torch.clamp(slots, max=n - 1)
    rows = lambda t: t.index_select(0, safe)  # noqa: E731

    # K9
    for gray, wb_vj in ((True, False), (False, True)):
        got = frame_prep(frames, None, inp["mode"], inp["ring"], inp["wb_n"],
                         gray, wb_vj)
        want = _cat([frame_prep_plain(frames[a:b], None, inp["mode"][a:b],
                                      inp["ring"][a:b], inp["wb_n"][a:b],
                                      gray, wb_vj) for a, b in _chunks(n)])
        _check(f"frame_prep gray={gray} wb_vj={wb_vj}", got, want)
        counts["stable"] += int(((inp["mode"] == 0) & (got[4] == 1)).sum())
        got = frame_prep(frames, slots, rows(inp["mode"]), rows(inp["ring"]),
                         rows(inp["wb_n"]), gray, wb_vj)
        want = frame_prep_plain(frames, slots, rows(inp["mode"]),
                                rows(inp["ring"]), rows(inp["wb_n"]), gray,
                                wb_vj)
        _check(f"frame_prep slots gray={gray}", got, want)
        counts["runs"] += 2

    # K7, init form
    for b in (band, None):
        got = handoff(frames, rect=inp["rects"], band=b)
        want = _cat([handoff_plain(frames[a:c], rect=inp["rects"][a:c],
                                   band=b) for a, c in _chunks(n)])
        _check(f"handoff init band={b}", got, want)
        counts["runs"] += 1
        if b is not None:
            counts["dirty"] += int(got[7].sum())
            counts["clean"] += int((~got[7]).sum())

    # K7, handoff form
    det, mode = inp["det"], inp["mode"]
    mode_in = torch.where(mode == 0, 1, mode).to(torch.int32)  # frame_prep's
    got = handoff(frames, det=det, entry_mode=mode, mode=mode_in, old=old,
                  band=band)
    want_parts = [handoff_plain(frames[a:c], det=tuple(d[a:c] for d in det),
                                entry_mode=mode[a:c], mode=mode_in[a:c],
                                old=tuple(o[a:c] for o in old), band=band)
                  for a, c in _chunks(n)]
    want = (_cat([w[0] for w in want_parts]),
            torch.cat([w[1] for w in want_parts]),
            _cat([w[2] for w in want_parts]))
    _check("handoff leaves", got[0], want[0])
    _check("handoff mode", (got[1],), (want[1],))
    _check("handoff result", got[2], want[2])
    counts["switched"] += int(((mode == 1) & (got[1] == 2)).sum())
    got = handoff(frames, slots, det=tuple(rows(d) for d in det),
                  entry_mode=rows(mode), mode=rows(mode_in),
                  old=tuple(rows(o) for o in old), band=band)
    want = handoff_plain(frames, slots, det=tuple(rows(d) for d in det),
                         entry_mode=rows(mode), mode=rows(mode_in),
                         old=tuple(rows(o) for o in old), band=band)
    _check("handoff slots leaves", got[0], want[0])
    _check("handoff slots mode", (got[1],), (want[1],))
    _check("handoff slots result", got[2], want[2])
    counts["runs"] += 2

    # S5
    state = ft.init_state(n, band_audit=True, device=dev)
    g = torch.Generator(device="cpu").manual_seed(seed + 5)

    def fill(t):
        r = torch.randint(0, 7, t.shape, generator=g)
        return (r > 3).to(dev) if t.dtype == torch.bool else \
            r.to(t.dtype).to(dev)

    state = type(state)(*(fill(v) if torch.is_tensor(v) else
                          type(v)(*(fill(x) if x is not None else None
                                    for x in v)) for v in state))
    # a 1-D strided leaf too (a column of an (N, 3) tensor)
    col = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    col[:, 1] = state.tan_fov
    state = state._replace(mode=(state.mode % 3).to(torch.int32),
                           tan_fov=col[:, 1])
    got = slot_gather(state, slots)
    want = slot_gather_plain(state, slots)
    _check("slot_gather", _leaves(got[0]), _leaves(want[0]))
    _check("slot_gather keep", (got[1],), (want[1],))
    counts["kept"] += int(got[1].sum())
    counts["runs"] += 1
    if dev.type == "cuda":
        torch.cuda.synchronize()
    counts["launches"] = {k: L.launches[k] - v for k, v in before.items()}
    return counts


def gather_state(n, dev, seed=5):
    """A seeded TrackerState of n streams (band_dirty on) whose modes mix
    WB, VJ and CS, with tan_fov an f32 column of an (n, 3) tensor and
    sm_init a bool column of an (n, 2) tensor (1-D strided leaves)."""
    from headtrackr_tpu_torch.models import facetracker as ft
    state = ft.init_state(n, band_audit=True, device=dev)
    g = torch.Generator(device="cpu").manual_seed(seed)

    def fill(t):
        r = torch.randint(0, 7, t.shape, generator=g)
        return (r > 3).to(dev) if t.dtype == torch.bool else \
            r.to(t.dtype).to(dev)

    state = type(state)(*(fill(v) if torch.is_tensor(v) else
                          type(v)(*(fill(x) if x is not None else None
                                    for x in v)) for v in state))
    col = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    col[:, 1] = state.tan_fov
    flags = torch.zeros((n, 2), dtype=torch.bool, device=dev)
    flags[:, 1] = state.sm_init
    return state._replace(mode=(state.mode % 3).to(torch.int32),
                          tan_fov=col[:, 1], sm_init=flags[:, 1])


def gather_slots(n, s, dev, seed):
    """s seeded slots of n streams, about a quarter of them padding (N)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    idx = torch.randint(0, n, (s,), generator=g)
    idx[torch.rand((s,), generator=g) < 0.25] = n
    return idx.to(dev)


def check_gather(n, dev, seed=0):
    """slot_gather against its twin at n streams on ``dev``: every slot
    count from 1 to the chunk cap and escape_bucket, both keep rules,
    ``gather_state``'s leaves and the frames as an extra leaf, bit for
    bit; on the card the launcher's grid against ``gather_ctas``.
    Returns the counts reached (calls, kept rows by rule, launches)."""
    import ctypes
    from headtrackr_tpu_torch.kernels import launch as L
    from headtrackr_tpu_torch.kernels import schedule as S
    from headtrackr_tpu_torch.kernels.build import load_library
    H, W = frame_shape(n)
    g = torch.Generator(device="cpu").manual_seed(seed)
    frames = torch.randint(0, 256, (n, H, W, 3), generator=g,
                           dtype=torch.uint8).to(dev)
    state = gather_state(n, dev)
    kb = min(BUCKET, n)
    cap = max(kb, (min(n, 4 * kb) // kb) * kb)
    counts = {"calls": 0, "kept bucket": 0, "kept escape": 0}
    before = L.launches["slot_gather"]
    leaves = _leaves(state) + [frames]
    for s in sorted(set(range(1, cap + 1)) | {ESCAPE_BUCKET}):
        idx = gather_slots(n, s, dev, seed + s)
        if dev.type == "cuda":
            a = S._GatherArgs(idx.data_ptr(), state.mode.data_ptr(),
                              idx.data_ptr(), n, state.mode.stride(0), s,
                              len(leaves), 0)
            for j, t in enumerate(leaves):
                a.rb[j] = t.nbytes // n
            got = load_library().fn("slot_gather_ctas")(ctypes.addressof(a))
            want = S.gather_ctas([a.rb[j] for j in range(len(leaves))])
            if got != want:
                raise AssertionError(f"slot_gather's grid at N={n}, {s} "
                                     f"slots: {got} CTAs in csrc, {want} "
                                     f"in Python")
        for escape in (False, True):
            got = S.slot_gather(state, idx, escape, (frames,))
            want = S.slot_gather_plain(state, idx, escape, (frames,))
            where = f"slot_gather N={n} slots={s} escape={escape}"
            _check(where, _leaves(got[0]), _leaves(want[0]))
            _check(f"{where} keep", (got[1],), (want[1],))
            _check(f"{where} frames", got[2:], want[2:])
            counts["kept escape" if escape else "kept bucket"] += \
                int(got[1].sum())
            counts["calls"] += 1
    if dev.type == "cuda":
        torch.cuda.synchronize()
    counts["launches"] = L.launches["slot_gather"] - before
    return counts


def check_splits(n, dev, seed=0, splits=SPLITS):
    """frame_prep (gray and wb_vj both ways, every stream and through
    slots) and handoff (the init form with the audit on and off, the
    handoff form with it) against their twins at n streams on ``dev``,
    each with its split forced to every P of ``splits`` and the twin
    taking the same P; one launch a call.  Returns {P: launches} and the
    counts reached."""
    from headtrackr_tpu_torch.kernels import launch as L
    from headtrackr_tpu_torch.kernels.frameprep import frame_prep
    from headtrackr_tpu_torch.kernels.handoff import handoff
    from headtrackr_tpu_torch.ops.handoff import handoff_plain
    from headtrackr_tpu_torch.ops.imageproc import frame_prep_plain

    inp = inputs(n, dev, seed)
    frames, band, mode = inp["frames"], inp["band"], inp["mode"]
    old = old_cs(n, dev)
    det = inp["det"]
    mode_in = torch.where(mode == 0, 1, mode).to(torch.int32)
    slots = _slots(n, dev)
    safe = torch.clamp(slots, max=n - 1)
    rows = lambda t: t.index_select(0, safe)  # noqa: E731
    out = {"launches": {}, "dirty": 0, "clean": 0}
    for p in splits:
        before = {k: L.launches[k] for k in ("frame_prep", "handoff")}
        for gray, wb_vj in ((True, False), (False, True)):
            got = frame_prep(frames, None, mode, inp["ring"], inp["wb_n"],
                             gray, wb_vj, split=p)
            want = _cat([frame_prep_plain(frames[a:b], None, mode[a:b],
                                          inp["ring"][a:b], inp["wb_n"][a:b],
                                          gray, wb_vj, p)
                         for a, b in _chunks(n)])
            _check(f"frame_prep P={p} gray={gray}", got, want)
            args = (rows(mode), rows(inp["ring"]), rows(inp["wb_n"]), gray,
                    wb_vj)
            _check(f"frame_prep P={p} slots gray={gray}",
                   frame_prep(frames, slots, *args, split=p),
                   frame_prep_plain(frames, slots, *args, p))
        for b in (band, None):
            got = handoff(frames, rect=inp["rects"], band=b, split=p)
            want = _cat([handoff_plain(frames[a:c], rect=inp["rects"][a:c],
                                       band=b, split=p)
                         for a, c in _chunks(n)])
            _check(f"handoff init P={p} band={b}", got, want)
            if b is not None:
                out["dirty"] += int(got[7].sum())
                out["clean"] += int((~got[7]).sum())
        got = handoff(frames, det=det, entry_mode=mode, mode=mode_in,
                      old=old, band=band, split=p)
        parts = [handoff_plain(frames[a:c], det=tuple(d[a:c] for d in det),
                               entry_mode=mode[a:c], mode=mode_in[a:c],
                               old=tuple(o[a:c] for o in old), band=band,
                               split=p)
                 for a, c in _chunks(n)]
        _check(f"handoff P={p} leaves", got[0], _cat([w[0] for w in parts]))
        _check(f"handoff P={p} mode", (got[1],),
               (torch.cat([w[1] for w in parts]),))
        _check(f"handoff P={p} result", got[2], _cat([w[2] for w in parts]))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out["launches"][p] = {k: L.launches[k] - v
                              for k, v in before.items()}
    return out


def staged_scan(frames, ticks, k, offset):
    """A scan of ``ticks`` ticks whose tick k is ``frames`` (the others
    its complement), staged ``offset`` bytes past a 16-byte boundary of
    one allocation on frames' device, and a (1,) i64 word on that device
    holding tick k's address: (scan, word)."""
    n = frames.numel()
    flat = torch.empty(ticks * n + 16 + offset, dtype=torch.uint8,
                       device=frames.device)
    at = (-flat.data_ptr()) % 16 + offset
    seq = flat[at:at + ticks * n].view((ticks,) + tuple(frames.shape))
    seq.copy_((255 - frames)[None].expand_as(seq))
    seq[k] = frames
    word = torch.tensor([seq[k].data_ptr()], dtype=torch.int64,
                        device=frames.device)
    return seq, word


def in_place_calls(inp, old, slots):
    """The calls ``check_in_place`` holds in place against direct: name ->
    fn(frames), frame_prep with and without the gray plane, handoff's init
    form with the audit and its handoff form, every stream and through
    ``slots``."""
    from headtrackr_tpu_torch.kernels.frameprep import frame_prep
    from headtrackr_tpu_torch.kernels.handoff import handoff
    safe = torch.clamp(slots, max=inp["mode"].shape[0] - 1)
    rows = lambda t: t.index_select(0, safe)  # noqa: E731
    mode, det, band = inp["mode"], inp["det"], inp["band"]
    mode_in = torch.where(mode == 0, 1, mode).to(torch.int32)
    calls = {}
    for sl, r in ((None, lambda t: t), (slots, rows)):
        tag = "" if sl is None else " slots"
        for gray in (True, False):
            calls[f"frame_prep gray={gray}{tag}"] = (
                lambda f, sl=sl, r=r, gray=gray: frame_prep(
                    f, sl, r(mode), r(inp["ring"]), r(inp["wb_n"]), gray,
                    not gray))
        calls[f"handoff init{tag}"] = (
            lambda f, sl=sl, r=r: handoff(f, sl, rect=r(inp["rects"]),
                                          band=band))
        calls[f"handoff{tag}"] = (
            lambda f, sl=sl, r=r: handoff(
                f, sl, det=tuple(r(d) for d in det), entry_mode=r(mode),
                mode=r(mode_in), old=tuple(r(o) for o in old), band=band))
    return calls


def check_in_place(n, dev, seed=0, shapes=IN_PLACE_SHAPES,
                   offsets=IN_PLACE_OFFSETS):
    """frame_prep and handoff (``in_place_calls``) at n streams on
    ``dev`` reading tick IN_PLACE_TICK of a scan in place, against the
    same kernels on a contiguous copy of that tick's frames: every output
    bit-equal, for each frame shape and staging offset; one launch a
    call; the buffer they are given (255) untouched.  Returns the counts
    reached."""
    from headtrackr_tpu_torch.kernels import launch as L
    out = {"cases": 0, "launches": 0}
    before = L.launches["frame_prep"] + L.launches["handoff"]
    for shape in shapes:
        inp = inputs(n, dev, seed, shape)
        frames = inp["frames"]
        old = old_cs(n, dev)
        calls = in_place_calls(inp, old, _slots(n, dev))
        direct = {name: fn(frames) for name, fn in calls.items()}
        buf = torch.full_like(frames, 255)
        for offset in offsets:
            seq, word = staged_scan(frames, IN_PLACE_TICKS, IN_PLACE_TICK,
                                    offset)
            assert seq[IN_PLACE_TICK].data_ptr() % 16 == offset
            # the twins on the CPU read the tick's frames themselves
            src = word if dev.type == "cuda" else seq[IN_PLACE_TICK]
            for name, fn in calls.items():
                with L.frames_at(buf, src):
                    got = fn(buf)
                _check(f"{name} {shape} offset {offset} in place",
                       _leaves(got), _leaves(direct[name]))
                out["cases"] += 1
        if dev.type == "cuda":
            torch.cuda.synchronize()
        if not bool((buf == 255).all()):
            raise AssertionError("the buffer given in place was written")
    out["launches"] = L.launches["frame_prep"] + L.launches["handoff"] - \
        before
    return out


def main(argv=None):
    args = sys.argv[1:] if argv is None else argv
    sys.path.insert(0, HERE)
    dev = torch.device("cuda", 0)
    fn = check
    if args and args[0] in ("--splits", "--gather", "--in-place"):
        fn, args = {"--splits": check_splits, "--gather": check_gather,
                    "--in-place": check_in_place}[args[0]], args[1:]
    for n in [int(a) for a in args] or NS:
        print(n, fn(n, dev), flush=True)


if __name__ == "__main__":
    main()
