"""The kernels whose wrappers split a batch past 65,535 streams, on the card
at N streams of 160x120 frames, against their plain twins: the cases that
tests/test_torch_cuda.py and chip_smoke.py's F32 phase share.

Each of ``hist4096`` (rects and the whole frame), ``histpdf_band``
(hist-only; the pdf mode reading its frames directly and through the
serving program's address word, from a buffer poisoned with 255),
``backproject`` (over the frame and the band, the weights and the ratio
forms), ``hist_mma`` (rects, and the whole frame in place), ``pyramid``
and ``cascade`` puts the stream on the
grid's y dimension (65,535 a launch), so its wrapper launches a chunk of
at most that many streams at a time (kernels/histbins.py ``row_chunks``).
The frames: the bench pool's 256 streams of 160x120 (``bench.build_pool``,
faces) tiled over N, each stream's first three pixels stamped with its
index (so that a chunk reading another chunk's frames differs); boxes
random from a seeded generator, partly off the frame (the band kernels
take them as search windows and place each band from them, their twins
at ``models/camshift.py`` ``band_rect``'s rects); the model weights
integers 1..199.  Every kernel's result must equal its twin's, which runs
on the same card tensors in slices of SLICE streams (each stream's result
is its own), bit for bit; each wrapper's launches must number its chunks
(``cascade``: its dense and deep launches a chunk, one compaction).
``refusals`` calls each launcher with one stream more than a launch takes:
each must refuse, and ``kernels/launch.py`` ``launch`` then raises.

    python3 tools/torch_f32_cases.py [N ...]   (default: 65535 65536 70000)
"""

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAME = (120, 160)
BAND = (64, 96)
SLICE = 8192
NS = (65535, 65536, 70000)
# a case's name -> the launch count it reads, where the two differ
ALIAS = {"histpdf_band in place": "histpdf_band",
         "hist4096 whole frame": "hist4096", "hist_mma in place": "hist_mma"}
# the launchers that put the stream on the grid's y dimension: (arguments
# before the stream count, after it, before the stream), any sizes that
# pass their other checks, null pointers (a refused launch runs nothing)
LAUNCHERS = {"hist4096_launch": (3, (120, 160, 1, 0, 0)),
             "backproject_launch": (3, (120, 160, 0, 0, 0)),
             "backproject_rect_launch": (4, (120, 160, 64, 96, 0, 0, 0)),
             "histpdf_band_launch": (5, (120, 160, 64, 96, 1, 0, 0)),
             "hist_mma_launch": (4, (120, 160, 19, 1024, 0, 0)),
             "pyramid_launch": (9, (160, 120, 0, 1, 1, 0, 0, 0)),
             "cascade_dense_launch": (19, (1, 1)),
             "cascade_deep_launch": (20, (1, 1, 132))}


def frames(n, dev):
    """(n, 120, 160, 3) u8 on ``dev``: the bench pool's 256 streams
    (tick 1) tiled, each stream's first three pixels its index's bytes."""
    import numpy as np
    import torch
    from bench import build_pool
    pool = build_pool(256, *FRAME, 16, 4, np.random.default_rng(0))[1]
    out = torch.as_tensor(pool).to(dev).repeat(-(-n // 256), 1, 1, 1)[:n]
    idx = torch.arange(n, device=dev, dtype=torch.int64)
    for b in range(3):
        out[:, 0, b, :] = ((idx >> (8 * b)) & 255).to(torch.uint8)[:, None]
    return out.contiguous()


def _same(name, got, want, errs):
    """Record the largest |got - want| of one slice; raise unless 0."""
    import torch
    if got.dtype == torch.bool:
        got, want = got.int(), want.int()
    e = float((got.double() - want.double()).abs().max()) if got.numel() \
        else 0.0
    errs[name] = max(errs.get(name, 0.0), e)
    if not torch.equal(got, want):
        raise AssertionError(f"{name} differs from its twin (max |diff| "
                             f"{e})")


def check(n, dev):
    """Every case at n streams: {kernel: {"launches": this wrapper's
    launches, "chunks": its chunks, "max_abs_err": 0.0}}; raises on a
    difference or a launch count other than the chunks'."""
    import torch
    from headtrackr_tpu_torch.cascade import frontalface
    from headtrackr_tpu_torch.kernels import cascade as KC
    from headtrackr_tpu_torch.kernels import histpdf as K
    from headtrackr_tpu_torch.kernels import launch as L
    from headtrackr_tpu_torch.kernels.histbins import row_chunks
    from headtrackr_tpu_torch.kernels.histmma import hist_mma
    from headtrackr_tpu_torch.kernels.pyramid import pyramid
    from headtrackr_tpu_torch.models.detector import detector_tables
    from headtrackr_tpu_torch.ops import histogram as hg
    from headtrackr_tpu_torch.ops.detect import cascade_plain
    from headtrackr_tpu_torch.ops.imageproc import grayscale, pack_pyramid

    H, W = FRAME
    g = torch.Generator(device=dev).manual_seed(n)
    fr = frames(n, dev)
    rects = torch.cat([torch.randint(-20, W, (n, 2), generator=g, device=dev),
                       torch.randint(0, 100, (n, 2), generator=g,
                                     device=dev)], 1).int()
    model = torch.randint(1, 200, (n, 4096), generator=g,
                          device=dev).float()
    from headtrackr_tpu_torch.models import camshift as cs
    placed = cs.band_rects(*cs.band_rect(rects, BAND, FRAME))
    chunks = len(row_chunks(n))
    errs, counts = {}, {}

    def run(key, fn, per_chunk=1, extra=0):
        before = L.launches[key]
        out = fn()
        torch.cuda.synchronize()
        counts[key] = L.launches[key] - before
        if counts[key] != per_chunk * chunks + extra:
            raise AssertionError(f"{key}: {counts[key]} launches at {n} "
                                 f"streams, not {per_chunk} a chunk of "
                                 f"{chunks}")
        return out

    def slices(name, got, twin):
        for s in range(0, n, SLICE):
            want = twin(slice(s, s + SLICE))
            for a, b in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                _same(name, a[s:s + SLICE], b, errs)

    got = run("hist4096", lambda: K.hist4096(fr, rects))
    slices("hist4096", got, lambda s: hg.hist4096_plain(
        fr[s], rects[s]).float())
    got = run("histpdf_band_hist", lambda: K.histpdf_band(fr, rects))
    slices("histpdf_band_hist", got,
           lambda s: hg.histpdf_band_plain(fr[s], rects[s]))
    got = run("histpdf_band", lambda: K.histpdf_band(fr, rects, model, BAND))
    twin = {}

    def band_twin(s):
        twin[s.start] = hg.histpdf_band_plain(fr[s], placed[s], model[s],
                                              BAND)
        return twin[s.start]

    slices("histpdf_band", got, band_twin)
    del got
    # in place: the frames' address in a word, the buffer poisoned
    word = torch.tensor([fr.data_ptr()], dtype=torch.int64, device=dev)
    buf = torch.full_like(fr, 255)
    with L.frames_at(buf, word):
        got = run("histpdf_band", lambda: K.histpdf_band(buf, rects, model,
                                                         BAND))
    del buf
    slices("histpdf_band in place", got, lambda s: twin.pop(s.start))
    del got
    got = run("backproject", lambda: K.backproject(fr, model))
    slices("backproject", got,
           lambda s: hg.backproject_plain(fr[s], model[s]))
    del got
    got = run("backproject_rect", lambda: K.backproject(fr, model, rects,
                                                         BAND))
    slices("backproject_rect", got,
           lambda s: hg.backproject_plain(fr[s], model[s], placed[s], BAND))
    del got
    full = hg.full_rects(n, FRAME, dev)
    cur = run("hist4096", lambda: K.hist4096(fr))
    slices("hist4096 whole frame", cur,
           lambda s: hg.hist4096_plain(fr[s], full[s]).float())
    got = run("backproject_ratio", lambda: K.backproject_ratio(fr, model,
                                                                cur))
    slices("backproject_ratio", got, lambda s: hg.backproject_ratio_plain(
        fr[s], model[s], cur[s]))
    del got
    got = run("backproject_rect_ratio", lambda: K.backproject_ratio(
        fr, model, cur, rects, BAND))
    slices("backproject_rect_ratio", got,
           lambda s: hg.backproject_ratio_plain(fr[s], model[s], cur[s],
                                                placed[s], BAND))
    del got, model, placed, cur
    got = run("hist_mma", lambda: hist_mma(fr, rects))
    slices("hist_mma", got, lambda s: hg.hist_mma_plain(fr[s], rects[s]))
    del got
    buf = torch.full_like(fr, 255)
    with L.frames_at(buf, word):
        got = run("hist_mma", lambda: hist_mma(buf))
    del buf
    slices("hist_mma in place", got,
           lambda s: hg.hist_mma_plain(fr[s], full[s]))
    del got
    tables = detector_tables(W, H, frontalface(), 5, device=dev)
    gray = grayscale(fr)
    del fr
    planes = run("pyramid", lambda: pyramid(gray, tables))
    slices("pyramid", planes, lambda s: pack_pyramid(
        gray[s], tables.spec.interval, tables.plane_keys,
        tables.geom_levels))
    del gray
    deep = len(tables.stages) > len(tables.dense.ends)
    got = run("cascade", lambda: KC.cascade(planes, tables, 256),
              per_chunk=1 + deep, extra=1)
    keys = ("x", "y", "width", "height", "confidence", "valid", "overflow")
    slices("cascade", tuple(got[k] for k in keys),
           lambda s: tuple(cascade_plain(planes[s], tables, 256)[k]
                           for k in keys))
    return {k: {"launches": counts[ALIAS.get(k, k)], "chunks": chunks,
                "max_abs_err": e} for k, e in errs.items()}


def program_check(n, dev, ticks=20, scan_k=2):
    """``step_auto`` and ``run_scan`` past 65,535 streams: a
    BatchedTracker of n streams of 160x120 (the real cascade, bucket 8,
    no band at this size) from init_state over ``ticks`` ticks of the
    bench pool's batches tiled over n (the cold start's wbtrack and full
    ticks, then all-CS ticks; the last ``scan_k`` as one run_scan), its
    serving program against the per-tick path run eagerly on the card:
    every StepOutput leaf of every tick and the final state bit for bit,
    one program launch a call.  Returns {"ms_per_tick": the program's host
    ms a tick, "runs": its body runs, "locked": streams in CS at the end,
    "launches": the kernels' launches in the program's calls alone}."""
    import time
    import numpy as np
    import torch
    from bench import build_pool
    from headtrackr_tpu_torch import BatchedTracker
    from headtrackr_tpu_torch.kernels import launch as L
    from headtrackr_tpu_torch.models import facetracker as ft
    pool = torch.as_tensor(build_pool(256, *FRAME, 16, 4,
                                      np.random.default_rng(0))).to(dev)
    order = [0] * 16 + [1 + t % 7 for t in range(ticks - 16)]

    def tick(t):
        return pool[order[t]].repeat(-(-n // 256), 1, 1, 1)[:n]

    prog, ref = (BatchedTracker(n, FRAME, device=dev, bucket=8)
                 for _ in range(2))
    ref._steps.scheduled = False
    prog.warmup(host_sched=False)
    program = prog._steps._programs[n]
    runs, host = np.zeros(16, int), 0.0
    counts = dict.fromkeys(L.launches, 0)
    for t in range(ticks - scan_k + 1):
        last = t == ticks - scan_k
        frames = (torch.stack([tick(t + j) for j in range(scan_k)]) if last
                  else tick(t))
        before = program.launches
        torch.cuda.synchronize()
        was = dict(L.launches)
        t0 = time.perf_counter()
        got = prog.run_scan(frames) if last else prog.step_auto(frames)
        host += time.perf_counter() - t0
        for k in counts:
            counts[k] += L.launches[k] - was[k]
        runs += np.array(program.runs)
        if program.launches != before + 1:
            raise AssertionError("a call is not one program launch")
        want = ([ref.step_auto(f) for f in frames] if last
                else [ref.step_auto(frames)])
        for k, w in enumerate(want):
            for name, a, b in zip(ft.StepOutput._fields, got, w):
                a = a[k] if last else a
                if not torch.equal(a, b):
                    raise AssertionError(f"{n} streams, tick {t + k}: "
                                         f"{name} differs from the per-tick "
                                         f"path")
        del frames, got, want
    for a, b in zip(_leaves(prog.state), _leaves(ref.state)):
        if not torch.equal(a, b):
            raise AssertionError(f"{n} streams: the final state differs")
    return {"ms_per_tick": 1e3 * host / ticks, "runs": runs.tolist(),
            "locked": int((prog.modes == ft.MODE_CS).sum()),
            "launches": counts}


def _leaves(tree):
    if isinstance(tree, tuple):
        return [t for v in tree for t in _leaves(v)]
    return [] if tree is None else [tree]


def refusals():
    """The launchers of LAUNCHERS that took one stream more than a launch
    takes (each should refuse it: ``kernels/launch.py`` ``launch`` then
    raises, and no wrapper falls back to a twin)."""
    import torch
    from headtrackr_tpu_torch.kernels.build import load_library
    from headtrackr_tpu_torch.kernels.histbins import MAX_ROWS
    lib = load_library()
    stream = torch.cuda.current_stream().cuda_stream
    took = [fn for fn, (before, after) in LAUNCHERS.items()
            if lib.fn(fn)(*([0] * before), MAX_ROWS + 1, *after, stream) == 0]
    torch.cuda.synchronize()
    return took


def main(argv=None):
    sys.path.insert(0, HERE)
    import torch
    argv = sys.argv[1:] if argv is None else argv
    dev = torch.device("cuda", 0)
    for n in [int(a) for a in argv] or NS:
        print(n, check(n, dev), flush=True)
    print(NS[-1], program_check(NS[-1], dev), flush=True)
    took = refusals()
    print(f"launchers that took {NS[1]} streams: {took}")
    return 1 if took else 0


if __name__ == "__main__":
    sys.exit(main())
