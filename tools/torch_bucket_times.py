"""The relock tick's bucket kernels ``frame_prep`` (K9), ``handoff`` (K7)
and ``slot_gather`` (S5) timed on the card in the checkout at ``--root``
(default: this one), so that two checkouts compare on one card
(tools/torch_compare.sh runs it for a parent checkout and this one in
turns).

The calls are chip_smoke.py ``bucket_workloads``' on the bench pool: the
relock tick's 8 slots (4 served, switching on their face boxes, the 96x128
audit) and the cold start's 256 streams (every stream switching, and
``frame_prep`` with the gray plane and without it); ``slot_gather`` of
the relock tick's 8 slots over a state of the headline's leaves, and
``gather escape``, the few escape body's gather: 8 slots, the last 3
streams and padding, every state leaf and the frames (one
``slot_gather`` launch under the escape's rule where the checkout has
it, else the few body's PyTorch gathers, ``tree_index`` and
``index_select``).  For each: CUDA events
over 20 eager wrapper calls, graph replay, an empty kernel at the
checkout's grid (its CTAs: the streams, times the launcher's split where
the checkout has one), and a digest of the outputs' bytes, so that the
turns can be seen to agree.  Where the checkout's ``frame_prep`` and
``handoff`` read their frames in place (``launch.frames_of``), each of
their calls also reads tick 2 of a 3-tick scan in place (through a device
word, a 255 buffer in the frames' place, as the serving program's bodies
call them) against the same call reading that tick directly: graph replay
ms in turns (direct, in place, in place, direct, twice) under
``in_place``, after a check that both give the same bytes.

    python3 tools/torch_bucket_times.py [--root build/parent]

Prints the card's name and power limit, then one JSON line.  Needs a CUDA
card.
"""

import argparse
import hashlib
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def digest(tree):
    """A short hash of the bytes of every tensor in a nested output."""
    import torch
    h = hashlib.sha256()

    def walk(t):
        if isinstance(t, (tuple, list)):
            for v in t:
                walk(v)
        elif t is not None:
            h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
                     .tobytes())
    walk(tree)
    return h.hexdigest()[:12]


def gathers(cs, state, idx, frames, dev):
    """slot_gather at the relock tick's slots, and the few escape body's
    gather (see the module docstring), timed as the kernels above."""
    import inspect
    import torch
    from headtrackr_tpu_torch.kernels import schedule
    from headtrackr_tpu_torch.models import facetracker as ft
    n = state.mode.shape[0]
    rows = [t.nbytes // n for t in cs._leaves_of(state)]
    ctas = getattr(schedule, "gather_ctas", lambda rb: len(rb))
    eidx = torch.full((cs.SCHED_EB,), n, dtype=torch.int64)
    eidx[:cs.SCHED_ESCAPES[1]] = torch.arange(n - cs.SCHED_ESCAPES[1], n)
    eidx = eidx.to(dev)
    if "extra" in inspect.signature(schedule.slot_gather).parameters:
        def escape():
            got = schedule.slot_gather(state, eidx, True, (frames,))
            return got[0], got[2]
        egrid = cs.SCHED_EB * ctas(rows + [frames.nbytes // n])
    else:
        def escape():
            safe = torch.clamp(eidx, max=n - 1)
            return ft.tree_index(state, safe), frames.index_select(0, safe)
        egrid = None
    res = {}
    for name, fn, grid in (
            ("slot_gather", lambda: schedule.slot_gather(state, idx),
             idx.numel() * ctas(rows)),
            ("gather escape", escape, egrid)):
        res[name] = dict(events_ms=cs.cuda_ms(fn), graph_ms=cs.graph_ms(fn),
                         empty_ms=None if grid is None else cs.graph_ms(
                             lambda g=grid: cs.floor_launch(g)),
                         grid=grid, digest=digest(fn()))
        print(f"{name}: {res[name]}", flush=True)
    return res


def in_place(cs, fn, args, kw, tick, buf, word):
    """fn reading ``tick`` in place (``buf`` in its frames' place, under
    ``launch.frames_at(buf, word)``) against fn reading it directly:
    {"graph_ms": in place, "direct_graph_ms": direct}, in turns."""
    from headtrackr_tpu_torch.kernels import launch as L

    def direct():
        return fn(tick, *args[1:], **kw)

    def placed():
        with L.frames_at(buf, word):
            return fn(buf, *args[1:], **kw)

    if digest(placed()) != digest(direct()):
        raise SystemExit("in place and direct reads differ")
    ip, dr = [], []
    for _ in range(2):  # direct, in place, in place, direct
        dr.append(cs.graph_ms(direct))
        ip += [cs.graph_ms(placed), cs.graph_ms(placed)]
        dr.append(cs.graph_ms(direct))
    return {"graph_ms": ip, "direct_graph_ms": dr}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=HERE,
                   help="the checkout whose headtrackr_tpu_torch to time")
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_bucket_times: no CUDA device", file=sys.stderr)
        return 1
    cs = _load("chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    from bench import build_pool
    from headtrackr_tpu_torch.kernels import frameprep, handoff
    from headtrackr_tpu_torch.kernels.launch import sm_count

    print(cs.smi(), flush=True)
    dev = torch.device("cuda", 0)
    pick = getattr(frameprep, "pick_split", lambda n, sms=None: 1)
    pool = build_pool(cs.N_STREAMS, cs.H, cs.W, cs.POOL, cs.LOSS_STREAMS,
                      np.random.default_rng(0))
    calls, state, idx = cs.bucket_workloads(pool, dev)
    del pool
    wrapper = {"frame_prep": frameprep.frame_prep,
               "handoff": handoff.handoff}
    from headtrackr_tpu_torch.kernels import launch as L
    cases = _load("torch_bucket_cases_here",
                  os.path.join(HERE, "tools", "torch_bucket_cases.py"))
    frames = calls["frame_prep"][1][0]
    seq, word = cases.staged_scan(frames, 3, 2, 0)
    buf = torch.full_like(frames, 255)
    res = {}
    for name, (key, a, kw, n) in calls.items():
        fn = (lambda f=wrapper[key], a=a, kw=kw: f(*a, **kw))
        grid = n * pick(n, sm_count(dev))
        res[name] = dict(events_ms=cs.cuda_ms(fn), graph_ms=cs.graph_ms(fn),
                         empty_ms=cs.graph_ms(lambda g=grid:
                                              cs.floor_launch(g)),
                         grid=grid, digest=digest(fn()))
        if hasattr(L, "frames_of"):
            res[name]["in_place"] = in_place(cs, wrapper[key], a, kw, seq[2],
                                             buf, word)
        print(f"{name}: {res[name]}", flush=True)
    res.update(gathers(cs, state, idx, calls["frame_prep"][1][0], dev))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
