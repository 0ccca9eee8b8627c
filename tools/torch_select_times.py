"""Times of the serving program's select kernels (``tick_select``,
``escape_select``) and of ``scan_step`` on the card, in the checkout at
``--root`` (default: this one), so that two checkouts can be compared in
turns on one card (tools/torch_compare.sh runs it parent, change, change,
parent):

    python3 tools/torch_select_times.py [--root build/parent] [--copy]

At N = 256, 4,096, 10,240 and 65,536 streams (the headline's bucket 8,
chunk cap 32, escape bucket 8), on a bucket tick (4 streams pending in VJ;
3 escaped: the few body) and on an all-CS tick (none pending, none
escaped): each kernel's CUDA events ms (20 wrapper calls) and graph replay
ms; torch.topk over the keys (the reference's own selection), events and
graph ms; and, where the checkout's library has ``select_floor_launch``,
an empty kernel at the select's grid (graph ms).  A checkout whose selects
refuse N prints the refusal instead.  ``--copy``: ``scan_step`` against
``copy_`` of the same tick's frames (240x320) at 256 and 10,240 streams,
graph replay ms, alternated, 5 repetitions each; where the checkout's
``scan_step`` has a rows mode, also that mode on a bucket tick's 8 slots
(4 served, 4 padding) against ``index_copy_`` of the same rows.  Prints
the card's name and power limit, then one JSON line.  Needs a CUDA card.
The timers are the root's chip_smoke.cuda_ms and graph_ms.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NS = (256, 4096, 10240, 65536)
BUCKET, EB, PENDING, ESCAPED = 8, 8, 4, 3  # PENDING: also the rows served
H, W = 240, 320
COPY_NS = (256, 10240)
COPY_REPS = 5


def select_cases(n, dev, out):
    """out["<kernel> <n> <case>"] = {ms, graph_ms, topk_ms, topk_graph_ms,
    floor_graph_ms or absent}, or the refusal's text."""
    import torch
    from chip_smoke import cuda_ms, graph_ms
    from headtrackr_tpu_torch.kernels import schedule as S
    from headtrackr_tpu_torch.kernels.build import load_library
    try:
        floor = load_library().fn("select_floor_launch")
    except KeyError:
        floor = None  # a checkout from before the select grid
    cap = 4 * BUCKET
    for case, pending, escaped in (("bucket", PENDING, ESCAPED),
                                   ("steady", 0, 0)):
        mode = torch.full((n,), 2, dtype=torch.int32, device=dev)
        mode[:pending] = 1
        age = torch.zeros(n, dtype=torch.int32, device=dev)
        esc = torch.zeros(n, dtype=torch.bool, device=dev)
        esc[n - escaped:n] = escaped > 0
        params = torch.zeros(S.PARAM_WORDS, dtype=torch.int64, device=dev)
        idx = torch.empty(cap, dtype=torch.int64, device=dev)
        aout = torch.empty(n, dtype=torch.int32, device=dev)
        eidx = torch.empty(EB, dtype=torch.int64, device=dev)
        key = torch.where(mode != 2, 1 + age.long(), 0)
        flags = esc.int()
        runs = (("tick_select", cap,
                 lambda: S.tick_select(mode, age, BUCKET, cap, False, idx,
                                       aout, params),
                 lambda: torch.topk(key, cap)),
                ("escape_select", EB,
                 lambda: S.escape_select(esc, EB, eidx, params),
                 lambda: torch.topk(flags, EB)))
        for name, c, fn, lib in runs:
            label = f"{name} {n} {case}"
            try:
                fn()
            except (ValueError, RuntimeError) as e:
                out[label] = f"refused: {e}"
                continue
            t = {"ms": cuda_ms(fn), "graph_ms": graph_ms(fn),
                 "topk_ms": cuda_ms(lib), "topk_graph_ms": graph_ms(lib)}
            if floor is not None:
                def empty(c=c):
                    if floor(n, c, torch.cuda.current_stream().cuda_stream):
                        raise RuntimeError("select_floor_launch failed")
                t["floor_graph_ms"] = graph_ms(empty)
            out[label] = t


def copy_cases(dev, out):
    """scan_step and copy_ of one tick's frames into the same buffer,
    alternated, COPY_REPS each, at COPY_NS streams: out["scan_step <n>"]
    and out["copy_ <n>"] lists of graph ms; with a rows mode also
    out["scan_step rows <n>"] and out["index_copy_ <n>"].  One destination
    for both: a copy's rate on the card depended on where its destination
    lay (two buffers gave the same kernel times 0.8% apart)."""
    import torch
    from chip_smoke import graph_ms
    from headtrackr_tpu_torch.kernels import schedule as S
    rows_mode = hasattr(S, "P_FRAME_AT")  # else: tick k read at P_FRAMES
    for n in COPY_NS:
        seq = torch.randint(0, 256, (2, n, H, W, 3), dtype=torch.uint8,
                            device=dev)
        frames = torch.empty_like(seq[0])
        p = torch.zeros(S.PARAM_WORDS, dtype=torch.int64)
        p[S.P_K], p[S.P_TICKS], p[S.P_FRAMES] = 1, 2, seq.data_ptr()
        if rows_mode:
            p[S.P_FRAME_AT] = seq[1].data_ptr()
        p = p.to(dev)
        cases = [(f"scan_step {n}", lambda: S.scan_step(p, frames),
                  f"copy_ {n}", lambda: frames.copy_(seq[1]))]
        if rows_mode:
            slots = torch.tensor(list(range(PENDING)) + [n] * (BUCKET -
                                                               PENDING),
                                 dtype=torch.int64, device=dev)
            served = slots[:PENDING]
            cases.append((f"scan_step rows {n}",
                          lambda: S.scan_step(p, frames, slots),
                          f"index_copy_ {n}",
                          lambda: frames.index_copy_(
                              0, served, seq[1].index_select(0, served))))
        for name, step, lib_name, lib in cases:
            a, b = out.setdefault(name, []), out.setdefault(lib_name, [])
            for _ in range(COPY_REPS):
                a.append(graph_ms(step))
                b.append(graph_ms(lib))
            frames.zero_()
            step()
            torch.cuda.synchronize()
            want = seq[1] if "rows" not in name else torch.zeros_like(
                frames).index_copy_(0, served, seq[1].index_select(0, served))
            if not torch.equal(frames, want):
                raise AssertionError(f"{name} differs from {lib_name}")
        del seq, frames


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=HERE,
                   help="the checkout whose headtrackr_tpu_torch to time")
    p.add_argument("--copy", action="store_true",
                   help="also scan_step against copy_")
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    from chip_smoke import smi

    if not torch.cuda.is_available():
        print("torch_select_times: no CUDA device", file=sys.stderr)
        return 1
    print(smi())
    dev = torch.device("cuda", 0)
    out = {}
    for n in NS:
        select_cases(n, dev, out)
    if args.copy:
        copy_cases(dev, out)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
