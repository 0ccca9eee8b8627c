"""The nodes of every CUDA graph that a headline BatchedTracker (256
streams of 320x240, 96x128 band, bandHist, bucket 8) captures in warmup(),
in the checkout at ``--root`` (default: this one): the exact device
operations of each replayed tick, where torch.profiler's count of a
profiled tick can lose or gain an event.  tools/torch_compare.sh
runs it for the parent and this checkout:

    python3 tools/torch_graph_nodes.py [--root build/parent]

Prints the card's name and power limit, then one JSON line: each graph's
node kinds counted (kernel, memcpy, memset, ...) in capture order (in a
checkout with the serving program, its bodies: the all-CS tick, the bucket
at each slot count, wbtrack, full, the escape fallback's few and many; in
one without it, the all-CS tick, then the bucket and chunk ticks); then,
in a checkout whose program commits by tables, one JSON line of each
body's commit table (``commit_tables``: bytes and entries, in the
program's body order), and the nodes of the full-frame "track" step
alone on escape_bucket gathered rows (``few_track_step``: the escape
fallback's few body runs it after its gather) and the many escape body
(``many``: its graph's nodes by kernel name, those that are no
hand-written kernel's launch, its chunks of streams and its commit
tables, in a checkout with chunks a big and a small chunk's, else the
whole batch's); then one JSON line of the
all-CS body of the band and full-frame configurations (``all_cs``: its
nodes by kernel name, those that are no hand-written kernel's launch, and
the body's frame copy).  Needs a CUDA card; node_kinds, node_names,
foreign_nodes and graph_nodes come from this checkout's chip_smoke.py.
"""

import argparse
import collections
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def commit_tables(bt):
    """Each body's scan_commit table of ``bt``'s program (warmed up): bytes
    its entries move and its entry count, in the program's body order (the
    tick bodies, then few and many); None in a checkout without tables."""
    prog = bt._steps._programs.get(bt.n)
    ct = getattr(prog, "_commit", None)
    if ct is None:
        return None
    return [{"bytes": int(ct.segs[f:f + c, 2].sum()) if c else 0,
             "entries": c} for f, c, _, _ in ct.tables.tolist()]


def track_step_nodes(bt, cs):
    """The node kinds of the full-frame "track" step captured alone on the
    escape fallback's escape_bucket rows (gathered before the capture), as
    the few body runs it."""
    import torch
    from headtrackr_tpu_torch.models import facetracker as ft
    steps = bt._steps
    bufs = steps.buffers(bt.state)
    idx = torch.arange(steps.escape_bucket, device=bufs.state_in.mode.device)
    sub = ft.tree_index(bufs.state_in, idx)
    rows = torch.zeros((idx.numel(),) + tuple(bt.frame_shape) + (3,),
                       dtype=torch.uint8, device=idx.device)
    return dict(collections.Counter(cs.graph_nodes(
        lambda: steps._track_plain(sub, rows))))


def many_body(bt, cs, root):
    """The many escape body of ``bt``'s program (warmed up): its graph's
    nodes in order, kernels by name, the foreign ones, its chunks' streams
    (``chunk_rows``, big and small; None in a checkout whose many body
    runs on the whole batch) and its commit tables (the program's last
    two, or its last: the whole batch's)."""
    prog = bt._steps._programs.get(bt.n)
    many = getattr(prog, "many", None)
    if many is None or many.graph is None:
        return None
    tail = getattr(prog, "tail", None)
    tables = commit_tables(bt) or [None]
    return {"nodes": cs.node_names(many.graph),
            "foreign": cs.foreign_nodes(many.graph, root),
            "tail_nodes": None if tail is None else cs.node_names(tail.graph),
            "chunk_rows": [getattr(prog.bufs, "m", None),
                           getattr(prog.bufs, "ms", None)],
            "commit": tables[-2:] if tail is not None else tables[-1]}


def all_cs_bodies(cs, root):
    """The all-CS body of the band and full-frame configurations (256
    streams of 320x240, bucket 8): its graph's nodes in order, kernels by
    name (chip_smoke.py node_names), and those that are not a launch of a
    hand-written kernel of ``root`` (``foreign_nodes``)."""
    import torch
    from headtrackr_tpu_torch import BatchedTracker
    out = {}
    for name, kw in (("band", dict(band=(96, 128), bandHist=False)),
                     ("full-frame", dict(band=None, bandHist=False,
                                         histKernel="pallas"))):
        bt = BatchedTracker(256, (240, 320), device=torch.device("cuda", 0),
                            bucket=8, **kw)
        body = bt._steps.captured(bt.state, 0)
        out[name] = {"nodes": cs.node_names(body.graph),
                     "foreign": cs.foreign_nodes(body.graph, root),
                     "copy": bt._steps.copy_mode(0)}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=HERE,
                   help="the checkout whose headtrackr_tpu_torch to count")
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    if not torch.cuda.is_available():
        print("torch_graph_nodes: no CUDA device", file=sys.stderr)
        return 1
    graphs = []
    init = torch.cuda.CUDAGraph.__init__

    def keep(self, *a, **k):  # every graph keeps its cudaGraph_t
        init(self, *a, **{**k, "keep_graph": True})
        graphs.append(self)

    torch.cuda.CUDAGraph.__init__ = keep
    from headtrackr_tpu_torch import BatchedTracker
    bt = BatchedTracker(256, (240, 320), device=torch.device("cuda", 0),
                        band=(96, 128), bandHist=True, bucket=8)
    bt.warmup(scan_len=16)
    print(cs.smi())
    print(json.dumps([dict(collections.Counter(cs.node_kinds(g)))
                      for g in graphs]))
    print(json.dumps({"commit_tables": commit_tables(bt),
                      "few_track_step": track_step_nodes(bt, cs),
                      "many": many_body(bt, cs, args.root)}))
    print(json.dumps({"all_cs": all_cs_bodies(cs, args.root)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
