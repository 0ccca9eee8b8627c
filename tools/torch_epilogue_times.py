"""The tick's own kernels timed on the card in the checkout at ``--root``
(default: this one), so that two checkouts compare on one card
(tools/torch_compare.sh runs it for a parent checkout and this one in
turns).

  tick_epilogue  the fused "track" form (tools/torch_epilogue_cases.py's
                 inputs: the mean shift's moments columns of one (N, 12)
                 tensor, its flags of one (N, 2) tensor; the headline's
                 configuration, bandHist and the 96x128 band) at 256 and
                 10,240 streams: CUDA events over 20 eager wrapper calls
                 (a call's host cost shows there), graph replay, and an
                 empty kernel at the checkout's grid for the kernel
                 (``tick_epilogue_floor_launch``, or in a checkout without
                 it the 256-thread CTAs a stream grid of
                 ``group_floor_launch``);
  histpdf_band,  the headline's band kernels at 256 streams of 240x320
  meanshift      (96x128 band): random frames with a face-colored block,
                 windows at and past the frame's edges.  A checkout whose
                 band kernels take band rects and origins gets them from
                 ``models/camshift.py`` ``band_rect``; one whose kernels
                 place the band gets the windows.  Events and graph replay;
                 the outputs' bytes are hashed so the turns can be seen to
                 agree.

    python3 tools/torch_epilogue_times.py [--root build/parent]

Prints the card's name and power limit, then one JSON line.  Needs a CUDA
card.
"""

import argparse
import hashlib
import importlib.util
import inspect
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NS = (256, 10240)
H, W, BAND = 240, 320, (96, 128)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:12]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=HERE,
                   help="the checkout whose headtrackr_tpu_torch to time")
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    global torch
    import torch
    if not torch.cuda.is_available():
        print("torch_epilogue_times: no CUDA device", file=sys.stderr)
        return 1
    cs_here = _load("chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    cases = _load("epilogue_cases_here",
                  os.path.join(HERE, "tools", "torch_epilogue_cases.py"))
    from headtrackr_tpu_torch import TrackerConfig
    from headtrackr_tpu_torch.kernels import epilogue as K
    from headtrackr_tpu_torch.kernels import histpdf as KH
    from headtrackr_tpu_torch.kernels import meanshift as kms
    from headtrackr_tpu_torch.kernels.build import load_library
    from headtrackr_tpu_torch.models import camshift as cs
    from headtrackr_tpu_torch.ops import epilogue as P

    print(cs_here.smi(), flush=True)
    dev = torch.device("cuda", 0)
    lib = load_library()
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    try:
        placed = lib.fn("tick_epilogue_floor_launch")
        floor = lambda n: placed(n, stream())  # noqa: E731
    except KeyError:
        group = lib.fn("group_floor_launch")
        floor = lambda n: group(-(-n // 256), stream())  # noqa: E731
    ep = P.epilogue_config(TrackerConfig(bandHist=True), (H, W))
    res = {}
    for n in NS:
        inp = cases.inputs(n, dev)
        a = (inp.state, inp.win, inp.moments, inp.zero_mass, inp.escaped,
             inp.state.cs.band_dirty, ep)
        got = K.track(*a)
        res[f"tick_epilogue n{n}"] = dict(
            events_ms=cs_here.cuda_ms(lambda: K.track(*a)),
            graph_ms=cs_here.graph_ms(lambda: K.track(*a)),
            empty_ms=cs_here.graph_ms(lambda: floor(n)),
            digest=_digest([t for t in cases._leaves(got[0])
                            if t.dtype != torch.bool]))
        print(f"tick_epilogue n={n}: {res[f'tick_epilogue n{n}']}",
              flush=True)

    g = torch.Generator().manual_seed(24)
    n = NS[0]
    fr = torch.randint(0, 256, (n, H, W, 3), generator=g, dtype=torch.uint8)
    fr[:, 60:180, 100:220] = torch.tensor([200, 80, 60], dtype=torch.uint8)
    fr = fr.to(dev)
    win = torch.stack([torch.randint(-30, W, (n,), generator=g),
                       torch.randint(-30, H, (n,), generator=g),
                       torch.randint(20, 90, (n,), generator=g),
                       torch.randint(20, 90, (n,), generator=g)],
                      1).int().to(dev)
    model = torch.randint(0, 200, (n, 4096), generator=g).float().to(dev)
    ry, rx, bh, bw = cs.band_rect(win, BAND, (H, W))
    origins = "ry" in inspect.signature(kms.mean_shift).parameters
    boxes = cs.band_rects(ry, rx, bh, bw) if origins else win
    pdf = KH.histpdf_band(fr, boxes, model, BAND)[1]
    ms_args = ((pdf, win, ry, rx, (H, W)) if origins
               else (pdf, win, (H, W)))
    out = kms.mean_shift(*ms_args)
    for name, fn, outs in (
            ("histpdf_band", lambda: KH.histpdf_band(fr, boxes, model, BAND),
             KH.histpdf_band(fr, boxes, model, BAND)),
            ("meanshift", lambda: kms.mean_shift(*ms_args),
             [out[0], *out[1].values(), out[2], out[3]])):
        res[name] = dict(events_ms=cs_here.cuda_ms(fn),
                         graph_ms=cs_here.graph_ms(fn), digest=_digest(outs))
        print(f"{name} n={n}: {res[name]}", flush=True)
    res["placed"] = not origins
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
