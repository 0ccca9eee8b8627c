"""Conformance of the PyTorch port on the card: face-box IoU and camshift-window
parity against the f64 NumPy oracle.

The counterpart of tools/verify_chip.py for headtrackr_tpu_torch.  It runs the
port with the real frontal-face cascade over synthetic clips (a still face for
the WB/VJ lock, then a +-2 px/tick ping-pong pan) and compares every camshift
frame against the port's copy of the oracle (headtrackr_tpu_torch.oracle):
exact window matches, the largest |delta| in px, and face-rect IoU (the
BASELINE gate is IoU >= 0.99; docs/PARITY.md deviation 10 allows 1 px).

Runs, at each size: the eager "full" step over the clip (``make_step``, one
stream, the reference tool's ``run_device``) and the device-scheduled
serving path (``BatchedTracker(1).run_scan``, band "auto", bucket 1) with
bandHist on and off.  The reference tool measures a fast and an exact
camshift arm; the port's pdf and mean shift are always exact (f32 in the
oracle's order), so each is a single arm here, gated as the exact arm.

Clip kinds (copies of tools/verify_chip.py's, not imports): the realistic
clip (+-3 LSB noise, gated exact) and the degenerate one (noise 0, gated on
mean IoU >= 0.99, the reference tool's documented worst case); the
hard clips (a lighting ramp; a blue bar occluding the face, which forces a
redetect), gated on full mode agreement and mean IoU >= 0.99; the clutter
gate (a crowd of faces: the port's detector, which keeps 256 candidate
slots a stream and none of the reference's tile and window caps, must
report no overflow, give the oracle's raw candidate set and find a face);
and the relock
gate (8 streams, three lose track at once and must relock within 3 ticks
and stay locked, bandHist on and off).

The clips read headtrackr_tpu/data/synthface.npz as data.  Nothing of jax or
of the JAX package is imported.

Run:  python3 tools/torch_verify_gpu.py [--frames 100] [--clips all]
          [--size 320x240,640x480] [--device cpu]
The card by default; ``--device cpu`` runs the kernels' plain twins.  Exits
nonzero on any failed gate.
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

_BG = (120, 100, 90)
SYNTHFACE = os.path.join(ROOT, "headtrackr_tpu", "data", "synthface.npz")
MODES = {"WB": 0, "VJ": 1, "CS": 2}


def _face():
    with np.load(SYNTHFACE) as d:
        return d["rgb"]


def _face_origin(size):
    H, W = size
    return (96, 80) if (H, W) == (240, 320) else \
        (4 * ((W // 3) // 4), 4 * ((H // 3) // 4))


def build_clip(n_track, noise=0, size=(240, 320)):
    """17 still frames (WB window + VJ lock) then a +-2 px/tick ping-pong pan.

    noise=k adds deterministic uniform +-k LSB sensor noise.  k=0 is the
    degenerate case: pixel-identical content translated in exact 2 px steps
    puts the camshift centroid on JS truncation boundaries, where f32-vs-f64
    rounding decides the result (docs/PARITY.md).  size=(H, W): 320x240
    keeps the reference tool's gate clip; at other sizes the face keeps its
    pixel size at the same relative position."""
    rgb = _face()
    fh, fw = rgb.shape[:2]
    H, W = size
    px, py = _face_origin(size)

    def fr(off):
        f = np.full((H, W, 3), _BG, np.uint8)
        f[py:py + fh, px + off:px + off + fw] = rgb
        return f

    half = n_track // 2
    offs = [2 * t for t in range(half)] + \
        [2 * (n_track - t) for t in range(half, n_track)]
    clip = np.stack([fr(0)] * 17 + [fr(o) for o in offs])
    if noise:
        rng = np.random.default_rng(7)
        d = rng.integers(-noise, noise + 1, clip.shape, dtype=np.int16)
        clip = np.clip(clip.astype(np.int16) + d, 0, 255).astype(np.uint8)
    return clip


def build_clip_hard(n_track, kind, size=(240, 320)):
    """Structured degradations.  kind="lighting": still face, global gain
    1.0 -> 0.75 -> 1.25 -> 1.0 over the tracked phase (+-3 LSB noise): the
    frame histogram drifts across the 4-bit bin boundaries while the model
    stays fixed.  kind="occlusion": the panning face with a 32 px blue
    (zero-weight) bar sweeping across it: graded mass loss, then total loss
    -> redetect -> relock once the bar passes.  The bar starts 32 px left of
    the face's still position (x = 64 at 320x240, as the reference tool)."""
    clip = build_clip(n_track, noise=3, size=size)
    if kind == "lighting":
        base = build_clip(n_track, noise=0, size=size)
        gains = np.concatenate([
            np.ones(17),
            np.linspace(1.0, 0.75, n_track // 3),
            np.linspace(0.75, 1.25, n_track // 3),
            np.linspace(1.25, 1.0, n_track - 2 * (n_track // 3))])
        rng = np.random.default_rng(7)
        d = rng.integers(-3, 4, base.shape, dtype=np.int16)
        return np.clip(base.astype(np.float32) * gains[:, None, None, None]
                       + d, 0, 255).astype(np.uint8)
    assert kind == "occlusion"
    px = _face_origin(size)[0]
    t0 = 17 + n_track // 4
    for i, bar_x in enumerate(range(px - 32, px + 80, 8)):
        t = t0 + i
        if t >= len(clip):
            break
        clip[t][:, bar_x:bar_x + 32] = (0, 0, 250)
    return clip


def build_crowd(rows=3, cols=5, size=(240, 320)):
    """Adversarial clutter: a grid of synthface instances plus one 48 px
    upsample; every face is a genuine cascade preimage, so stage-1/2
    survivors are dense across tiles and scales."""
    face = _face()
    h, w = size
    f = np.full((h, w, 3), _BG, np.uint8)
    ys = np.linspace(8, h - 40, rows).astype(int) & ~1
    xs = np.linspace(8, w - 40, cols).astype(int) & ~1
    for y in ys:
        for x in xs:
            f[y:y + 24, x:x + 24] = face
    if h >= 160 and w >= 200:
        face2 = np.repeat(np.repeat(face, 2, 0), 2, 1)
        f[h - 80:h - 32, w - 88:w - 40] = face2
    return f


def iou(a, b):
    """a, b: (cx, cy, w, h) center boxes."""
    ax0, ay0 = a[0] - a[2] / 2, a[1] - a[3] / 2
    bx0, by0 = b[0] - b[2] / 2, b[1] - b[3] / 2
    ix = max(0.0, min(ax0 + a[2], bx0 + b[2]) - max(ax0, bx0))
    iy = max(0.0, min(ay0 + a[3], by0 + b[3]) - max(ay0, by0))
    inter = ix * iy
    union = a[2] * a[3] + b[2] * b[3] - inter
    return inter / union if union > 0 else (1.0 if inter == 0 else 0.0)


def run_oracle(clip):
    from headtrackr_tpu_torch.cascade import frontalface
    from headtrackr_tpu_torch.oracle.pipeline import HeadTracker

    H, W = clip.shape[1:3]
    o = HeadTracker(frontalface(), W, H, smoothing=False, head_position=False)
    rows = []
    for f in clip:
        o.step(f)
        t = dict(o.facetracker.cur_tracked)
        rows.append((t["detection"], t["x"], t["y"], t["width"], t["height"]))
    return rows


def _rows(out):
    """(detection, x, y, w, h) per tick of stream 0 of (K, N) StepOutput
    leaves."""
    cols = [getattr(out, k)[:, 0].cpu().numpy() for k in
            ("detection", "face_x", "face_y", "face_w", "face_h")]
    return list(zip(cols[0].tolist(), *(c.tolist() for c in cols[1:])))


def run_device(clip, device):
    """The eager "full" step over the clip at one stream."""
    import torch
    from headtrackr_tpu_torch import TrackerConfig
    from headtrackr_tpu_torch.cascade import frontalface
    from headtrackr_tpu_torch.models import facetracker as ft

    cfg = TrackerConfig(smoothing=False, headPosition=False)
    step = ft.make_step(frontalface(), cfg, clip.shape[1:3], "full",
                        device=device)
    state = ft.init_state(1, cfg.whitebalancing, device=device)
    frames = torch.as_tensor(clip).to(device)
    outs = []
    for k in range(len(clip)):
        state, out = step(state, frames[k:k + 1])
        outs.append(out)
    return _rows(ft.StepOutput(*(torch.stack(v) for v in zip(*outs))))


def run_serving(clip, device, band_hist):
    """The device-scheduled serving path at one stream: run_scan, band
    "auto", bucket 1."""
    from headtrackr_tpu_torch import BatchedTracker
    from headtrackr_tpu_torch.cascade import frontalface

    bt = BatchedTracker(1, clip.shape[1:3], cascade=frontalface(),
                        device=device, bucket=1, bandHist=band_hist,
                        smoothing=False,
                        headPosition=False)
    return _rows(bt.run_scan(clip[:, None]))


def run_relock_gate(clip, device, band_hist, log=print):
    """8 streams, three blue-framed at tick 25 (zero-mass loss): every
    stream locked before, the three relocked within 3 ticks through the
    bucket/chunk scheduler (bucket 2), and no flap after."""
    from headtrackr_tpu_torch import BatchedTracker
    from headtrackr_tpu_torch.cascade import frontalface

    N, loss_t = 8, 25
    frames = np.broadcast_to(clip[:, None], (len(clip), N) + clip.shape[1:]
                             ).copy()
    frames[loss_t, :3] = 0
    frames[loss_t, :3, ..., 2] = 250
    bt = BatchedTracker(N, clip.shape[1:3], cascade=frontalface(),
                        device=device, bucket=2, bandHist=band_hist,
                        smoothing=False,
                        headPosition=False)
    det = bt.run_scan(frames).detection.cpu().numpy()
    pre = bool((det[loss_t - 1] == 2).all())
    post = bool((det[loss_t + 3:] == 2).all())
    back = (det[loss_t:, :3] == 2).all(1)
    relock = int(np.argmax(back)) if back.any() else None
    log(f"serving relock gate (bandHist {band_hist}): pre-loss all CS: {pre} "
        f"| relock after {relock if relock is not None else 'NEVER'} ticks | "
        f"stable post-relock: {post}")
    return {"pre": pre, "post": post, "relock_ticks": relock,
            "ok": pre and post}


def compare(tag, oracle_rows, dev_rows, log=print):
    """Every frame's mode equal (else AssertionError); over the camshift
    frames: exact windows, the largest |delta| in px, IoU min and mean."""
    n = exact_n = 0
    worst = 0.0
    ious = []
    for t, (orow, drow) in enumerate(zip(oracle_rows, dev_rows)):
        assert MODES[orow[0]] == int(drow[0]), \
            f"{tag}: mode diverged at frame {t}: {orow[0]} vs {drow[0]}"
        if orow[0] != "CS":
            continue
        n += 1
        ob, db = np.asarray(orow[1:], float), np.asarray(drow[1:], float)
        d = np.abs(ob - db).max()
        worst = max(worst, d)
        exact_n += int(d == 0)
        ious.append(iou(ob, db))
    ious = np.asarray(ious)
    log(f"{tag}: {n} camshift frames | exact windows {exact_n}/{n} | "
        f"max |delta| {worst:.0f} px | IoU min {ious.min():.4f} "
        f"mean {ious.mean():.4f}")
    return {"cs_frames": n, "exact": exact_n, "max_delta_px": float(worst),
            "iou_min": float(ious.min()), "iou_mean": float(ious.mean())}


def compare_soft(tag, oracle_rows, dev_rows, log=print):
    """Hard-clip comparator: mode agreement over the ticks with a defined
    oracle mode (a loss tick reads the just-rebuilt facetracker, detection
    ""), IoU over the ticks where both track."""
    pairs = [(o, d) for o, d in zip(oracle_rows, dev_rows) if o[0] in MODES]
    agree = sum(int(int(d[0]) == MODES[o[0]]) for o, d in pairs)
    ious = [iou(np.asarray(o[1:], float), np.asarray(d[1:], float))
            for o, d in zip(oracle_rows, dev_rows)
            if o[0] == "CS" and int(d[0]) == 2]
    ious = np.asarray(ious) if ious else np.asarray([0.0])
    log(f"{tag}: mode agreement {agree}/{len(pairs)} | {len(ious)} common-CS "
        f"frames | IoU min {ious.min():.4f} mean {ious.mean():.4f}")
    return {"agreement": agree / len(pairs), "common_cs": len(ious),
            "iou_min": float(ious.min()), "iou_mean": float(ious.mean())}


def _arms(clip, device):
    """(tag, rows) of the full step and both serving arms."""
    return [("full step", run_device(clip, device)),
            ("serving bandHist", run_serving(clip, device, True)),
            ("serving", run_serving(clip, device, False))]


def run_default(frames, size, device, log=print):
    """The realistic and the degenerate clip.  Gate (realistic clip): at
    320x240 every arm bit-perfect (IoU min >= 0.999); at other sizes max
    |delta| <= 1 px (deviation 10) and mean IoU >= 0.999; the degenerate
    clip is reported, gated only on mode agreement and mean IoU >= 0.99."""
    res, ok = {}, True
    for label, noise in (("realistic", 3), ("degenerate", 0)):
        clip = build_clip(frames, noise=noise, size=size)
        oracle_rows = run_oracle(clip)
        log(f"--- {label} clip ({len(clip)} frames, {size[1]}x{size[0]}, "
            f"noise {noise})")
        for tag, rows in _arms(clip, device):
            r = compare(f"{label} {tag}", oracle_rows, rows, log)
            if noise == 0:
                r["ok"] = r["iou_mean"] >= 0.99
            elif size == (240, 320):
                r["ok"] = r["iou_min"] >= 0.999
            else:
                r["ok"] = r["max_delta_px"] <= 1.0 and r["iou_mean"] >= 0.999
            ok &= r["ok"]
            res[f"{label} {tag}"] = r
    return ok, res


def run_hard(frames, size, device, log=print):
    """The lighting ramp and the occlusion redetect: full mode agreement
    and mean IoU >= 0.99 on every arm."""
    res, ok = {}, True
    for kind in ("lighting", "occlusion"):
        clip = build_clip_hard(frames, kind, size)
        oracle_rows = run_oracle(clip)
        n_vj = sum(r[0] == "VJ" for r in oracle_rows)
        log(f"--- hard clip [{kind}] ({len(clip)} frames, {size[1]}x"
            f"{size[0]}; oracle: {n_vj} VJ ticks)")
        for tag, rows in _arms(clip, device):
            r = compare_soft(f"{kind} {tag}", oracle_rows, rows, log)
            r["ok"] = r["agreement"] == 1.0 and r["iou_mean"] >= 0.99
            ok &= r["ok"]
            res[f"{kind} {tag}"] = r
    return ok, res


def run_clutter(size, device, log=print):
    """The port's detector on the crowd frame: its raw candidate set equals
    the oracle's (to 1e-2 px and 5e-3 confidence, as the reference tool
    rounds), and detect_best finds a face.  The port's detector keeps 256
    candidate slots a stream and reports the survivors beyond them (0 on
    this frame); it has none of the reference's tile and window caps, so
    the reference tool's capped and starved arms have no counterpart
    here."""
    import torch
    from headtrackr_tpu_torch.cascade import frontalface
    from headtrackr_tpu_torch.models import detector as td
    from headtrackr_tpu_torch.oracle import detector as od
    from headtrackr_tpu_torch.oracle.imageproc import grayscale

    gray = np.asarray(grayscale(build_crowd(size=size)), np.uint8)
    bo = sorted((round(s["x"], 3), round(s["y"], 3), round(s["width"], 3),
                 round(s["confidence"], 3))
                for s in od.dense_scores(gray, frontalface()))
    H, W = size
    tables = td.detector_tables(W, H, frontalface(), 5, device)
    g = torch.as_tensor(gray).to(device)[None]
    cand = {k: v[0].cpu().numpy()
            for k, v in td.detect_candidates(g, tables).items()}
    overflow = int(cand.pop("overflow"))
    bj = sorted((round(float(cand["x"][i]), 3), round(float(cand["y"][i]), 3),
                 round(float(cand["width"][i]), 3),
                 round(float(cand["confidence"][i]), 3))
                for i in np.nonzero(cand["valid"])[0])
    found = bool(td.detect_best(g, tables)[0][0])

    def close(a, b):
        return (abs(a[0] - b[0]) < 1e-2 and abs(a[1] - b[1]) < 1e-2
                and abs(a[2] - b[2]) < 1e-2 and abs(a[3] - b[3]) < 5e-3)

    parity = (overflow == 0 and len(bj) == len(bo)
              and all(close(a, b) for a, b in zip(bj, bo)))
    log(f"--- clutter gate ({W}x{H} crowd frame): {len(bj)}/{len(bo)} "
        f"candidates | SET parity: {'exact' if parity else 'FAIL'} | "
        f"detect_best found: {found}")
    return parity and found, {"candidates": len(bj), "oracle": len(bo),
                              "set_parity": parity, "found": found}


def run_gate(frames=100, clips="default", sizes=((240, 320),), device=None,
             log=print):
    """Every gate of ``clips`` ("default", "hard", "clutter" or "all") at
    each (H, W) of ``sizes``.  Returns (ok, results by size and gate, with
    each gate's seconds)."""
    import torch
    from headtrackr_tpu_torch.device import resolve_device

    device = resolve_device(device)
    if device.type == "cuda":  # the parity contract has no room for TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    kinds = ("default", "hard", "clutter") if clips == "all" else (clips,)
    ok, results = True, {}
    for size in sizes:
        res = results[f"{size[1]}x{size[0]}"] = {}
        for kind in kinds:
            t0 = time.perf_counter()
            if kind == "default":
                k_ok, r = run_default(frames, size, device, log)
                relock = build_clip(frames, noise=3, size=size)
                for bh in (True, False):
                    g = run_relock_gate(relock, device, bh, log=log)
                    r[f"relock bandHist {bh}"] = g
                    k_ok &= g["ok"]
            elif kind == "hard":
                k_ok, r = run_hard(frames, size, device, log)
            else:
                k_ok, r = run_clutter(size, device, log)
            r = {"ok": bool(k_ok), "s": time.perf_counter() - t0, **r}
            res[kind] = r
            ok &= k_ok
            log(f"gate [{kind}] {size[1]}x{size[0]}: "
                f"{'PASS' if k_ok else 'FAIL'} ({r['s']:.1f} s)")
    return bool(ok), results


def _size(text):
    try:
        w, h = (int(v) for v in text.split("x"))
    except ValueError:
        raise SystemExit(f"--size must be WxH[,WxH...]; got {text!r}")
    return h, w


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=100,
                    help="tracked frames after the 17-frame lock")
    ap.add_argument("--clips", default="default",
                    choices=["default", "hard", "clutter", "all"])
    ap.add_argument("--size", default="320x240",
                    help="frame size(s) WxH, comma separated")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    sizes = [_size(s) for s in args.size.split(",")]
    ok, _ = run_gate(args.frames, args.clips, sizes, args.device)
    print(f"gate (realistic clip exact, hard clips in full mode agreement, "
          f"IoU >= 0.99, deviation 10's 1 px off 320x240, relock stable, "
          f"clutter set parity; the port's camshift has one exact arm): "
          f"{'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
