"""The ``tick_epilogue`` kernel (csrc/epilogue.cu) against its plain twin
(ops/epilogue.py) on one device: the cases that tests/test_torch_cuda.py
and chip_smoke.py share.

``inputs`` makes N streams' epilogue inputs from a seeded NumPy generator,
laid out as the serving step hands them over: the mean shift's window, its
moments as columns of one (N, 12) tensor and its zero-mass and escaped
flags as columns of one (N, 2) tensor (the kernel reads them in place), a
TrackerState and the branches' merged result.  The draws cover each
branch: every mode, zero-mass streams (NaN angle), lost streams (a zero
size; conf 0 and -10000 gates), first-found streams, head-diagonal rings
full and near the face's diagonal (the activation tick), faces at every
frame edge and corner (track_head's branches), tan_fov 0 (the guard),
band_dirty streams.  ``check`` runs every form (the finish alone, the
"track" step's end with and without the band's flags, the supervision
of the "full", "pending", "wbtrack" and "track" variants) under every
configuration of ``configs()`` (calcAngles, retryDetection, smoothing,
headPosition, fov 60 or estimated, edgecorrection: 64) through the
wrapper (the kernel for CUDA tensors) and through the twin, and raises
unless they are equal to the bit (NaN-equal) and pass the same leaves
through as the same tensors; then every form again under 8 of the
configurations with ``inputs(..., wide=True)``, where some inputs are
columns of wide tensors (rows more than 64 bytes apart: the kernel stages
those a word an element, the bools among them at every byte offset).
The kernel takes 32 streams a CTA, so the sizes at a CTA's edges (31, 32,
33, 63, 64, 65) check its last, partial CTA.

    python3 tools/torch_epilogue_cases.py [N ...]
        (default: 1 8 31 32 33 63 64 65 256 70000)
"""

import itertools
import os
import sys
from typing import NamedTuple

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NS = (1, 8, 31, 32, 33, 63, 64, 65, 256, 70000)
FRAME = (240, 320)
# the moments' columns in the mean shift's output (ops/meanshift.MOMENTS)
MOMENT_COLS = {"invM00": 6, "mu20": 9, "mu02": 10, "mu11": 11}


def configs(frame=FRAME):
    """Every Epilogue of the flag grid (sendEvents alternating), the
    default constants."""
    from headtrackr_tpu_torch.ops.epilogue import Epilogue
    out = []
    for j, (ca, rt, sm, hp, fov, ec) in enumerate(itertools.product(
            (False, True), (True, False), (True, False), (True, False),
            (None, 60.0), (True, False))):
        out.append(Epilogue(ca, rt, sm, hp, fov, ec, j % 2 == 0, 0.35, 11.5,
                            60.0, *frame))
    return out


class Inputs(NamedTuple):
    state: object        # TrackerState (band_dirty carried)
    win: object          # (N, 4) i32
    moments: dict        # mu20, mu02, mu11, invM00: columns of (N, 12)
    zero_mass: object    # (N,) bool, column 0 of (N, 2)
    escaped: object      # (N,) bool, column 1 of (N, 2)
    entry_mode: object   # (N,) i32
    res: object          # the merged result (x, y, w, h, angle, conf, wb)


class Result(NamedTuple):
    x: object
    y: object
    w: object
    h: object
    angle: object
    conf: object
    wb: object
    escaped: object


def inputs(n, dev, seed=0, frame=FRAME, wide=False):
    """N streams' epilogue inputs on ``dev`` (see the module's doc); with
    ``wide`` the result's fields, first_run, diag_n, tan_fov and the
    camshift state's track_x are columns of wider tensors."""
    import numpy as np
    import torch
    from headtrackr_tpu_torch.models import camshift as tcs
    from headtrackr_tpu_torch.models import facetracker as tft
    H, W = frame
    rng = np.random.default_rng(seed)
    f32, i32 = np.float32, np.int32

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a, dtype)).to(dev)

    mode = rng.choice(3, n, p=(0.15, 0.15, 0.7)).astype(i32)
    # the mean shift's window: sizes 0..150 (some 0), anywhere and past
    # each edge
    win = np.stack([rng.integers(-20, W + 10, n), rng.integers(-20, H + 10, n),
                    rng.integers(0, 151, n), rng.integers(0, 151, n)], 1)
    win[rng.random(n) < 0.05, 2] = 0
    # moments: variances up to 40^2 px^2 over a mass M, a correlation;
    # some variances negative (rounding) or zero
    mass = rng.uniform(1.0, 5000.0, n).astype(f32)
    vx = rng.uniform(-5.0, 1600.0, n)
    vy = rng.uniform(-5.0, 1600.0, n)
    rho = rng.uniform(-1.0, 1.0, n)
    mom = np.zeros((n, 12), f32)
    mom[:, MOMENT_COLS["invM00"]] = 1.0 / mass
    mom[:, MOMENT_COLS["mu20"]] = vx * mass
    mom[:, MOMENT_COLS["mu02"]] = vy * mass
    mom[:, MOMENT_COLS["mu11"]] = rho * np.sqrt(np.abs(vx * vy)) * mass
    flags = np.zeros((n, 2), bool)
    zero = rng.random(n) < 0.08
    flags[:, 0] = zero
    mom[zero, MOMENT_COLS["invM00"]] = np.inf  # 1 / 0, moments 0: NaN
    mom[zero, MOMENT_COLS["mu20"]:] = 0.0
    flags[:, 1] = rng.random(n) < 0.1
    # the merged result: face centers anywhere (edges and corners within
    # the 11 px margin), sizes 0..150 px (0: lost), conf 1, 0 or -10000
    res = np.zeros((8, n), f32)
    res[0] = rng.integers(0, W + 1, n)
    res[1] = rng.integers(0, H + 1, n)
    res[2] = rng.integers(0, 151, n)
    res[3] = rng.integers(0, 151, n)
    res[2:4, rng.random(n) < 0.08] = 0.0
    res[4] = rng.uniform(0.0, np.pi, n)
    res[5] = rng.choice(np.asarray([1.0, 0.0, -10000.0, 3.5], f32), n,
                        p=(0.8, 0.08, 0.08, 0.04))
    res[6] = rng.uniform(0.0, 255.0, n)
    entry = np.where(rng.random(n) < 0.8, mode,
                     rng.choice(3, n)).astype(i32)
    # the supervision's state: rings full near the face's diagonal for
    # half the streams (the activation tick), the rest anywhere
    diag = np.sqrt(res[2] ** 2 + res[3] ** 2)
    near = rng.random(n) < 0.5
    ring = np.where(near[:, None], diag[:, None]
                    + rng.uniform(-2.0, 2.0, (n, 6)),
                    rng.uniform(0.0, 200.0, (n, 6))).astype(f32)
    diag_n = np.where(near, 6, rng.integers(0, 7, n)).astype(i32)
    sm_sp = (res[[0, 1, 2, 2, 3]].T
             + rng.uniform(-6.0, 6.0, (n, 5))).astype(f32)
    tan_fov = np.where(rng.random(n) < 0.3, 0.0,
                       rng.uniform(0.5, 1.6, n)).astype(f32)
    b = lambda p: t(rng.random(n) < p)  # noqa: E731
    state = tft.TrackerState(
        mode=t(mode), wb_ring=t(rng.uniform(0, 255, (n, 15)), f32),
        wb_n=t(rng.integers(0, 16, n), i32),
        cs=tcs.CamshiftState(
            # the epilogue passes the model histograms through unread
            model_hist=torch.zeros((n, 4096), device=dev),
            window=t(np.stack([rng.integers(0, W, n), rng.integers(0, H, n),
                               rng.integers(1, 120, n),
                               rng.integers(1, 120, n)], 1), i32),
            track_x=t(rng.integers(0, W, n), i32),
            track_y=t(rng.integers(0, H, n), i32),
            track_w=t(rng.integers(0, 120, n), i32),
            track_h=t(rng.integers(0, 120, n), i32),
            track_angle=t(rng.uniform(0, np.pi, n), f32),
            band_dirty=b(0.1)),
        sm_sp=t(sm_sp), sm_init=b(0.6), face_found=b(0.5),
        first_run=b(0.5), diag_ring=t(ring), diag_n=t(diag_n),
        headpose_active=b(0.4), tan_fov=t(tan_fov),
        fov_width=t(rng.uniform(0.5, 1.2, n), f32),
        head_diag_cam=t(diag * rng.uniform(0.8, 1.2, n), f32),
        stopped=b(0.1), pend_age=t(rng.integers(0, 4, n), i32))
    mom_t, flags_t = t(mom), t(flags)
    moments = {k: mom_t[:, c] for k, c in MOMENT_COLS.items()}
    r = t(res)
    fields = r[:7].unbind(0)
    if wide:
        def col(x, width, at):  # x as column ``at`` of an (n, width) tensor
            w = torch.zeros((n, width), dtype=x.dtype, device=dev)
            w[:, at] = x
            return w[:, at]
        fields = [col(v, 24, 3 + j) for j, v in enumerate(fields)]
        state = state._replace(
            first_run=col(state.first_run, 70, 5),
            diag_n=col(state.diag_n, 20, 1),
            tan_fov=col(state.tan_fov, 17, 16),
            cs=state.cs._replace(track_x=col(state.cs.track_x, 33, 2)))
    return Inputs(state, t(win, i32), moments, flags_t[:, 0], flags_t[:, 1],
                  t(entry), Result(*fields, escaped=flags_t[:, 1]))


def _passed(form, state, ep):
    """The leaves a form passes through: (name, getter)."""
    out = [("wb_ring", lambda s: s.wb_ring), ("wb_n", lambda s: s.wb_n),
           ("model_hist", lambda s: s.cs.model_hist),
           ("band_dirty", lambda s: s.cs.band_dirty),
           ("pend_age", lambda s: s.pend_age)]
    if form.startswith("supervise"):
        out.append(("cs", lambda s: s.cs))
    if ep.retry:
        out.append(("stopped", lambda s: s.stopped))
    if not ep.smoothing:
        out += [("sm_sp", lambda s: s.sm_sp), ("sm_init", lambda s: s.sm_init)]
    return out


FORMS = ("finish", "track band", "track frame", "supervise full",
         "supervise pending", "supervise wbtrack", "supervise track")


def routes():
    """{"kernel": the wrapper's functions, "twin": the twin's}, each a
    dict finish / track / supervise."""
    from headtrackr_tpu_torch.kernels import epilogue as K
    from headtrackr_tpu_torch.ops import epilogue as P
    return {"kernel": dict(finish=K.finish, track=K.track,
                           supervise=K.supervise),
            "twin": dict(finish=P.finish_plain, track=P.track_plain,
                         supervise=P.supervise_plain)}


def run(form, inp, ep, fns):
    """One form through ``fns`` (a ``routes()`` entry): (state' or None,
    [(name, tensor)] of every result)."""
    if form == "finish":
        got = fns["finish"](inp.win, inp.moments, inp.zero_mass, ep.calc_angles, ep.H,
                 ep.W)
        return None, list(zip(("window", "track_x", "track_y", "track_w",
                               "track_h", "track_angle"), got))
    if form.startswith("track"):
        band = form == "track band"
        state, out, esc = fns["track"](inp.state, inp.win, inp.moments, inp.zero_mass,
                             inp.escaped if band else None,
                             inp.state.cs.band_dirty if band else None, ep)
    else:
        variant = form.split()[1]
        escaped = inp.res.escaped if variant == "wbtrack" else None
        state, out, esc = fns["supervise"](inp.state, inp.entry_mode, inp.res, ep,
                             variant, escaped)
    # the leaves the step passes through are compared by identity (check)
    kept = {id(v) for v in _leaves(inp.state)}
    items = [(f"state {i}", v) for i, v in enumerate(_leaves(state))
             if id(v) not in kept]
    items += sorted(out.items())
    if esc is not None:
        items.append(("esc", esc))
    return state, items


def _leaves(tree):
    if isinstance(tree, tuple):
        return [t for v in tree for t in _leaves(v)]
    return [] if tree is None else [tree]


def same_bits(a, b):
    """Equal to the bit, NaN-equal (any NaN payload)."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        na, nb = torch.isnan(a), torch.isnan(b)
        return bool(torch.equal(na, nb) and torch.equal(
            torch.where(na, 0, a.view(torch.int32)),
            torch.where(nb, 0, b.view(torch.int32))))
    return bool(torch.equal(a, b))


def check(n, dev, seed=0):
    """Every form under every configuration, kernel wrapper against twin
    on ``dev``, then every form under 8 configurations on the wide inputs;
    raises on a difference.  Returns a summary: forms x configurations
    run, the wrapper's launches, and how many streams took each branch
    (activations, losses, NaN angles, escapes)."""
    import torch
    from headtrackr_tpu_torch.kernels import launch as L
    fns = routes()
    before = L.launches["tick_epilogue"]
    runs = 0
    seen = dict(activations=0, lost=0, nan_angles=0, escaped=0,
                head_valid=0)
    cases = [(inputs(n, dev, seed), configs()),
             (inputs(n, dev, seed + 1, wide=True), configs()[::8])]
    for inp, eps in cases:
        for ep, form in itertools.product(eps, FORMS):
            k_state, got = run(form, inp, ep, fns["kernel"])
            p_state, want = run(form, inp, ep, fns["twin"])
            if [k for k, _ in got] != [k for k, _ in want]:
                raise AssertionError(f"tick_epilogue {form}: fields differ "
                                     f"from the twin's")
            for (name, a), (_, b) in zip(got, want):
                if not same_bits(a, b):
                    raise AssertionError(
                        f"tick_epilogue differs from its twin: N={n}, "
                        f"{form}, {ep}, {name}")
            for st in (k_state, p_state):
                for name, get in (_passed(form, inp.state, ep)
                                  if st is not None else ()):
                    if get(st) is not get(inp.state):
                        raise AssertionError(f"tick_epilogue {form}: {name} "
                                             f"not passed through ({ep})")
            runs += 1
            w = dict(got)
            if "head_valid" in w:
                seen["head_valid"] += int(w["head_valid"].sum())
                seen["lost"] += int(((w["status"] & 24) != 0).sum())
                seen["activations"] += int(
                    (inp.state.first_run & ~k_state.first_run).sum())
            if "esc" in w:
                seen["escaped"] += int(w["esc"].sum())
            if "track_angle" in w:
                seen["nan_angles"] += int(torch.isnan(w["track_angle"]).sum())
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return dict(n=n, runs=runs,
                launches=L.launches["tick_epilogue"] - before, **seen)


def main(argv):
    import torch
    sys.path.insert(0, HERE)
    dev = torch.device("cuda", 0)
    for n in [int(a) for a in argv] or NS:
        print(check(n, dev), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
