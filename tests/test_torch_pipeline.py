"""The slice as a whole: the port's BatchedTracker against the reference
package's BatchedTracker(band=None, bandHist=False, histKernel="pallas")
``step_auto`` on the lose-and-refind clip of tests/test_pipeline.py (the
second stream offset in time and space).  Every StepOutput field on every
tick: integer and bool fields exact, float fields to rtol 1e-5 / atol 1e-4
(f32 sums in another order).  The same clip through the port's serving
program (its CPU twin) with the bodies' frame buffer poisoned before each
call, through step_auto and run_scan: the all-CS ticks copy none of the
frames (the full-frame readers read them in place) and still equal the
reference.  Also the convert.py round trip, the config pin, and the
import boundary (no jax, no headtrackr_tpu)."""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import headtrackr_tpu as ht
import headtrackr_tpu_torch as pt
from headtrackr_tpu_torch import convert
from headtrackr_tpu_torch.models import facetracker as tft

torch.set_num_threads(2)

H, W = 120, 160
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frame(cx=None, cy=None, blue=False):
    if blue:
        f = np.zeros((H, W, 3), np.uint8)
        f[..., 2] = 250
        return f
    f = np.full((H, W, 3), 40, np.uint8)
    if cx is not None:
        f[cy - 12:cy + 12, cx - 12:cx + 12] = (230, 80, 60)
    return f


def _clip_track_lose_refind(dx=0, dy=0, lead=0):
    clip = [_frame(60 + dx, 50 + dy)] * (16 + lead)
    clip += [_frame(60 + dx + t, 50 + dy) for t in range(15)]
    clip += [_frame(blue=True)] * 3
    clip += [_frame(80 + dx, 60 + dy)] * (10 - lead)
    return clip


def _clip():
    return np.stack([np.stack(_clip_track_lose_refind()),
                     np.stack(_clip_track_lose_refind(20, 10, 3))], axis=1)


@pytest.fixture(scope="module")
def runs():
    clip = _clip()
    jb = ht.BatchedTracker(2, (H, W), cascade=ht.toy_cascade(), band=None,
                           bandHist=False, histKernel="pallas")
    tb = pt.BatchedTracker(2, (H, W), cascade=pt.toy_cascade(), device="cpu")
    rows = []
    for t, frames in enumerate(clip):
        out_j = jb.step_auto(frames)
        out_t = tb.step_auto(frames)
        rows.append(([np.asarray(v) for v in out_j],
                     [v.numpy() for v in out_t]))
        if t == 20:
            states = ([np.asarray(x) for x in
                       jax.tree_util.tree_leaves(jb.state)],
                      convert.state_to_numpy(tb.state), jb.state)
    return rows, states


def test_step_outputs_match_reference_every_tick(runs):
    rows, _ = runs
    assert ht.models.facetracker.StepOutput._fields == tft.StepOutput._fields
    for t, (ref, got) in enumerate(rows):
        for name, a, b in zip(tft.StepOutput._fields, ref, got):
            a = np.broadcast_to(a, b.shape)
            if a.dtype.kind in "biu":
                np.testing.assert_array_equal(b, a, err_msg=f"tick {t} {name}")
            else:
                np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-4,
                                           err_msg=f"tick {t} {name}")
    status = np.stack([r[1][tft.StepOutput._fields.index("status")]
                       for r in rows])
    for s in range(2):  # the lifecycle happened on both streams
        bits = np.bitwise_or.reduce(status[:, s])
        assert bits & tft.STATUS_REDETECTING and bits & tft.STATUS_FOUND


@pytest.mark.parametrize("entry", ["step_auto", "run_scan"])
def test_program_reads_frames_in_place_every_tick(runs, entry):
    """The full-frame configuration's serving program (``scheduled``: the
    bodies uncaptured, the kernels' twins) over the clip, the bodies'
    frame buffer filled with 255 before each call (run_scan: chunks of
    8): every StepOutput field on every tick equals the reference's
    step_auto; no tick copies a frame (the buffer stays 255 through the
    wbtrack, bucket and all-CS ticks, which read the tick's frames in
    place), and all-CS ticks ran."""
    rows, _ = runs
    clip = _clip()
    tb = pt.BatchedTracker(2, (H, W), cascade=pt.toy_cascade(), device="cpu")
    tb._steps.scheduled = True
    bufs = tb._steps.buffers(tb.state)
    got, copies, allcs = [], 0, 0  # copies: calls that wrote the buffer
    for k0 in range(0, len(clip), 1 if entry == "step_auto" else 8):
        bufs.frames.fill_(255)
        if entry == "step_auto":
            outs = [tb.step_auto(clip[k0])]
        else:
            part = tb.run_scan(torch.as_tensor(clip[k0:k0 + 8]))
            outs = [[v[k] for v in part] for k in range(part[0].shape[0])]
        prog = tb._steps.program(tb.state)
        copies += not bool((bufs.frames == 255).all())
        allcs += prog.runs[0]
        got += [[v.numpy() for v in o] for o in outs]
    assert len(got) == len(rows)
    for t, ((ref, _), out) in enumerate(zip(rows, got)):
        for name, a, b in zip(tft.StepOutput._fields, ref, out):
            a = np.broadcast_to(a, b.shape)
            if a.dtype.kind in "biu":
                np.testing.assert_array_equal(b, a, err_msg=f"tick {t} {name}")
            else:
                np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-4,
                                           err_msg=f"tick {t} {name}")
    assert allcs > 0 and copies == 0


def test_convert_round_trip(runs):
    _, (ref_leaves, port_leaves, ref_state) = runs
    assert len(ref_leaves) == convert.N_LEAVES == len(port_leaves)
    for a, b in zip(ref_leaves, port_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-4)
    back = convert.state_to_numpy(convert.state_from_numpy(ref_leaves, device="cpu"))
    for a, b in zip(ref_leaves, back):
        np.testing.assert_array_equal(a, b)
    # the port's leaves rebuild the reference pytree
    tree = jax.tree_util.tree_structure(ref_state)
    rebuilt = jax.tree_util.tree_unflatten(tree, port_leaves)
    assert int(np.asarray(rebuilt.mode).sum()) == int(
        np.asarray(ref_state.mode).sum())


def test_config_pinned_to_reference():
    ref = {f.name: f.default for f in
           dataclasses.fields(ht.config.TrackerConfig)}
    mine = {f.name: f.default for f in dataclasses.fields(pt.TrackerConfig)}
    assert mine == ref
    assert pt.TrackerConfig().smoothingInterval == \
        ht.TrackerConfig().smoothingInterval
    for n in (2, 32):  # including the n >= 32 capacity defaults
        cj = ht.BatchedTracker(n, (40, 40), cascade=ht.toy_cascade()).config
        ct = pt.BatchedTracker(n, (40, 40), cascade=pt.toy_cascade(),
                               device="cpu").config
        assert dataclasses.asdict(ct) == dataclasses.asdict(cj)


def test_import_boundary_no_jax():
    code = ("import sys; "
            "import headtrackr_tpu_torch; "
            "from headtrackr_tpu_torch import convert, device; "
            "from headtrackr_tpu_torch.kernels import build, gather, histmma, "
            "histpdf, launch; "
            "from headtrackr_tpu_torch.models import camshift, facetracker; "
            "from headtrackr_tpu_torch.runtime import (checkpoint, events, "
            "fanout, host, serving, tracker, ui, video); "
            "from headtrackr_tpu_torch.utils import debugdraw; "
            "from headtrackr_tpu_torch.ops import gather, histogram; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'headtrackr_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
