"""``make_batched_steps`` and ``camshift_step``: the port against the
reference package on the same inputs.

The five functions of the port's ``make_batched_steps`` against the
reference ``BatchedTracker``'s ``_step_full``, ``_step_track``,
``_step_bucket``, ``_step_auto`` and ``_step_scan`` (histKernel="pallas",
interpret mode on the CPU), tick for tick over the clip of
tests/test_torch_serving_band.py: six streams at 120x160, the toy cascade,
a 64x96 band with bandHist, bucket 1 (chunk cap 4).  step_auto takes every
branch there (the all-WB cold start, whitebalance beside trackers, a full
tick, chunk and bucket ticks, a relock after a blue frame, all-tracking
ticks with the big face's escapes); step_full, step_track and step_bucket
run on the states of chosen ticks, step_scan over the last ticks.
(overload="rotate" is held against the reference in
tests/test_torch_rotate.py, beside the rotating BatchedTracker.)  Integer
and bool fields exact, floats to rtol 1e-5 / atol 1e-4 (f32 sums in
another order).  Also: donate=False leaves the caller's state untouched, a
2-shard CPU mesh equals the meshless steps bit for bit, ``camshift_step``
against ``jax.vmap`` of the reference's, and the bench protocol
(bench_torch.measure_serving against bench.measure_serving, on the same
reference tracker, whose programs are then compiled already)."""

import pathlib
import re
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import headtrackr_tpu as ht
import headtrackr_tpu_torch as pt
from headtrackr_tpu.models import camshift as jcs
from headtrackr_tpu_torch import TrackerConfig, convert, toy_cascade
from headtrackr_tpu_torch.models import camshift as tcs
from headtrackr_tpu_torch.models import facetracker as tft
from headtrackr_tpu_torch.parallel import stream_mesh
from headtrackr_tpu_torch.runtime import serving
from headtrackr_tpu_torch.runtime.serving import (make_batched_steps,
                                                  resolve_band,
                                                  wants_band_audit)

from test_torch_serving_band import BAND, H, N, W, _clip, _frame

ROOT = str(pathlib.Path(__file__).resolve().parent.parent)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)  # bench.py and bench_torch.py

torch.set_num_threads(2)

KW = dict(band=BAND, bucket=1)
CFG = dict(bandHist=True, histKernel="pallas")
SIDE_TICKS = (0, 14, 16, 17, 31, 32, 35)  # step_full/track/bucket states
POOL = 8  # step_scan's K, and the protocol test's pool and scan length
SCAN_FROM = len(_clip()) - POOL  # step_scan over the clip's last POOL ticks


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _assert_same(ref, got, where):
    assert len(ref) == len(got), where
    for i, (a, b) in enumerate(zip(ref, got)):
        b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
        a = np.broadcast_to(np.asarray(a), b.shape)
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=f"{where} leaf {i}")
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-4,
                                       err_msg=f"{where} leaf {i}")


def _assert_result(jres, tres, where):
    (js, jo), (ts, to) = jres, tres
    _assert_same(_leaves(jo), list(to), f"{where} out")
    _assert_same(_leaves(js), convert.state_to_numpy(ts), f"{where} state")


def _copy(jstate):
    return jax.tree_util.tree_map(jnp.copy, jstate)


def _port_state(config):
    return tft.init_state(N, config.whitebalancing,
                          band_audit=wants_band_audit(
                              config, resolve_band(BAND, (H, W))),
                          device="cpu")


def _steps(**kw):
    """The port's five steps on the CPU (or on ``mesh=``) and their config."""
    if "mesh" not in kw:
        kw.setdefault("device", "cpu")
    config = TrackerConfig(**CFG)
    return make_batched_steps(toy_cascade(), config, (H, W),
                              **dict(KW, **kw)), config


def _bucket_idx(modes):
    """The reference's (bucket,) index: the first non-CS stream, else N."""
    pend = np.nonzero(np.asarray(modes) != tft.MODE_CS)[0]
    return np.asarray([pend[0] if pend.size else N], np.int32)


@pytest.fixture(scope="module")
def reference():
    """The reference tracker's five step programs over the clip: per tick
    the entry state and step_auto's (state, out); on SIDE_TICKS also the
    other three on that entry state; step_scan from SCAN_FROM."""
    jb = ht.BatchedTracker(N, (H, W), cascade=ht.toy_cascade(), **KW, **CFG)
    clip = _clip()
    state, ticks = jb.state, []
    for t, frames in enumerate(clip):
        f = jnp.asarray(frames)
        row = {"entry": _leaves(state)}
        if t in SIDE_TICKS:
            idx = _bucket_idx(state.mode)
            row["full"] = jb._step_full(_copy(state), f)
            row["track"] = jb._step_track(_copy(state), f)
            row["bucket"] = (idx, jb._step_bucket(_copy(state), f,
                                                  jnp.asarray(idx)))
        if t == SCAN_FROM:
            row["scan"] = jb._step_scan(_copy(state),
                                        jnp.asarray(clip[SCAN_FROM:]))
        state, out = jb._step_auto(_copy(state), f)
        row["auto"] = (state, out)
        ticks.append(row)
    return clip, ticks, jb


def test_steps_match_reference_tick_for_tick(reference):
    clip, ticks, _ = reference
    (step_full, step_track, step_bucket, step_auto, step_scan), config = \
        _steps()
    state = _port_state(config)
    branch = pt.BatchedTracker(N, (H, W), cascade=toy_cascade(),
                               device="cpu", **KW, **CFG).branch
    branches = []
    for t, (frames, row) in enumerate(zip(clip, ticks)):
        _assert_same(row["entry"], convert.state_to_numpy(state),
                     f"tick {t} entry")
        branches.append(branch(state.mode.numpy()))
        if "full" in row:
            _assert_result(row["full"], step_full(state, frames),
                           f"tick {t} step_full")
            _assert_result(row["track"], step_track(state, frames),
                           f"tick {t} step_track")
            idx, want = row["bucket"]
            _assert_result(want, step_bucket(state, frames, idx),
                           f"tick {t} step_bucket {idx}")
        if "scan" in row:
            js, jo = row["scan"]
            ts, to = step_scan(state, clip[SCAN_FROM:])
            assert to.mode_after.shape == (len(clip) - SCAN_FROM, N)
            _assert_result((js, jo), (ts, to), f"tick {t} step_scan")
        state, out = step_auto(state, frames)
        _assert_result(row["auto"], (state, out), f"tick {t} step_auto")
    # the clip took every branch of the device scheduler, and escapes
    assert {"wbtrack", "full", "bucket", "track"} <= set(branches)
    esc = np.stack([np.asarray(r["auto"][1].escaped) for r in ticks])
    assert esc[-8:, 3].all()


def test_program_reads_every_tick_in_place_with_a_poisoned_buffer(
        reference):
    """The serving program's CPU twin (``scheduled``: the bodies
    uncaptured, the kernels' twins) over the clip, the bodies' frame
    buffer filled with 255 before each step_auto call: every tick's state
    and outputs equal the reference's step_auto, through the cold start's
    wbtrack ticks, a full tick (overload "full", more pending streams
    than chunk_cap), chunk and bucket ticks and all-CS ticks; and the
    buffer stays 255 (no body copies a frame into it)."""
    clip, ticks, _ = reference
    tb = pt.BatchedTracker(N, (H, W), cascade=toy_cascade(), device="cpu",
                           **KW, **CFG)
    tb._steps.scheduled = True
    bufs = tb._steps.buffers(tb.state)
    runs = np.zeros(16, int)
    for t, (frames, row) in enumerate(zip(clip, ticks)):
        bufs.frames.fill_(255)
        out = tb.step_auto(frames)
        _assert_result(row["auto"], (tb.state, out), f"tick {t}")
        assert bool((bufs.frames == 255).all()), f"tick {t}"
        runs += tb._steps.program(tb.state).runs
    keys = tb._steps.body_keys(N)
    ran = {keys[b] for b in range(len(keys)) if runs[b]}
    assert {0, "wbtrack", "full"} <= ran and ran & {1, 2, 3, 4}, ran
    assert tb._steps.chunk_cap(N) == 4


def test_donate_false_leaves_the_state_untouched():
    (s_full, s_track, s_bucket, s_auto, s_scan), config = _steps(
        donate=False)
    clip = _clip()
    state = _port_state(config)
    for t, frames in enumerate(clip[:20]):
        before = convert.state_to_numpy(state)
        for res in (s_full(state, frames), s_track(state, frames),
                    s_bucket(state, frames, _bucket_idx(state.mode)),
                    s_scan(state, clip[t:t + 2])):
            assert res[0] is not state
        new, _ = s_auto(state, frames)
        _assert_same(before, convert.state_to_numpy(state), f"tick {t}")
        state = new


def test_two_shard_cpu_mesh_is_bit_equal_to_meshless():
    """The five steps on two CPU shards of 3 streams against the meshless
    steps, every leaf of every tick bit for bit.  The bucket covers a
    shard, so neither takes the "full" branch (the reference's scheduling
    is per shard: a shard's chunk cap follows its own streams, and a
    "full" tick's full-frame camshift differs from the band's under
    bandHist, PARITY deviation 13)."""
    mesh = stream_mesh(["cpu"] * 2)
    (m_full, m_track, m_bucket, m_auto, m_scan), config = _steps(
        mesh=mesh, bucket=N)
    (full, track, bucket, auto, scan), _ = _steps(bucket=N)
    with pytest.raises(ValueError, match="mesh or device"):
        _steps(mesh=mesh, device="cpu")
    clip = _clip()
    a = b = _port_state(config)

    def same(x, y, where):
        for i, (p, q) in enumerate(zip(_flat(x), _flat(y))):
            np.testing.assert_array_equal(q, p, err_msg=f"{where} leaf {i}")

    for t, frames in enumerate(clip):
        if t in SIDE_TICKS:
            idx = _bucket_idx(a.mode)
            same(full(a, frames), m_full(b, frames), f"tick {t} full")
            same(track(a, frames), m_track(b, frames), f"tick {t} track")
            same(bucket(a, frames, idx), m_bucket(b, frames, idx),
                 f"tick {t} bucket")
        a, oa = auto(a, frames)
        b, ob = m_auto(b, frames)
        same((a, oa), (b, ob), f"tick {t} auto")
    same(scan(a, clip[:3]), m_scan(b, clip[:3]), "scan")


def _flat(tree):
    if isinstance(tree, tuple):
        return [x for v in tree for x in _flat(v)]
    return [] if tree is None else [tree.numpy()]


def test_camshift_step_matches_reference_vmap(rng):
    """camshift_step on 4 streams of 48x64 frames (a sheared blob drifting
    over noise, its bounding box the initial window; one stream's box
    partly off its blob) for three steps,
    against jax.vmap of the reference's camshift_step: windows and sizes
    exact, floats to 1e-5 / 1e-4.  The shear keeps the blobs' second
    moments far from a square's, where the angle is ill-conditioned
    (F11)."""
    n, h, w = 4, 48, 64
    rects = np.asarray([[8, 8, 12, 20], [26, 20, 22, 12], [4, 4, 14, 10],
                        [36, 22, 10, 18]], np.int32)

    def frames_at(t):
        f = rng.integers(0, 60, (n, h, w, 3)).astype(np.uint8)
        for s, (x, y, rw, rh) in enumerate(rects):
            x0 = x + t + (3 if s == 2 else 0)
            for r in range(rh):  # each row one pixel right of the last
                f[s, y + t + r, x0 + r:x0 + r + rw] = (220, 90, 40 + 30 * s)
        return f

    f0 = frames_at(0)
    boxes = rects + np.asarray([0, 0, 1, 0], np.int32) * rects[:, 3:]
    jstate = jax.vmap(jcs.init_tracker)(jnp.asarray(f0), jnp.asarray(boxes))
    tstate = tcs.init_tracker(torch.as_tensor(f0), torch.as_tensor(boxes))
    jstep = jax.jit(jax.vmap(jcs.camshift_step, in_axes=(0, 0)))
    for t in (1, 2, 3):
        f = frames_at(t)
        jstate = jstep(jstate, jnp.asarray(f))
        tstate = tcs.camshift_step(tstate, torch.as_tensor(f), exact=True)
        ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate)]
        got = [x.numpy() for x in tstate if x is not None]
        _assert_same(ref, got, f"step {t}")
    assert (tstate.track_w > 0).all()
    assert tcs.camshift_step in (getattr(tcs, k) for k in tcs.__all__)
    assert serving.make_batched_steps in (getattr(serving, k)
                                          for k in serving.__all__)


def _pool():
    """POOL batches of the clip's faces drifting (from tick 16, past every
    whitebalance wobble); stream 0 sees a blue frame at POOL // 2."""
    pool = np.stack([np.stack([_frame(s, 16 + t) for s in range(N)])
                     for t in range(POOL)])
    pool[POOL // 2, 0] = (0, 0, 250)
    return pool


def _reference_counts(err):
    """bench.measure_serving's counts, from the lines it prints."""
    lock = re.search(r"([\d.]+)% locked", err)
    steady = re.search(r"steady state: (\d+) ticks .*?; (\d+) losses, "
                       r"(\d+) relocks in timed region; (\d+)% tracking", err)
    esc = re.search(r"fallback .*?: ([\d.]+) streams/tick mean, (\d+) max, "
                    r"(\d+) stream-ticks", err)
    return {"locked": float(lock[1]), "ticks": int(steady[1]),
            "redetects": int(steady[2]), "relocks": int(steady[3]),
            "tracking": int(steady[4]), "escapes_mean": float(esc[1]),
            "escapes_max": int(esc[2]), "escapes": int(esc[3])}


def test_bench_protocol_counts_match_reference(reference, capsys):
    """bench_torch.measure_serving on the port's tracker against
    bench.measure_serving on the reference's (the fixture's tracker, its
    step_auto and its K = POOL scan compiled already), on one pool of the
    toy-cascade faces with a loss frame: the same lock %, ticks,
    redetects, relocks, tracking % and escapes."""
    import bench
    import bench_torch
    from headtrackr_tpu.models import facetracker as jft
    jb = reference[2]
    jb.reset()
    pool = _pool()
    bench.measure_serving(jb, jnp.asarray(pool), POOL, 2 * POOL, jft)
    want = _reference_counts(capsys.readouterr().err)
    tb = pt.BatchedTracker(N, (H, W), cascade=toy_cascade(), device="cpu",
                           **KW, **CFG)
    got = bench_torch.measure_serving(tb, torch.as_tensor(pool), POOL,
                                      2 * POOL)
    assert want["ticks"] == got["ticks"] == 2 * POOL
    assert want["locked"] == round(100 * got["locked"], 1) == 100.0
    assert want["tracking"] == round(100 * got["tracking"])
    for k in ("redetects", "relocks", "escapes", "escapes_max"):
        assert got[k] == want[k], k
    assert round(got["escapes_mean"], 2) == want["escapes_mean"]
    assert got["relocks"] > 0 and got["escapes"] > 0
