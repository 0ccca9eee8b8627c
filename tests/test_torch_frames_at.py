"""The relock and cold-start frame kernels read a tick's frames in place, on
the CPU through their plain twins, against the JAX package on that tick's
frames.

Under ``launch.frames_at(buffer, source)`` (the serving program's bodies
run so: on the card ``source`` is the word that tick_select sets to tick
k's address, on the CPU tick k's frames) ``frame_prep`` (K9) and
``handoff`` (K7) read ``source``, never the buffer, which is filled with
255 here; tick k of a three-tick scan (k != 0), over every stream and
through slots padded with N:

  * ``frame_prep`` against the reference's ``grayscale`` (exact),
    ``whitebalance`` (rtol 1e-6: the reference's f32 mean against the
    port's exact sums) and its WB branch (the "wbtrack" step: the ring,
    wb_n and the new mode, exact but the ring's new value at rtol 1e-6);
  * ``handoff`` in its init form against ``jax.vmap`` of the reference's
    ``camshift.init_tracker`` with the handoff audit
    (``handoff_band_audit``): histograms, windows and band_dirty
    bit-exact, on rects of faces, past the frame's edges and empty, one
    tick's frames holding a model-colored pixel outside the band.

Frames 48x64 from a seeded NumPy generator, the toy cascade.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from headtrackr_tpu.cascade import toy_cascade as jtoy
from headtrackr_tpu.config import TrackerConfig as JConfig
from headtrackr_tpu.models import facetracker as jft
from headtrackr_tpu.ops import imageproc as jip
from headtrackr_tpu_torch.kernels import launch as L
from headtrackr_tpu_torch.kernels.frameprep import frame_prep
from headtrackr_tpu_torch.kernels.handoff import handoff

from test_torch_handoff import (BAND, BOX, FACE, H, W, _assert_leaves,
                                _faces, _noise, _reference_init)

torch.set_num_threads(2)

N, K = 7, 3
SLOTS = {"every stream": None, "slots": [5, 0, 3, N, 6, N]}


def _safe(slots):
    return None if slots is None else np.minimum(slots, N - 1)


def _scan(seed):
    """K ticks of N streams: faces on noise, each tick's face a pixel
    further right, tick 2's stream 3 with a model-colored pixel outside
    the face's band (its audit flags it)."""
    seq = np.stack([np.roll(_faces(N, seed + k), k, axis=2)
                    for k in range(K)])
    seq[2, 3, 40, 60] = FACE
    return seq


@pytest.fixture(scope="module")
def wbtrack():
    """The reference's wbtrack step over a batch (its WB branch)."""
    step = jft.make_step(jtoy(), JConfig(), (H, W), "wbtrack")
    return jax.jit(jax.vmap(step))


def _in_place(fn, seq, k):
    """fn(buffer) under frames_at(buffer, tick k's frames), the buffer
    filled with 255; the buffer is left as it was."""
    buf = torch.full((N, H, W, 3), 255, dtype=torch.uint8)
    with L.frames_at(buf, torch.from_numpy(seq[k])):
        got = fn(buf)
    assert bool((buf == 255).all())
    return got


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("where", list(SLOTS))
def test_frame_prep_reads_tick_k_in_place(wbtrack, where, k):
    """frame_prep under frames_at: the gray plane exact, the whitebalance
    to rtol 1e-6, and the WB branch's ring, wb_n and mode of the streams
    entering in WB as the reference's wbtrack step on tick k's frames; a
    VJ or CS stream keeps its rows."""
    seq = _scan(10)
    slots = SLOTS[where]
    rows = np.arange(N) if slots is None else _safe(slots)
    s = len(rows)
    rng = np.random.default_rng(k)
    own = np.asarray(jip.whitebalance(jnp.asarray(seq[k])))[rows]
    spread = np.where(np.arange(s) % 2 == 0, 0.5, 3.0)[:, None]
    ring = (own[:, None] + spread * rng.uniform(-1, 1, (s, 15))) \
        .astype(np.float32)
    wb_n = np.full(s, 14, np.int32)  # the ring full after this push
    wb_n[1] = 13
    mode = np.array([0, 0, 1, 0, 2, 0, 0][:s], np.int32)
    t = torch.from_numpy
    got = _in_place(lambda buf: frame_prep(
        buf, None if slots is None else torch.tensor(slots), t(mode),
        t(ring), t(wb_n)), seq, k)
    gray, wb, ring2, n2, mode2 = (v.numpy() for v in got)
    frames = seq[k][rows]
    np.testing.assert_array_equal(gray, np.asarray(jip.grayscale(frames)))
    np.testing.assert_allclose(wb[mode == 0], np.asarray(
        jip.whitebalance(jnp.asarray(frames)))[mode == 0], rtol=1e-6)
    js1 = jft.init_state()
    jst = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (s,) + x.shape).copy(), js1)
    jst = jst._replace(wb_ring=jnp.asarray(ring), wb_n=jnp.asarray(wb_n))
    jnew, _ = wbtrack(jst, jnp.asarray(frames))
    is_wb = mode == 0
    np.testing.assert_allclose(ring2[is_wb], np.asarray(jnew.wb_ring)[is_wb],
                               rtol=1e-6)
    np.testing.assert_array_equal(n2[is_wb], np.asarray(jnew.wb_n)[is_wb])
    np.testing.assert_array_equal(mode2[is_wb], np.asarray(jnew.mode)[is_wb])
    np.testing.assert_array_equal(ring2[~is_wb], ring[~is_wb])
    np.testing.assert_array_equal(n2[~is_wb], wb_n[~is_wb])
    np.testing.assert_array_equal(mode2[~is_wb], mode[~is_wb])
    assert 0 < int((mode2[is_wb] == 1).sum()) < int(is_wb.sum())


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("where", list(SLOTS))
def test_handoff_reads_tick_k_in_place(where, k):
    """handoff's init form with the audit under frames_at: the counts of
    each rect, the windows and band_dirty bit-exact against the
    reference's init_tracker on tick k's frames (a face, a rect past the
    frame's edges, an empty rect, noise; tick 2's stray pixel flags its
    stream)."""
    seq = _scan(20)
    seq[k, 4] = _noise(1, 30 + k)[0]
    slots = SLOTS[where]
    rows = np.arange(N) if slots is None else _safe(slots)
    rects = np.array([BOX, (-5, -3, 20, 18), BOX, BOX, (W - 6, H - 5, 20, 20),
                      (30, 20, 0, 9), BOX][:len(rows)], np.int32)
    rects[:, 0] += np.where(rects[:, 2] == BOX[2], k, 0).astype(np.int32)
    got = _in_place(lambda buf: handoff(
        buf, None if slots is None else torch.tensor(slots),
        rect=torch.from_numpy(rects), band=BAND), seq, k)
    ref = _reference_init(seq[k][rows], rects)
    _assert_leaves(got, ref)
    dirty = got[7].tolist()
    flagged = rows[np.asarray(dirty)].tolist()
    assert (3 in flagged) == (k == 2 and 3 in rows.tolist()), (rows, dirty)
