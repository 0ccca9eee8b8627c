"""The relock tick's handoff and frame kernels on the CPU, through their
plain twins (the CPU paths of the wrappers), against the JAX package on
the same inputs:

  * K7, ``handoff`` (kernels/handoff.py; twin ops/handoff.py
    ``handoff_plain``) in its init form, as the port's
    ``camshift.init_tracker`` runs it, against ``jax.vmap`` of the
    reference's ``camshift.init_tracker`` with ``audit_band``: rects at
    the frame's edges and past them, the whole frame, empty rects; a face
    whose model bins all lie inside the band (band_dirty False) and one
    model-colored pixel one row above, one row below, one column left and
    one column right of the band (True), and one just inside each edge
    (False).  Histograms, windows and flags bit-exact;
  * K9, ``frame_prep`` (kernels/frameprep.py; twin ops/imageproc.py
    ``frame_prep_plain``) against the reference's ``grayscale`` (exact),
    ``whitebalance`` (rtol 1e-6: the reference's f32 mean against the
    port's exact sums) and its WB branch (the "wbtrack" step on streams
    in WB: the ring, wb_n and the new mode), over every stream and through
    slots padded with N.

Frames 48x64 from a seeded NumPy generator, the toy cascade."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from headtrackr_tpu.config import TrackerConfig as JConfig
from headtrackr_tpu.models import camshift as jcs
from headtrackr_tpu.models import facetracker as jft
from headtrackr_tpu.ops import imageproc as jip
from headtrackr_tpu_torch import toy_cascade
from headtrackr_tpu.cascade import toy_cascade as jtoy
from headtrackr_tpu_torch.kernels.frameprep import frame_prep
from headtrackr_tpu_torch.kernels.handoff import handoff
from headtrackr_tpu_torch.models import camshift as tcs
from headtrackr_tpu_torch.ops.handoff import handoff_plain
from headtrackr_tpu_torch.ops.imageproc import frame_prep_plain

torch.set_num_threads(2)

H, W = 48, 64
BAND = (24, 32)
FACE = (230, 80, 60)
BOX = (24, 16, 12, 12)  # the face: x, y, w, h; its band rows 8-31, cols 8-39


def _noise(n, seed):
    """Background noise whose bins no face pixel shares."""
    rng = np.random.default_rng(seed)
    return rng.integers(30, 50, (n, H, W, 3)).astype(np.uint8)


def _faces(n, seed=0):
    f = _noise(n, seed)
    x, y, w, h = BOX
    f[:, y:y + h, x:x + w] = FACE
    return f


def _reference_init(frames, rects):
    fn = jax.vmap(lambda f, r: jcs.init_tracker(f, r, 0, BAND))
    return fn(jnp.asarray(frames), jnp.asarray(rects))


def _assert_leaves(got, ref):
    for name, a in zip(("model_hist", "window", "track_x", "track_y",
                        "track_w", "track_h", "track_angle"), got):
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(ref,
                                                                    name)),
                                      err_msg=name)
    np.testing.assert_array_equal(got[7].numpy(),
                                  np.asarray(ref.band_dirty))


def test_band_placement_of_the_face():
    """The face's band is the one the cases below place pixels around."""
    ry, rx, bh, bw = tcs.band_rect(torch.tensor([BOX], dtype=torch.int32),
                                   BAND, (H, W))
    assert (int(ry[0]), int(rx[0]), bh, bw) == (8, 8, 24, 32)


def test_init_tracker_rects_match_reference():
    """Rects inside, at and past each edge, the whole frame and empty, on
    faces and noise: counts, windows and band_dirty bit-exact against the
    reference, through the port's init_tracker and the twin itself."""
    rects = np.array([BOX, (-5, -3, 20, 18), (W - 6, H - 5, 20, 20),
                      (0, 0, W, H), (30, 20, 0, 9), (30, 20, 9, 0),
                      (-40, 10, 20, 10), (10, H + 2, 5, 5),
                      (W - 1, 0, 1, 1), (3, 7, 50, 30)], np.int32)
    n = len(rects)
    frames = _faces(n, 1)
    frames[4:] = _noise(n - 4, 2)  # streams 4..: noise alone
    ref = _reference_init(frames, rects)
    got = tcs.init_tracker(torch.from_numpy(frames), torch.from_numpy(rects),
                           audit_band=BAND)
    _assert_leaves(tuple(got), ref)
    twin = handoff_plain(torch.from_numpy(frames),
                         rect=torch.from_numpy(rects), band=BAND)
    _assert_leaves(twin, ref)
    assert not got.band_dirty[4] and not got.band_dirty[5]  # empty rects
    assert float(got.model_hist[4].sum()) == 0.0
    assert bool(got.band_dirty[3])  # the whole frame: bins everywhere
    # without the audit: no flag, the same counts
    plain = tcs.init_tracker(torch.from_numpy(frames),
                             torch.from_numpy(rects))
    assert plain.band_dirty is None
    assert torch.equal(plain.model_hist, got.model_hist)


@pytest.mark.parametrize("where", ["inside", "above", "below", "left",
                                   "right", "top_row", "bottom_row",
                                   "left_col", "right_col"])
def test_audit_one_pixel_outside_each_band_edge(where):
    """A model-colored pixel one row or column outside each edge of the
    band placed for the face makes band_dirty True; one just inside each
    edge, or none, leaves it False; the reference agrees."""
    at = {"inside": None, "above": (7, 20), "below": (32, 20),
          "left": (20, 7), "right": (20, 40), "top_row": (8, 20),
          "bottom_row": (31, 20), "left_col": (20, 8),
          "right_col": (20, 39)}[where]
    frames = _faces(2, 3)
    if at is not None:
        frames[1, at[0], at[1]] = FACE
    rects = np.array([BOX, BOX], np.int32)
    ref = _reference_init(frames, rects)
    got = handoff(torch.from_numpy(frames), rect=torch.from_numpy(rects),
                  band=BAND)
    _assert_leaves(got, ref)
    want = where in ("above", "below", "left", "right")
    assert got[7].tolist() == [False, want]


@pytest.fixture(scope="module")
def wbtrack():
    """The reference's wbtrack step over a batch (its WB branch)."""
    step = jft.make_step(jtoy(), JConfig(), (H, W), "wbtrack")
    return jax.jit(jax.vmap(step))


def _wb_states(n, seed):
    """Rings around each stream's own whitebalance (stable: spread < 2)
    or spread wide, wb_n 13..15, every stream in WB."""
    frames = _faces(n, seed)
    rng = np.random.default_rng(seed + 1)
    own = np.asarray(jip.whitebalance(jnp.asarray(frames)))
    spread = np.where(np.arange(n) % 2 == 0, 0.5, 3.0)[:, None]
    ring = (own[:, None] + spread * rng.uniform(-1, 1, (n, 15))) \
        .astype(np.float32)
    wb_n = rng.integers(13, 16, n).astype(np.int32)
    return frames, ring, wb_n


def test_frame_prep_matches_reference(wbtrack):
    """frame_prep's twin over every stream: the gray plane exact, the
    whitebalance to rtol 1e-6, and the reference's WB branch (ring,
    wb_n, mode) on streams entering in WB; a stream in VJ or CS keeps its
    rows (wb reported on VJ with wb_vj)."""
    n = 10
    frames, ring, wb_n = _wb_states(n, 4)
    js1 = jft.init_state()
    jst = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (n,) + x.shape).copy(), js1)
    jst = jst._replace(wb_ring=jnp.asarray(ring), wb_n=jnp.asarray(wb_n))
    jnew, jout = wbtrack(jst, jnp.asarray(frames))
    mode = torch.zeros((n,), dtype=torch.int32)
    t = torch.from_numpy
    gray, wb, r2, n2, m2 = frame_prep(t(frames), None, mode, t(ring),
                                      t(wb_n))
    np.testing.assert_array_equal(gray.numpy(),
                                  np.asarray(jip.grayscale(frames)))
    np.testing.assert_allclose(wb.numpy(), np.asarray(
        jip.whitebalance(jnp.asarray(frames))), rtol=1e-6)
    np.testing.assert_allclose(wb.numpy(), np.asarray(jout.wb), rtol=1e-6)
    np.testing.assert_allclose(r2.numpy(), np.asarray(jnew.wb_ring),
                               rtol=1e-6)
    np.testing.assert_array_equal(n2.numpy(), np.asarray(jnew.wb_n))
    np.testing.assert_array_equal(m2.numpy(), np.asarray(jnew.mode))
    assert 0 < int((m2 == 1).sum()) < n  # some rings stable, some not
    # other entry modes keep their rows; wb on VJ only with wb_vj
    other = torch.tensor([1, 2] * (n // 2), dtype=torch.int32)
    for wb_vj in (False, True):
        _, wb, r3, n3, m3 = frame_prep(t(frames), None, other, t(ring),
                                       t(wb_n), gray=False, wb_vj=wb_vj)
        assert torch.equal(r3, t(ring)) and torch.equal(n3, t(wb_n))
        assert torch.equal(m3, other)
        assert bool((wb[other == 2] == 0).all())
        assert bool((wb[other == 1] != 0).all()) == wb_vj


def test_frame_prep_through_slots():
    """Through slots padded with N, each row is the row of its stream
    (padding reads stream N - 1), equal to the call over every stream."""
    n = 6
    frames, ring, wb_n = _wb_states(n, 5)
    t = torch.from_numpy
    mode = torch.tensor([0, 1, 0, 2, 0, 1], dtype=torch.int32)
    full = frame_prep_plain(t(frames), None, mode, t(ring), t(wb_n))
    slots = torch.tensor([4, 0, 2, n, n], dtype=torch.int64)
    safe = slots.clamp(max=n - 1)
    got = frame_prep(t(frames), slots, mode[safe], t(ring)[safe],
                     t(wb_n)[safe])
    for a, b in zip(got, full):
        assert torch.equal(a, b.index_select(0, safe))
