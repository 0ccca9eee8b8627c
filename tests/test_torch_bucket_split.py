"""The bucket kernels' split on the CPU: ``frame_prep`` (K9) and ``handoff``
(K7) spread each stream over a cluster of P CTAs (kernels/frameprep.py and
kernels/handoff.py ``pick_split``), and their twins (ops/imageproc.py
``frame_prep_plain``, ops/handoff.py ``handoff_plain``) compute by the
same split: partial channel sums over ``frame_shares``, rect counts over
``rect_shares``, the audit over row shares of the frame, each joined.
Here each twin, at P = 1, 2, 3, 8 and 16, against the JAX package on the
same seeded NumPy inputs:

  * frame_prep against the reference's ``grayscale`` (exact),
    ``whitebalance`` (rtol 1e-6: the reference's f32 mean against the
    port's exact sums) and its WB branch (the "wbtrack" step: the ring to
    rtol 1e-6, wb_n and the mode exact), on 40x56 frames (140 16-pixel
    units: no P > 2 here divides them), 44x63 (4-pixel units) and 45x61
    (single pixels); every P bit-equal to P = 1;
  * handoff against the reference's ``init_tracker`` with the band audit
    on 96x128 frames: the whole frame (its rows counted by 4 CTAs), rects
    at and past the edges, empty rects (nothing counted, band_dirty
    False), and a model-colored pixel exactly one column outside the band
    on each row where two CTAs' shares of the frame meet and on the row
    before it; every P bit-equal to P = 1;
  * the launchers' choice of P.

The bucket body through the forced split against the reference's
``step_bucket`` (make_step's handoff, the WB branch): tests/test_torch_
slots.py ``test_bucket_body_at_every_split``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from headtrackr_tpu.cascade import toy_cascade as jtoy
from headtrackr_tpu.config import TrackerConfig as JConfig
from headtrackr_tpu.models import camshift as jcs
from headtrackr_tpu.models import facetracker as jft
from headtrackr_tpu.ops import imageproc as jip
from headtrackr_tpu_torch.kernels import frameprep, handoff, histpdf
from headtrackr_tpu_torch.ops import handoff as ho
from headtrackr_tpu_torch.ops import imageproc as ip

torch.set_num_threads(2)

SPLITS = (1, 2, 3, 8, 16)
FACE = (230, 80, 60)
WB_SHAPE = (40, 56)
H, W = 96, 128  # the handoff's frames
BAND = (48, 64)
BOX = (48, 32, 24, 24)  # the face; its band rows 16-63, columns 24-87
OUTSIDE_COLS = (23, 88)  # one column left and right of the band


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)


def test_pick_split():
    """A power of two <= 16, about two CTAs an SM: 16 at the relock
    bucket's 8 slots and at one stream, 1 past 132 streams (the wbtrack
    and full ticks at serving widths: 256, 10,240, 70,000), S P within
    two waves up to 264 streams and on the grid's x (< 2^31) up to 70,000;
    both wrappers pick alike."""
    assert handoff.pick_split is frameprep.pick_split
    pick = frameprep.pick_split
    assert [pick(s) for s in (1, 8, 16, 17, 33, 66, 132, 133)] == \
        [16, 16, 16, 8, 8, 4, 2, 1]
    for s in (256, 10240, 65535, 65536, 70000):
        assert pick(s) == 1
    for sms in (132, 114, 78):
        for s in range(1, 70001, 37):
            p = pick(s, sms)
            assert p & (p - 1) == 0 and 1 <= p <= frameprep.MAX_SPLIT
            assert s * p <= max(2 * sms, s) and s * p < 2 ** 31
    assert pick(8, 114) == 16 and pick(64, 114) == 2


def test_split_refused_where_the_kernel_cannot_take_it():
    """The card takes a power of two <= 16; the twin any P >= 1."""
    dev = torch.device("cpu")
    for bad in (0, -1):
        with pytest.raises(ValueError):
            frameprep.resolve_split(bad, 8, dev, False)
    for bad in (3, 32):
        with pytest.raises(ValueError):
            frameprep.resolve_split(bad, 8, dev, True)
    assert frameprep.resolve_split(3, 8, dev, False) == 3


@pytest.mark.parametrize("hw", [2240, 2772, 2745, 1, 15, 16, 17])
def test_frame_shares_cover_the_frame(hw):
    """Each P's shares are whole units (16, 4 or 1 pixels as the frame's
    pixel count allows), in order, and cover the frame once."""
    unit = 16 if hw % 16 == 0 else 4 if hw % 4 == 0 else 1
    for p in SPLITS:
        shares = ip.frame_shares(hw, p)
        assert len(shares) == p and shares[0][0] == 0
        assert shares[-1][1] == hw
        for (a, b), (c, _) in zip(shares, shares[1:]):
            assert b == c and a <= b
        assert all(a % unit == 0 for a, _ in shares)


def test_rect_shares_are_the_cluster_histograms():
    """The twin's rows of a rect a CTA are the cluster histogram's
    (kernels/histpdf.py cluster_rows, the kernel's cta_share)."""
    rng = np.random.default_rng(7)
    rw = rng.integers(0, 400, 64)
    rh = rng.integers(0, 300, 64)
    for p in SPLITS:
        got = ho.rect_shares(torch.from_numpy(rw), torch.from_numpy(rh), p)
        for j in range(64):
            want = histpdf.cluster_rows(p, int(rh[j]), int(rw[j]))
            assert [tuple(r) for r in got[j].tolist()] == want


def _wb_frames(shape, n, seed):
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 256, (n,) + shape + (3,)).astype(np.uint8)
    f[:, 5:17, 9:25] = FACE
    f[0] = 255  # the extreme sums
    return f


@pytest.fixture(scope="module")
def wbtrack():
    """The reference's wbtrack step at WB_SHAPE (its WB branch)."""
    step = jft.make_step(jtoy(), JConfig(), WB_SHAPE, "wbtrack")
    return jax.jit(jax.vmap(step))


@pytest.mark.parametrize("split", SPLITS)
def test_frame_prep_twin_at_every_split(wbtrack, split):
    """The twin at P against the reference's grayscale, whitebalance and
    WB branch, streams in WB with rings stable and not; the same bits as
    P = 1; through slots padded with N too."""
    n = 6
    frames = _wb_frames(WB_SHAPE, n, 11)
    own = np.asarray(jip.whitebalance(jnp.asarray(frames)))
    rng = np.random.default_rng(12)
    spread = np.where(np.arange(n) % 2 == 0, 0.5, 3.0)[:, None]
    ring = (own[:, None] + spread * rng.uniform(-1, 1, (n, 15))).astype(
        np.float32)
    wb_n = np.full(n, 14, np.int32)
    js1 = jft.init_state()
    jst = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (n,) + x.shape).copy(), js1)
    jst = jst._replace(wb_ring=jnp.asarray(ring), wb_n=jnp.asarray(wb_n))
    jnew, jout = wbtrack(jst, jnp.asarray(frames))
    t = torch.from_numpy
    mode = torch.zeros((n,), dtype=torch.int32)
    got = ip.frame_prep_plain(t(frames), None, mode, t(ring), t(wb_n),
                              split=split)
    gray, wb, r2, n2, m2 = got
    np.testing.assert_array_equal(gray.numpy(),
                                  np.asarray(jip.grayscale(frames)))
    np.testing.assert_allclose(wb.numpy(), own, rtol=1e-6)
    np.testing.assert_allclose(wb.numpy(), np.asarray(jout.wb), rtol=1e-6)
    np.testing.assert_allclose(r2.numpy(), np.asarray(jnew.wb_ring),
                               rtol=1e-6)
    np.testing.assert_array_equal(n2.numpy(), np.asarray(jnew.wb_n))
    np.testing.assert_array_equal(m2.numpy(), np.asarray(jnew.mode))
    assert 0 < int((m2 == 1).sum()) < n
    one = ip.frame_prep_plain(t(frames), None, mode, t(ring), t(wb_n),
                              split=1)
    assert all(_same(a, b) for a, b in zip(got, one))
    # through slots padded with N, and through the wrapper's CPU path
    slots = torch.tensor([4, 0, n, 2, n], dtype=torch.int64)
    safe = slots.clamp(max=n - 1)
    args = (t(frames), slots, mode[safe], t(ring)[safe], t(wb_n)[safe])
    via = frameprep.frame_prep(*args, gray=False, wb_vj=True, split=split)
    want = ip.frame_prep_plain(*args, gray=False, wb_vj=True, split=1)
    assert all(_same(a, b) for a, b in zip(via, want))


@pytest.mark.parametrize("shape", [(44, 63), (45, 61)])
def test_frame_prep_twin_narrow_units(shape):
    """Frames whose pixel count takes 4-pixel units (44x63) or single
    pixels (45x61): the twin at every P equals the reference's grayscale
    and whitebalance, and P = 1 bit for bit."""
    n = 4
    frames = _wb_frames(shape, n, 13)
    t = torch.from_numpy
    mode = torch.tensor([0, 1, 0, 2], dtype=torch.int32)
    ring = torch.full((n, 15), 100.0)
    wb_n = torch.full((n,), 3, dtype=torch.int32)
    one = ip.frame_prep_plain(t(frames), None, mode, ring, wb_n, wb_vj=True,
                              split=1)
    np.testing.assert_array_equal(one[0].numpy(),
                                  np.asarray(jip.grayscale(frames)))
    np.testing.assert_allclose(
        one[1].numpy()[:2], np.asarray(jip.whitebalance(
            jnp.asarray(frames)))[:2], rtol=1e-6)
    for p in SPLITS:
        got = ip.frame_prep_plain(t(frames), None, mode, ring, wb_n,
                                  wb_vj=True, split=p)
        assert all(_same(a, b) for a, b in zip(got, one)), p


def _boundary_rows(split):
    """The rows where two CTAs' shares of the frame meet, and the rows
    before them."""
    rows = sorted({k * H // split for k in range(1, split)})
    return sorted(set(rows) | {r - 1 for r in rows})


def _handoff_case(split, seed):
    """Frames and rects: the face with a model-colored pixel one column
    outside the band (left, then right) on each share boundary row of
    ``split`` and on the row before it (one stream a row; row 64 is also
    one row below the band), the face alone, the whole frame, rects at
    and past the edges, empty rects."""
    rows = _boundary_rows(split)
    rng = np.random.default_rng(seed)
    n = len(rows) + 8
    frames = rng.integers(30, 50, (n, H, W, 3)).astype(np.uint8)
    x, y, w, h = BOX
    frames[:, y:y + h, x:x + w] = FACE
    for j, r in enumerate(rows):
        frames[j, r, OUTSIDE_COLS[j % 2]] = FACE
    rects = [BOX] * len(rows) + [
        BOX, (0, 0, W, H), (-5, -3, 40, 70), (W - 6, H - 5, 20, 20),
        (30, 20, 0, 9), (30, 20, 9, 0), (-40, 10, 20, 10), (3, 7, 120, 80)]
    frames[len(rows) + 1:] = rng.integers(30, 50, (7, H, W, 3))
    return frames, np.array(rects, np.int32), len(rows)


@pytest.mark.parametrize("split", SPLITS)
def test_handoff_twin_at_every_split(split):
    """The init form's twin at P (the port's init_tracker path) against the
    reference's init_tracker with the band audit: counts, windows and
    band_dirty bit-exact; a model pixel on each share boundary row (or the
    row before) makes band_dirty True, the face alone leaves it False, an
    empty rect counts nothing and leaves it False; the same bits as P = 1
    and through the wrapper's CPU path."""
    frames, rects, k = _handoff_case(split, 20 + split)
    fn = jax.vmap(lambda f, r: jcs.init_tracker(f, r, 0, BAND))
    ref = fn(jnp.asarray(frames), jnp.asarray(rects))
    t = torch.from_numpy
    got = ho.handoff_plain(t(frames), rect=t(rects), band=BAND, split=split)
    for name, a in zip(("model_hist", "window", "track_x", "track_y",
                        "track_w", "track_h", "track_angle", "band_dirty"),
                       got):
        np.testing.assert_array_equal(a.numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    dirty = got[7].tolist()
    assert dirty[:k] == [True] * k and not dirty[k]
    assert not dirty[k + 4] and not dirty[k + 5]  # empty rects
    assert float(got[0][k + 4].sum()) == 0.0
    assert float(got[0][k + 1].sum()) == H * W  # the whole frame
    one = ho.handoff_plain(t(frames), rect=t(rects), band=BAND, split=1)
    via = handoff.handoff(t(frames), rect=t(rects), band=BAND, split=split)
    assert all(_same(a, b) for a, b in zip(got, one))
    assert all(_same(a, b) for a, b in zip(via, one))


@pytest.mark.parametrize("split", SPLITS)
def test_handoff_form_at_every_split(split):
    """The handoff form's twin at P (the VJ branch's switch and select)
    equals P = 1 bit for bit: streams entering in VJ switching on their
    boxes or missing, streams in CS keeping their rows, the audit on."""
    frames, rects, k = _handoff_case(split, 40)
    n = len(rects)
    rng = np.random.default_rng(41)
    t = torch.from_numpy
    found = torch.from_numpy(rng.random(n) < 0.8)
    box = [t(rects[:, j].astype(np.float32) + 0.25) for j in range(4)]
    conf = t(rng.uniform(-20, 10, n).astype(np.float32))
    entry = t(rng.integers(1, 3, n).astype(np.int32))
    old = (torch.rand((n, 4096)), t(rects.copy()),
           *[torch.full((n,), 3, dtype=torch.int32)] * 4, torch.rand((n,)),
           torch.rand((n,)) < 0.5)
    kw = dict(det=(found, *box, conf), entry_mode=entry, mode=entry,
              old=old, band=BAND)
    got = ho.handoff_plain(t(frames), **kw, split=split)
    one = ho.handoff_plain(t(frames), **kw, split=1)
    flat = lambda r: list(r[0]) + [r[1]] + list(r[2])  # noqa: E731
    assert all(_same(a, b) for a, b in zip(flat(got), flat(one)))
    assert int((got[1] == 2).sum()) > 0 and bool(got[0][7].any())
