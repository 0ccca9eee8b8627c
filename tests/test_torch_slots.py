"""The relock tick's bucket body on the CPU: the serving program's twin
(``_Steps.scheduled``: the bodies uncaptured, the kernels' twins) forced to
its bucket body by ``bucket_step``, against the JAX package's
``make_batched_steps(...)`` ``step_bucket`` on the same state, frames and
served streams.  The body gathers the served slots' rows in one
``slot_gather`` (S5; twin kernels/schedule.py ``slot_gather_plain``), runs
the "pending" step on them reading its frames through the slots (K9, the
detector, K7), and ``scan_commit`` merges the sub-batch's rows into the
track pass's results by the body's slot map (``scan_commit_plain``): kept
rows written, padding and streams in CS after the track pass dropped.

At N = 8 and N = 12 (48x64, a 24x32 band, bucket 4: 8 slots, padded with
N), with streams entering in CS (one of them named among the slots and
kept out: still in CS after the track pass), in VJ with a face (it
relocks) and without one, in WB with a stable ring (it turns VJ), and a
CS stream whose window outgrows the band (it escapes: the tick's escape
fallback recomputes it from the staged, merged results).  Every state and
output leaf equals the reference's: integers exact, floats within rtol
1e-5 / atol 1e-4 (the reference's f32 whitebalance mean)."""

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
from headtrackr_tpu.runtime.serving import make_batched_steps as jsteps
from headtrackr_tpu_torch import BatchedTracker, convert, toy_cascade
from headtrackr_tpu_torch.kernels import launch as L
from headtrackr_tpu_torch.models import facetracker as tft

torch.set_num_threads(2)

H, W = 48, 64
BAND = (24, 32)
BUCKET = 4
ESCAPE_BUCKET = 4  # the escapes recomputed as a sub-batch (the "few" body)
FACE = (230, 80, 60)
# stream role -> (entry mode, face box or None); the roles repeat past 8
ROLES = [("cs", tft.MODE_CS, (8, 8, 20, 20)),
         ("vj", tft.MODE_VJ, (30, 14, 20, 20)),
         ("wb", tft.MODE_WB, None),
         ("cs kept out", tft.MODE_CS, (36, 20, 20, 20)),
         ("vj miss", tft.MODE_VJ, None),
         ("cs escapes", tft.MODE_CS, (4, 2, 44, 40)),
         ("cs", tft.MODE_CS, (20, 24, 18, 18)),
         ("vj unserved", tft.MODE_VJ, (12, 10, 20, 20))]
SERVED = ("vj", "wb", "cs kept out", "vj miss")


def _scene(n, seed):
    rng = np.random.default_rng(seed)
    frames = rng.integers(30, 50, (n, H, W, 3)).astype(np.uint8)
    for s in range(n):
        box = ROLES[s % len(ROLES)][2]
        if box is not None:
            x, y, w, h = box
            frames[s, y:y + h, x:x + w] = FACE
    return frames


@pytest.fixture(scope="module")
def reference():
    """The reference's step_bucket (jitted once; one compile a batch
    size)."""
    return jsteps(jtoy(), JConfig(), (H, W), donate=False, bucket=BUCKET,
                  band=BAND, escape_bucket=ESCAPE_BUCKET)[2]


def _states(n, frames):
    """The reference's state and the port's copy: CS streams handed their
    face box on this frame's predecessor (the face one pixel left), the WB
    stream's ring stable around its own whitebalance."""
    js1 = jft.init_state()
    st = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (n,) + x.shape).copy(), js1)
    prev = np.roll(frames, -1, axis=2)
    hands, modes = [], []
    for s in range(n):
        _, mode, box = ROLES[s % len(ROLES)]
        modes.append(mode)
        rect = box if box is not None and mode == tft.MODE_CS else (0, 0, 0,
                                                                   0)
        hands.append(jcs.init_tracker(jnp.asarray(prev[s]),
                                      jnp.asarray(rect, jnp.int32)))
    cs = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *hands)
    wb = np.asarray(jip.whitebalance(jnp.asarray(frames)))
    ring = (wb[:, None] + np.linspace(-0.4, 0.4, 15)[None]).astype(
        np.float32)
    st = st._replace(cs=cs, mode=jnp.asarray(modes, jnp.int32),
                     wb_ring=jnp.asarray(ring),
                     wb_n=jnp.full((n,), 14, jnp.int32))
    port = convert.state_from_numpy(
        [np.asarray(x) for x in jax.tree_util.tree_leaves(st)], device="cpu")
    return st, port


@pytest.mark.parametrize("n", [8, 12])
def test_bucket_body_matches_reference_step_bucket(reference, n):
    frames = _scene(n, n)
    jst, state = _states(n, frames)
    served = np.array([s for s in range(n)
                       if ROLES[s % len(ROLES)][0] in SERVED][:2 * BUCKET])
    slots = -(-served.size // BUCKET) * BUCKET
    idx = np.full(slots, n, np.int32)
    idx[:served.size] = served
    jnew, jout = reference(jst, jnp.asarray(frames), jnp.asarray(idx))

    bt = BatchedTracker(n, (H, W), cascade=toy_cascade(), device="cpu",
                        band=BAND, bucket=BUCKET, escape_bucket=ESCAPE_BUCKET)
    steps = bt._steps
    steps.scheduled = True
    L.reset_launches()
    new, out = steps.bucket_step(state, torch.from_numpy(frames), served)
    prog = steps.program(state)
    assert prog.runs[slots // BUCKET] == 1  # the bucket body of its slots
    assert prog.runs[9] == 1 and prog.stages == 1  # few, after staging
    assert L.host_paths == {"eager_branch": 0, "dispatch": 0, "recompute": 0}

    got = convert.state_to_numpy(new)
    ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(jnew)]
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(ref, got)):
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=f"leaf {i}")
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-4,
                                       err_msg=f"leaf {i}")
    for name, a, b in zip(tft.StepOutput._fields, jout, out):
        a, b = np.asarray(a), b.numpy()
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-4,
                                       equal_nan=True, err_msg=name)
    roles = [ROLES[s % len(ROLES)][0] for s in range(n)]
    mode = new.mode.tolist()
    assert mode[roles.index("vj")] == tft.MODE_CS  # relocked
    assert mode[roles.index("wb")] == tft.MODE_VJ  # its ring was stable
    assert mode[roles.index("vj unserved")] == tft.MODE_VJ
    assert bool(out.escaped[roles.index("cs escapes")])


@pytest.mark.parametrize("split", [1, 2, 3, 8, 16])
def test_bucket_body_at_every_split(reference, split, monkeypatch):
    """The bucket body with frame_prep's and handoff's split forced to P
    (their twins compute by it: share sums joined, rect counts and the
    audit's row shares joined): the reference's step_bucket at N = 8
    (make_step's WB branch and VJ handoff) leaf for leaf, as above."""
    from headtrackr_tpu_torch.kernels import frameprep
    monkeypatch.setattr(frameprep, "pick_split", lambda s, sms=None: split)
    test_bucket_body_matches_reference_step_bucket(reference, 8)
