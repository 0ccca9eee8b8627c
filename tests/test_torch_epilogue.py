"""The tick epilogue's plain twin (ops/epilogue.py, the CPU path of
kernels/epilogue.py) through the port's ``make_step``, against the JAX
package's ``make_step`` on the same inputs (histKernel="pallas",
interpret mode on the CPU).

Eight streams of 120x160 frames from a seeded NumPy generator (a toy-
cascade-coloured face on a noisy background), states built on the JAX side
(``init_tracker`` on the first frame) and carried over with ``convert``:

  * the "track" step (the fused form: the finish, the freeze, the
    supervision), band and full frame, under configurations that give each
    flag both values (calcAngles, retryDetection, smoothing, headPosition,
    fov 60 or estimated, edgecorrection); two ticks: a first-found stream
    whose full, stable head-diagonal ring activates head tracking, a
    zero-mass stream (a blue frame: lost, NaN angle under calcAngles), a
    face at a corner and at each frame edge with head tracking active
    (track_head's corner, top/bottom and left/right branches), a WB stream
    (frozen);
  * the supervision form after the branches: the "wbtrack" step (WB, VJ
    and CS streams) under two configurations;
  * the twin passes the step's untouched leaves through as the same
    tensors, and a stream's result is the same alone and in the batch.

Integer and bool fields exact; floats to rtol 1e-5 / atol 1e-4, the
camshift angle to 1e-5 (F11), NaN-equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import headtrackr_tpu as ht
from headtrackr_tpu.config import TrackerConfig as JConfig
from headtrackr_tpu.models import camshift as jcs
from headtrackr_tpu.models import facetracker as jft
from headtrackr_tpu_torch import TrackerConfig, convert, toy_cascade
from headtrackr_tpu_torch.models import facetracker as tft

torch.set_num_threads(2)

H, W = 120, 160
BAND = (64, 96)
N = 8
# each stream's face box (x0, y0) of 24x24 px: centre, blue (zero mass),
# the top-left corner, the top, bottom, left and right edges, centre (WB)
FACES = [(68, 48), (68, 48), (2, 2), (68, 2), (68, H - 26), (2, 48),
         (W - 26, 48), (40, 40)]
ROLES = ("found", "zero", "corner", "top", "bottom", "left", "right", "wb")
ANGLES = ("face_angle",)
# each flag takes both values across the grid
TRACK_CONFIGS = [
    dict(),
    dict(calcAngles=True, retryDetection=False, smoothing=False, fov=60),
    dict(calcAngles=True, headPosition=False, edgecorrection=False),
    dict(retryDetection=False, fov=60, edgecorrection=False, sendEvents=False),
]


def _frame(s, t, rng):
    f = rng.integers(30, 50, (H, W, 3)).astype(np.uint8)
    if ROLES[s] == "zero" and t > 0:
        f[...] = (0, 0, 250)
        return f
    x0, y0 = FACES[s]
    x0 = x0 + (t % 2 if x0 > 2 and x0 < W - 26 else 0)
    f[y0:y0 + 24, x0:x0 + 24] = (230, 80, 60)
    return f


@pytest.fixture(scope="module")
def clip():
    rng = np.random.default_rng(7)
    return np.stack([np.stack([_frame(s, t, rng) for s in range(N)])
                     for t in range(3)])


def _jax_state(frame0, modes):
    """The reference's state of N streams, each CS stream handed its face
    box on ``frame0``."""
    js1 = jft.init_state()
    st = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (N,) + x.shape).copy(), js1)
    hand = [jcs.init_tracker(jnp.asarray(frame0[s]),
                             jnp.asarray(list(FACES[s]) + [24, 24],
                                         jnp.int32)) for s in range(N)]
    cs = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *hand)
    return st._replace(cs=cs, mode=jnp.asarray(modes, jnp.int32))


def _set(jstate, **leaves):
    """The reference state with supervision leaves replaced (NumPy)."""
    return jstate._replace(**{k: jnp.asarray(v) for k, v in leaves.items()})


def _to_port(jstate):
    return convert.state_from_numpy(
        [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate)],
        device="cpu")


def _assert_close(name, a, b, where):
    a = np.asarray(a)
    b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
    a = np.broadcast_to(a, b.shape)
    if a.dtype.kind in "biu":
        np.testing.assert_array_equal(b, a, err_msg=f"{where} {name}")
    else:
        tol = 1e-5 if name in ANGLES or name == "leaf 9" else 1e-4
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=tol,
                                   err_msg=f"{where} {name}")


def _assert_step(jres, tres, where):
    for name, a, b in zip(tft.StepOutput._fields, jres[1], tres[1]):
        _assert_close(name, a, b, where)
    ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(jres[0])]
    got = convert.state_to_numpy(tres[0])
    assert len(ref) == len(got)
    for i, (a, b) in enumerate(zip(ref, got)):  # leaf 9: track_angle
        _assert_close(f"leaf {i}", a, b, where)


def _supervised(jstate, tstep, frames):
    """Supervision leaves that put each stream in its role this tick: the
    first-found stream's ring full of the diagonal it reports (a stable
    ring: the activation tick), the edge streams tracking heads."""
    _, out = tstep(_to_port(jstate), torch.as_tensor(frames))[:2]
    diag = float(np.hypot(float(out.smooth_w[0]), float(out.smooth_h[0])))
    ring = np.zeros((N, 6), np.float32)
    ring[0] = diag
    active = np.isin(np.arange(N), [2, 3, 4, 5, 6])
    return _set(jstate, diag_ring=ring,
                diag_n=np.where(np.arange(N) == 0, 6, 0).astype(np.int32),
                face_found=active, headpose_active=active,
                first_run=~active,
                tan_fov=np.where(active, 0.9, 0.0).astype(np.float32),
                fov_width=np.where(active, 0.85, 0.0).astype(np.float32),
                head_diag_cam=np.where(active, 34.0, 0.0).astype(np.float32),
                sm_init=active, sm_sp=np.asarray(
                    [[x + 12, y + 12, 0, 24, 24] for x, y in FACES],
                    np.float32))


@pytest.mark.parametrize("k", range(len(TRACK_CONFIGS)))
def test_track_step_matches_reference(clip, k):
    """The fused form: "track" (band on even configurations) for two ticks
    from states in each role, every output and state leaf."""
    cfg = TRACK_CONFIGS[k]
    band = BAND if k % 2 == 0 else None
    cfg = dict(cfg, bandHist=band is not None,
               bandHistAuditAction="escape")
    jstep = jax.jit(jax.vmap(jft.make_step(
        ht.toy_cascade(), JConfig(histKernel="pallas", **cfg), (H, W),
        "track", band=band)))
    tstep = tft.make_step(toy_cascade(), TrackerConfig(**cfg), (H, W),
                          "track", band=band, device="cpu")
    modes = [2] * 7 + [0]
    jstate = _supervised(_jax_state(clip[0], modes), tstep, clip[1])
    tstate = _to_port(jstate)
    for t in (1, 2):
        jres = jstep(jstate, jnp.asarray(clip[t]))
        tres = tstep(tstate, torch.as_tensor(clip[t]))
        _assert_step(jres, tres, f"config {k} tick {t}")
        if band is not None:
            np.testing.assert_array_equal(tres[2].numpy(), np.asarray(jres[2]))
        out = tres[1]
        if t == 1:  # each stream took its branch
            zero = ROLES.index("zero")
            lost = tft.STATUS_REDETECTING if cfg.get(
                "retryDetection", True) else tft.STATUS_LOST
            assert out.status[zero] & lost
            assert bool(torch.isnan(out.face_angle[zero])) == bool(
                cfg.get("calcAngles", False))
            if cfg.get("headPosition", True):
                assert out.head_valid[0] and not tres[0].first_run[0]
                assert out.head_valid[2:7].all()
            assert out.status[7] == 0 and out.face_conf[7] == 0
        jstate, tstate = jres[0], tres[0]


@pytest.mark.parametrize("k", range(2))
def test_supervision_after_branches_matches_reference(clip, k):
    """The supervision form: the "wbtrack" step (select form) on WB, VJ
    (frozen: no status) and CS streams."""
    cfg = dict(TRACK_CONFIGS[k + 1], bandHist=True)
    jstep = jax.jit(jax.vmap(jft.make_step(
        ht.toy_cascade(), JConfig(histKernel="pallas", **cfg), (H, W),
        "wbtrack", band=BAND)))
    tstep = tft.make_step(toy_cascade(), TrackerConfig(**cfg), (H, W),
                          "wbtrack", band=BAND, device="cpu")
    modes = [2, 2, 2, 1, 2, 0, 2, 0]
    jstate = _supervised(_jax_state(clip[0], modes), tstep, clip[1])
    tstate = _to_port(jstate)
    for t in (1, 2):
        jres = jstep(jstate, jnp.asarray(clip[t]))
        tres = tstep(tstate, torch.as_tensor(clip[t]), select=True)
        _assert_step(jres, tres, f"wbtrack config {k} tick {t}")
        np.testing.assert_array_equal(tres[2].numpy(), np.asarray(jres[2]))
        assert tres[1].status[3] == 0
        jstate, tstate = jres[0], tres[0]


@pytest.mark.parametrize("variant", ["track", "wbtrack"])
def test_twin_passes_untouched_leaves_through(clip, variant):
    """What the step leaves alone comes back as the same tensor: the model
    histograms, band_dirty, wb_ring, wb_n (track), pend_age; stopped
    under retryDetection; sm_sp and sm_init without smoothing."""
    cfg = TrackerConfig(smoothing=False, bandHist=True,
                        bandHistAudit=True)
    step = tft.make_step(toy_cascade(), cfg, (H, W), variant, band=BAND,
                         audit_band=BAND, device="cpu")
    jstate = _jax_state(clip[0], [2] * N)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate)]
    state = convert.state_from_numpy(
        leaves[:10] + [np.zeros(N, bool)] + leaves[10:], device="cpu")
    kw = {"select": True} if variant == "wbtrack" else {}
    new = step(state, torch.as_tensor(clip[1]), **kw)[0]
    same = ["pend_age", "stopped", "sm_sp", "sm_init"]
    if variant == "track":
        same += ["wb_ring", "wb_n"]
    for name in same:
        assert getattr(new, name) is getattr(state, name), name
    assert new.cs.model_hist is state.cs.model_hist
    assert new.cs.band_dirty is state.cs.band_dirty
    assert new.mode is not state.mode and new.face_found is not \
        state.face_found


def test_stream_alone_equals_batch(clip):
    """A stream's result does not depend on its batch: the "track" step on
    each stream alone equals its row of the batch's, to the bit."""
    step = tft.make_step(toy_cascade(), TrackerConfig(calcAngles=True), (H, W),
                         "track", device="cpu")
    state = _to_port(_jax_state(clip[0], [2] * 7 + [0]))
    frames = torch.as_tensor(clip[1])
    new, out = step(state, frames)
    for i in range(N):
        one = lambda t: t[i:i + 1]  # noqa: E731
        s1, o1 = step(tft.tree_index(state, torch.tensor([i])), one(frames))
        for name, a, b in zip(tft.StepOutput._fields, out, o1):
            assert torch.equal(one(a).nan_to_num(), b.nan_to_num()), (i, name)
        for a, b in zip(convert.state_to_numpy(new),
                        convert.state_to_numpy(s1)):
            np.testing.assert_array_equal(a[i:i + 1], b)
