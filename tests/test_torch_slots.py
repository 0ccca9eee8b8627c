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
fallback recomputes it from the pre-step state).  Every state and output
leaf equals the reference's: integers exact, floats within rtol 1e-5 /
atol 1e-4 (the reference's f32 whitebalance mean).

The serving program of the band configuration (its track pass
``hist_mma`` + ``backproject_ratio``, reading the tick's frames in place)
at N = 12 and escape_bucket 8 against the reference's ``step_auto`` on
two ticks from a tick with a relock and few escapes, one with many
escapes and an all-CS tick with one escape, through ``step_auto`` and
``run_scan``, with the bodies' frame buffer poisoned before each call: a
frame reader left on the buffer would differ.

The escape fallback's few body, at N = 12 and escape_bucket 8, against
the reference's ``step_auto``: one stream escaping on an all-CS tick, and
two escaping on a bucket tick (served slots disjoint from the escaped
ones), eidx padded with N; the body gathers the pre-step state's rows and
the frames' with one ``slot_gather`` under the escape's keep rule (idx <
N), and ``scan_commit`` writes the tick body's table and then the
sub-batch's kept rows (no staging).  Also ``slot_gather_plain`` under
both keep rules against the reference's ``valid`` expressions, and a
dispatch-mode check that the few body runs no operation over a tensor of
the batch's rows."""

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

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


def _scene(n, seed, roles=ROLES):
    rng = np.random.default_rng(seed)
    frames = rng.integers(30, 50, (n, H, W, 3)).astype(np.uint8)
    for s in range(n):
        box = roles[s % len(roles)][2]
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


def _states(n, frames, roles=ROLES):
    """The reference's state and the port's copy: CS streams handed their
    face box on this frame's predecessor (the face one pixel left), the WB
    stream's ring stable around its own whitebalance."""
    js1 = jft.init_state()
    st = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (n,) + x.shape).copy(), js1)
    prev = np.roll(frames, -1, axis=2)
    hands, modes = [], []
    for s in range(n):
        _, mode, box = roles[s % len(roles)]
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
    assert prog.runs[9] == 1 and prog.chunks == 0  # few: no chunk of many
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


# The escape fallback's few body (escape_bucket 8 of 12 streams): one
# stream escaping alone on an all-CS tick, and two escaping on a bucket
# tick (VJ and WB streams served, disjoint from the escaped ones)
N_FEW, EB_FEW = 12, 8
_CS, _ESC = ("cs", tft.MODE_CS), ("cs escapes", tft.MODE_CS)
_SMALL = [(8, 8), (20, 24), (36, 20), (40, 30), (10, 30), (50, 8), (30, 4),
          (44, 30)]  # 10x10 faces, whose windows stay inside the band
FEW_ROLES = {
    "alone": [_CS + ((x, y, 10, 10),) for x, y in _SMALL[:2]]
    + [_ESC + ((4, 2, 44, 40),)]
    + [_CS + ((x, y, 10, 10),) for x, y in (_SMALL[2:] + _SMALL[:3])],
    "bucket": [("vj", tft.MODE_VJ, (30, 14, 20, 20)),
               _ESC + ((4, 2, 44, 40),), ("wb", tft.MODE_WB, None),
               _CS + ((8, 8, 10, 10),), _ESC + ((6, 4, 42, 40),),
               _CS + ((20, 24, 10, 10),), ("vj", tft.MODE_VJ,
                                           (30, 14, 20, 20)),
               _CS + ((36, 20, 10, 10),), ("wb", tft.MODE_WB, None)]
    + [_CS + ((x, y, 10, 10),) for x, y in _SMALL[3:6]],
    # a bucket tick (a VJ stream relocks, a WB one turns VJ) on which nine
    # streams escape: more than escape_bucket, the many body
    "many": [("vj", tft.MODE_VJ, (30, 14, 20, 20)), ("wb", tft.MODE_WB, None),
             _CS + ((8, 8, 10, 10),)]
    + [_ESC + ((2 + k % 3, 1 + k % 4, 44 - k % 3, 40 - k % 5),)
       for k in range(9)],
}


@pytest.fixture(scope="module")
def reference_auto():
    """The reference's step_auto at escape_bucket 8 (jitted once)."""
    return jsteps(jtoy(), JConfig(), (H, W), donate=False, bucket=BUCKET,
                  band=BAND, escape_bucket=EB_FEW)[3]


@pytest.mark.parametrize("case", ["alone", "bucket"])
def test_few_body_matches_reference_step_auto(reference_auto, case):
    """The program's twin (the bodies uncaptured) on a tick whose escape
    fallback runs the few body: the tick body's results committed by its
    table, then the few body's rows (gathered from the pre-step state by
    slot_gather under the escape's rule, eidx padded with N) by its rows
    table, no staging; every state and output leaf equals the reference's
    step_auto (integers exact, floats within rtol 1e-5 / atol 1e-4)."""
    roles = FEW_ROLES[case]
    frames = _scene(N_FEW, 26, roles)
    jst, state = _states(N_FEW, frames, roles)
    jnew, jout = reference_auto(jst, jnp.asarray(frames))

    bt = BatchedTracker(N_FEW, (H, W), cascade=toy_cascade(), device="cpu",
                        band=BAND, bucket=BUCKET, escape_bucket=EB_FEW)
    bt._steps.scheduled = True
    bt.set_state(state)
    L.reset_launches()
    out = bt.step_auto(frames)
    prog = bt._steps.program(bt.state)
    names = [r[0] for r in roles]
    escaping = [s for s, r in enumerate(names) if r == "cs escapes"]
    assert prog.runs[9] == 1 and prog.chunks == 0  # few: no chunk of many
    assert prog.runs[0 if case == "alone" else 1] == 1
    assert out.escaped.nonzero().flatten().tolist() == escaping
    want_eidx = escaping + [N_FEW] * (EB_FEW - len(escaping))
    assert prog.bufs.eidx.tolist() == want_eidx  # padded with N
    assert L.host_paths == {"eager_branch": 0, "dispatch": 0, "recompute": 0}

    got = convert.state_to_numpy(bt.state)
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
    if case == "bucket":
        assert bt.state.mode[names.index("vj")] == tft.MODE_CS  # relocked
        assert bt.state.mode[names.index("wb")] == tft.MODE_VJ


def _assert_reference(jnew, jout, state, out, where):
    """The port's state (None: not compared) and StepOutput equal the
    reference's: integers exact, floats within rtol 1e-5 / atol 1e-4."""
    pairs = [(f"{where} {name}", np.asarray(a), b.numpy())
             for name, a, b in zip(tft.StepOutput._fields, jout, out)]
    if state is not None:
        ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(jnew)]
        got = convert.state_to_numpy(state)
        assert len(got) == len(ref)
        pairs += [(f"{where} leaf {i}", a, b)
                  for i, (a, b) in enumerate(zip(ref, got))]
    for what, a, b in pairs:
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=what)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-4,
                                       equal_nan=True, err_msg=what)


@pytest.mark.parametrize("entry", ["step_auto", "run_scan"])
@pytest.mark.parametrize("case", ["bucket", "many", "alone"])
def test_band_program_reads_frames_in_place(reference_auto, case, entry):
    """The band configuration's serving program (the program's twin, the
    bodies uncaptured) over two ticks, the second's faces a pixel to the
    right, from a state whose first tick relocks and escapes a few streams
    (bucket), relocks and escapes nine (many: more than escape_bucket) or
    escapes one on an all-CS tick (alone), with the bodies' frame buffer
    filled with 255 before each call: the all-CS and many bodies copy none
    of the tick's frames and read them in place, the bucket and few bodies
    copy their slots' rows; every output and the state after each tick
    equal the reference's step_auto."""
    roles = FEW_ROLES[case]
    frames = _scene(N_FEW, 26, roles)
    seq = np.stack([frames, np.roll(frames, 1, axis=2)])
    jst, state = _states(N_FEW, frames, roles)
    refs = []
    for f in seq:
        jst, jout = reference_auto(jst, jnp.asarray(f))
        refs.append((jst, jout))
    bt = BatchedTracker(N_FEW, (H, W), cascade=toy_cascade(), device="cpu",
                        band=BAND, bucket=BUCKET, escape_bucket=EB_FEW)
    bt._steps.scheduled = True
    bt.set_state(state)
    bufs = bt._steps.buffers(bt.state)
    L.reset_launches()
    runs = []
    if entry == "step_auto":
        for k, f in enumerate(seq):
            bufs.frames.fill_(255)
            out = bt.step_auto(f)
            runs.append(bt._steps.program(bt.state).runs)
            _assert_reference(*refs[k], bt.state, out, f"tick {k}")
    else:
        bufs.frames.fill_(255)
        got = bt.run_scan(torch.as_tensor(seq))
        runs.append(bt._steps.program(bt.state).runs)
        for k in range(len(seq)):
            _assert_reference(*refs[k], bt.state if k == len(seq) - 1
                              else None, [v[k] for v in got],
                              f"scan tick {k}")
    assert L.host_paths == dict.fromkeys(L.host_paths, 0)
    # the first tick's escape fallback (step_auto; run_scan: both ticks'
    # runs): the many body, else the few body; its body all-CS or bucket
    assert runs[0][10 if case == "many" else 9] >= 1, runs
    assert (runs[0][0] >= 1) == (case == "alone"), runs
    if case != "alone":
        assert bt.state.mode[0] == tft.MODE_CS  # the VJ stream relocked


@pytest.mark.parametrize("escape", [False, True])
def test_slot_gather_plain_keeps_by_the_reference_rule(escape):
    """slot_gather's twin under each keep rule against the reference's
    expressions on the same state: the rows a[safe] of every leaf (and of
    an extra tensor, the frames), ``valid = (idx < N) & (mode != CS)``
    for a bucket (headtrackr_tpu/runtime/serving.py:318) and ``valid =
    idx < N`` for an escape (:260), with CS, VJ and WB rows and padding."""
    from headtrackr_tpu_torch.kernels import schedule as S
    n = 10
    frames = _scene(n, 4)
    jst, state = _states(n, frames)
    idx = np.array([5, 0, 2, n, 9, 3, n, n])
    got = S.slot_gather_plain(state, torch.as_tensor(idx), escape,
                              (torch.from_numpy(frames),))
    jidx = jnp.asarray(idx)
    safe = jnp.minimum(jidx, n - 1)
    sub = jax.tree_util.tree_map(lambda a: a[safe], jst)
    valid = jidx < n if escape else (jidx < n) & (sub.mode != jft.MODE_CS)
    assert got[1].tolist() == np.asarray(valid).tolist()
    assert not escape or got[1].tolist() != np.asarray(
        (jidx < n) & (sub.mode != jft.MODE_CS)).tolist()
    for a, b in zip(jax.tree_util.tree_leaves(sub),
                    convert.state_to_numpy(got[0])):
        np.testing.assert_array_equal(b, np.asarray(a))
    np.testing.assert_array_equal(got[2].numpy(), frames[np.asarray(safe)])


class _Ops(TorchDispatchMode):
    """Records each ATen operation dispatched inside the block and the
    leading sizes of its tensor arguments and results."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        flat = pytree.tree_flatten((args, kwargs or {}, out))[0]
        self.ops.append((str(func), [tuple(t.shape[:1]) for t in flat
                                     if torch.is_tensor(t) and t.dim()]))
        return out


def test_few_body_gathers_and_scatters_no_whole_leaf(monkeypatch):
    """The few body with slot_gather stubbed (its twin's result given):
    it gathers through slot_gather with the escape rule and the frames as
    an extra leaf, returns a _Merge, and dispatches no operation over a
    tensor of the batch's 12 rows: no index_select, cat or index_copy of
    a state leaf or of the frames, nor any other operation over them (the
    track step runs on the 8 rows)."""
    from headtrackr_tpu_torch.kernels import schedule as S
    from headtrackr_tpu_torch.runtime import serving as srv
    roles = FEW_ROLES["bucket"]
    frames = torch.from_numpy(_scene(N_FEW, 26, roles))
    _, state = _states(N_FEW, frames.numpy(), roles)
    bt = BatchedTracker(N_FEW, (H, W), cascade=toy_cascade(), device="cpu",
                        band=BAND, bucket=BUCKET, escape_bucket=EB_FEW)
    eidx = torch.tensor([1, 4] + [N_FEW] * (EB_FEW - 2))
    given = S.slot_gather_plain(state, eidx, True, (frames,))
    calls = []

    def gather(st, idx, escape=False, extra=()):
        calls.append((st is state, idx is eidx, escape,
                      len(extra) == 1 and extra[0] is frames))
        return given

    monkeypatch.setattr(srv.schedule, "slot_gather", gather)
    with _Ops() as seen:
        merge = bt._steps._escape_few(state, frames, eidx)
    assert calls == [(True, True, True, True)]
    assert isinstance(merge, srv._Merge)
    assert merge.idx is eidx and merge.keep is given[1]
    whole = [op for op, shapes in seen.ops if (N_FEW,) in shapes]
    assert not whole, whole
    assert seen.ops  # the track step ran on the sub-batch


def _esc_role(k):
    """A CS stream whose window outgrows the band (it escapes)."""
    return _ESC + ((2 + k % 3, 1 + k % 4, 44 - k % 3, 40 - k % 5),)


# the many escape body's cases: (tick body, escaped streams E, big and
# small chunks[, escape_bucket]) at N = 12, escape_bucket 8 unless given:
# E = escape_bucket + 1 = M + 1 across a big chunk and a small one, in two
# small chunks, or in one partial small chunk; E = N (every stream, the
# all-escape tick) across a big chunk and a small one; E = 11 at
# escape_bucket 2 in two big chunks of 4 and then two small ones of 2;
# streams 0 and N - 1 escape in every case
CHUNK_CASES = {
    "alone 12 by 8 8": ("track", [_esc_role(k) for k in range(12)], (8, 8)),
    "alone 11 by 4 2": ("track", [_esc_role(k) for k in range(6)]
                        + [_CS + ((8, 8, 10, 10),)]
                        + [_esc_role(k) for k in range(6, 11)], (4, 2), 2),
    "alone 9 by 16 8": ("track", [_esc_role(k) for k in range(5)]
                     + [_CS + ((8, 8, 10, 10),), _CS + ((20, 24, 10, 10),),
                        _CS + ((36, 20, 10, 10),)]
                     + [_esc_role(k) for k in range(5, 9)], (16, 8)),
    "bucket 9 by 8 8": ("bucket", [_esc_role(0), ("vj", tft.MODE_VJ,
                                                (30, 14, 20, 20))]
                      + [_esc_role(k) for k in range(1, 5)]
                      + [("wb", tft.MODE_WB, None), _CS + ((8, 8, 10, 10),)]
                      + [_esc_role(k) for k in range(5, 9)], (8, 8)),
    "wbtrack 9 by 16 16": ("wbtrack", [_esc_role(k) for k in range(4)]
                        + [("wb", tft.MODE_WB, None), _CS + ((8, 8, 10, 10),),
                           ("wb", tft.MODE_WB, None)]
                        + [_esc_role(k) for k in range(4, 9)], (16, 16)),
}


@pytest.mark.parametrize("case", list(CHUNK_CASES))
def test_many_body_in_chunks_matches_reference(reference_auto, case):
    """The program's twin on a tick whose escape fallback runs the many
    body in chunks (``escape_chunk`` and ``escape_tail``, big and small):
    the tick body's commit with the escaped streams' state rows held, then
    each chunk's slot_gather of its slots of escape_select's list from the
    pre-step state and the tick's frames (read in place; the bodies' frame
    buffer poisoned), the full-frame "track" step on them and its kept
    rows; every state and output leaf equals the reference's step_auto
    (integers exact, floats within rtol 1e-5 / atol 1e-4) and the per-tick
    path's host recompute (``_Steps._recompute``) bit for bit.  The list
    holds the escaped streams lowest first, padded with N, and the chunks
    of ``chunk_plan`` ran."""
    from headtrackr_tpu_torch.kernels import schedule as S
    tick, roles, (m, ms), *eb = CHUNK_CASES[case]
    eb = eb[0] if eb else EB_FEW
    frames = _scene(N_FEW, 26, roles)
    jst, state = _states(N_FEW, frames, roles)
    jnew, jout = reference_auto(jst, jnp.asarray(frames))
    escaping = [s for s, r in enumerate(roles) if r[0] == "cs escapes"]
    assert escaping[0] == 0 and escaping[-1] == N_FEW - 1

    got = []
    for scheduled in (True, False):
        bt = BatchedTracker(N_FEW, (H, W), cascade=toy_cascade(),
                            device="cpu", band=BAND, bucket=BUCKET,
                            escape_bucket=eb)
        bt._steps.scheduled = scheduled
        bt._steps.escape_chunk, bt._steps.escape_tail = m, ms
        bt.set_state(state)
        bt._steps.buffers(bt.state).frames.fill_(255)
        L.reset_launches()
        out = bt.step_auto(frames)
        got.append((convert.state_to_numpy(bt.state), out))
        if scheduled:
            prog = bt._steps.program(bt.state)
            assert bt._steps.branch(np.array([r[1] for r in roles])) == tick
            assert (prog.bufs.m, prog.bufs.ms) == (m, ms)
            assert prog.runs[10] == 1
            big, tail0, tails = S.chunk_plan(len(escaping), ms, m)
            assert prog.chunks == big + tails - tail0
            assert prog.big_chunks == big
            assert (big, tails - tail0) == {
                "alone 12 by 8 8": (1, 1), "alone 11 by 4 2": (2, 2),
                "alone 9 by 16 8": (0, 2), "bucket 9 by 8 8": (1, 1),
                "wbtrack 9 by 16 16": (0, 1)}[case]
            size = -(-N_FEW // m) * m
            assert prog.bufs.elist.tolist() == escaping + [N_FEW] * (
                size - len(escaping))
            assert L.host_paths == dict.fromkeys(L.host_paths, 0)
        else:
            assert L.host_paths["recompute"] == 1
    assert got[0][1].escaped.nonzero().flatten().tolist() == escaping
    _assert_reference(jnew, jout, bt.state, got[1][1], f"{case} per-tick")
    state_p, out_p = got[0]
    state_t, out_t = got[1]
    for i, (a, b) in enumerate(zip(state_t, state_p)):
        np.testing.assert_array_equal(b, a, err_msg=f"{case} leaf {i}")
    for name, a, b in zip(tft.StepOutput._fields, out_t, out_p):
        np.testing.assert_array_equal(b.numpy(), a.numpy(),
                                      err_msg=f"{case} {name}")
    ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(jnew)]
    for i, (a, b) in enumerate(zip(ref, state_p)):
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=f"{case} leaf {i}")
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-4,
                                       err_msg=f"{case} leaf {i}")


@pytest.mark.parametrize("n", [12, 4097, 10240])
def test_escape_list_follows_the_escaped_flags(n):
    """escape_select's list (the wrapper on the CPU, its twin
    ``escape_list_plain``) past one select CTA's span (``select_blocks``:
    several blocks at 4,097 and 10,240 streams): on many every escaped
    stream, lowest first, padded with N to whole big chunks, and the
    chunk plan (P_CHUNKS big chunks, the small ones [P_TAIL, P_TAILS):
    whole big chunks, one more where more than two small ones are left),
    P_CHUNK zeroed; on few and none the list is left and no chunk
    planned.  Small and big chunks of 8 and 64, 32 and 256; the first and
    the last stream escaping among random ones."""
    from headtrackr_tpu_torch.kernels import schedule as S
    rng = np.random.default_rng(n)
    eb = 8
    assert n < 100 or S.select_blocks(n, eb)[0] > 1
    for m, mb in ((8, 64), (32, 256)):
        for share in (0.0, 0.0005, 0.02, 0.5, 1.0):
            esc = rng.random(n) < share
            if share >= 0.02:
                esc[[0, n - 1]] = True
            nesc = int(esc.sum())
            sel = 0 if nesc == 0 else 1 if nesc <= eb else 2
            size = -(-n // mb) * mb
            elist = torch.full((size,), -1, dtype=torch.int64)
            params = torch.zeros(S.PARAM_WORDS, dtype=torch.int64)
            params[S.P_CHUNK] = 5
            eidx = torch.empty(eb, dtype=torch.int64)
            S.escape_select(torch.from_numpy(esc), eb, eidx, params, elist,
                            m, mb)
            assert int(params[S.P_ESEL]) == sel
            assert int(params[S.P_CHUNK]) == 0
            want, plan = S.escape_list_plain(torch.from_numpy(esc), m, mb)
            big, tail0, tails = plan
            rest = nesc - big * mb  # what the small chunks take
            assert big * mb <= nesc + mb and rest <= S.TAIL_CHUNKS * m
            assert tail0 == big * mb // m and tails * m >= nesc
            assert tails - tail0 <= S.TAIL_CHUNKS
            assert want.tolist() == np.nonzero(esc)[0].tolist() + [n] * (
                size - nesc)
            words = params[[S.P_CHUNKS, S.P_TAIL, S.P_TAILS]].tolist()
            if sel == 2:
                assert torch.equal(elist, want)
                assert tuple(words) == plan
            else:
                assert (elist == -1).all()
                assert words == [0, 0, 0]
