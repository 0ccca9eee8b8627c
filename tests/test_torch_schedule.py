"""The serving program's scheduling (kernels/schedule.py, runtime/serving.py
``_Program``) against the reference package on the CPU.

  * the select kernels' twins, ``tick_select_plain`` and
    ``escape_select_plain``, against a transcription of the reference's
    rule (headtrackr_tpu/runtime/serving.py:357-424 ``auto_step`` and
    :240-284 ``_escape_checked``, in NumPy with the reference's own
    ``jax.lax.top_k``): the branch, the served slots and their order, the
    new pend_age and the escape slots, on random mode, pend_age and escape
    vectors with ties (hypothesis);
  * the select wrappers past the 4,096 streams one CTA once took (N =
    4,097, 10,240, 65,536; on the CPU their twins, which follow the grid
    kernel's stages): the same rule and the one-sort formulation, exact;
  * ``run_scan`` against the reference package's ``run_scan``
    (histKernel="pallas", interpret mode), 6 streams of 120x160, the toy
    cascade, band and bandHist, bucket 1 (chunk_cap 4), overload
    "rotate", escape_bucket 1, through the port's per-tick path and its
    program (the conditional nodes' twins in Python ifs), also with the
    bodies' frame buffer poisoned before each call, and with the many
    escape body's list and chunk slots (``elist``, ``cidx``) poisoned
    before each call (escape_select writes the list on a many tick, the
    chunk's slot_gather its slots, before the chunk reads them): a rotate
    clip (the cold start's burst of more than chunk_cap pending streams)
    and an escape clip (one stream escaping: the ``few`` body; two in one
    tick: ``many``, in chunks of one stream).  Integer and bool fields exact, floats to rtol 1e-5 / atol
    1e-4 (f32 sums in another order), as tests/test_torch_scan.py;
  * the program's frames: ``scan_step_plain``'s rows mode against NumPy,
    and ``histpdf_band`` under ``launch.frames_at`` against the same call
    on the tick's frames.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import headtrackr_tpu as ht
import headtrackr_tpu_torch as pt
from headtrackr_tpu_torch import convert, toy_cascade
from headtrackr_tpu_torch.kernels import launch as L
from headtrackr_tpu_torch.kernels import schedule as S
from headtrackr_tpu_torch.kernels.histpdf import histpdf_band
from headtrackr_tpu_torch.models import facetracker as tft

torch.set_num_threads(2)

WB, VJ, CS = 0, 1, 2


def _top_k(key, k):
    """The reference's top_k, padded with N where the key is 0."""
    vals, idx = jax.lax.top_k(jnp.asarray(key, jnp.int32), k)
    return np.where(np.asarray(vals) > 0, np.asarray(idx), len(key))


def _ref_rule(mode, age, bucket, overload):
    """auto_step's choice (headtrackr_tpu/runtime/serving.py:357-424):
    (branch name, served slots or None, new pend_age, chunks run)."""
    N = len(mode)
    kb = max(1, min(bucket, N))
    entry_non_cs = mode != CS
    npend = int(entry_non_cs.sum())
    npend_vj = int((mode == VJ).sum())
    chunk_cap = max(kb, (min(N, 4 * kb) // kb) * kb)
    key = np.where(entry_non_cs, 1 + age, 0)

    def aged(idx):
        served = np.zeros(N, bool)
        served[idx[idx < N]] = True
        return np.where(entry_non_cs & ~served, age + 1, 0)

    if overload == "rotate":
        names = ["track", "bucket", "chunks", "wbtrack"]
        sel = 0 if npend == 0 else 3 if npend_vj == 0 else \
            1 if npend <= kb else 2
    else:
        names = ["track", "bucket", "chunks", "full", "wbtrack"]
        sel = 0 if npend == 0 else 4 if npend_vj == 0 else \
            1 if npend <= kb else 2 if npend <= chunk_cap else 3
    name = names[sel]
    if name == "bucket":
        idx = _top_k(key, kb)
        return name, idx, aged(idx), 1
    if name == "chunks":
        idx = _top_k(key, chunk_cap)
        nchunks = min((npend + kb - 1) // kb, chunk_cap // kb)
        return name, idx, aged(idx), nchunks
    return name, None, np.zeros(N, age.dtype), 0


def _ref_escape(esc, escape_bucket):
    """_escape_checked's choice (:240-284): (0 none | 1 few | 2 many, the
    few body's slots or None)."""
    N = len(esc)
    eb = max(1, int(escape_bucket))
    nesc = int(esc.sum())
    if nesc == 0:
        return 0, None
    if eb >= N or nesc > eb:
        return 2, None
    return 1, _top_k(esc.astype(np.int32), eb)


@pytest.mark.parametrize("overload", ["full", "rotate"])
@pytest.mark.parametrize("bucket", [1, 4, 32])
@pytest.mark.parametrize("n", [1, 3, 8, 33])
@settings(max_examples=40, deadline=None, database=None, derandomize=True)
@given(data=st.data())
def test_select_twins_follow_the_reference_rule(n, bucket, overload, data):
    mode = np.array(data.draw(st.lists(st.sampled_from([WB, VJ, CS]),
                                       min_size=n, max_size=n)), np.int32)
    age = np.array(data.draw(st.lists(st.integers(0, 3), min_size=n,
                                      max_size=n)), np.int32)
    esc = np.array(data.draw(st.lists(st.booleans(), min_size=n,
                                      max_size=n)), bool)
    eb = data.draw(st.sampled_from([1, 2, 8]))
    kb = max(1, min(bucket, n))
    cap = max(kb, (min(n, 4 * kb) // kb) * kb)
    m = cap // kb
    branch, idx, age_out = S.tick_select_plain(
        torch.from_numpy(mode), torch.from_numpy(age), kb, cap,
        overload == "rotate")
    name, want_idx, want_age, chunks = _ref_rule(mode, age, bucket, overload)
    port = {0: "track", m + 1: "wbtrack", m + 2: "full"}.get(branch)
    if port is None:  # the bucket over `branch` chunks of kb slots
        assert name in ("bucket", "chunks") and branch == chunks
        got = idx.numpy()
        np.testing.assert_array_equal(got[:len(want_idx)], want_idx)
        assert (got[len(want_idx):] == n).all()
    else:
        assert port == name
        assert (idx.numpy() == n).all()
    np.testing.assert_array_equal(age_out.numpy(), want_age)

    sel, eidx = S.escape_select_plain(torch.from_numpy(esc), eb)
    want_sel, want_eidx = _ref_escape(esc, eb)
    assert sel == want_sel
    if sel == 1:
        np.testing.assert_array_equal(eidx.numpy(), want_eidx)
    else:
        assert (eidx.numpy() == n).all()


def test_forced_bucket_keeps_the_hosts_slots_and_pend_age():
    """step_bucket's forced tick: the bucket over the host's slots (force =
    1 + slots; 0 slots: "track"), idx as given, pend_age kept."""
    mode = torch.tensor([CS, VJ, WB, CS], dtype=torch.int32)
    age = torch.tensor([0, 5, 2, 7], dtype=torch.int32)
    idx = torch.tensor([2, 4], dtype=torch.int64)
    for slots, want in ((0, 0), (1, 1), (2, 2)):
        b, i, a = S.tick_select_plain(mode, age, 1, 2, False, 1 + slots, idx)
        assert b == want and i is idx and torch.equal(a, age)


@pytest.mark.parametrize("esc,sel", [([0, 0, 0], 0), ([0, 1, 0], 1),
                                     ([1, 1, 0], 2)])
def test_select_wrappers_count_their_runs(esc, sel):
    """On the CPU the select wrappers run their twins into the parameter
    block as the kernels write it: tick_select its branch, one run in that
    branch's word and k advanced; escape_select its selection and one run
    in its word, "none" too (the launch counters read these words)."""
    mode = torch.tensor([CS, VJ, CS], dtype=torch.int32)
    age = torch.zeros(3, dtype=torch.int32)
    params = torch.zeros(S.PARAM_WORDS, dtype=torch.int64)
    idx = torch.empty(2, dtype=torch.int64)
    age_out = torch.empty(3, dtype=torch.int32)
    S.tick_select(mode, age, 1, 2, False, idx, age_out, params)
    assert int(params[S.P_BRANCH]) == 1 and int(params[S.P_K]) == 1
    assert params[S.P_RUNS:S.P_RUNS + S.ESCAPE_RUNS].tolist() == \
        [0, 1] + [0] * (S.ESCAPE_RUNS - 2)
    eidx = torch.empty(1, dtype=torch.int64)
    S.escape_select(torch.tensor(esc, dtype=torch.bool), 1, eidx, params)
    want = [0, 0, 0]
    want[sel] = 1
    assert int(params[S.P_ESEL]) == sel
    assert params[S.P_RUNS + S.ESCAPE_RUNS:
                  S.P_RUNS + S.ESCAPE_RUNS + 3].tolist() == want


def _one_sort_tick(mode, age, kb, cap, rotate):
    """The select twin's rule in one stable sort of the whole batch (the
    twin before its stages followed the grid's kernel)."""
    n = len(mode)
    m = cap // kb
    non_cs = mode != CS
    npend = int(non_cs.sum())
    if npend == 0:
        branch = 0
    elif not (mode == VJ).any():
        branch = m + 1
    elif npend <= cap or rotate:
        branch = min(-(-npend // kb), m)
    else:
        branch = m + 2
    idx = np.full(cap, n, np.int64)
    age_out = np.zeros(n, np.int32)
    if 1 <= branch <= m:
        order = np.argsort(-np.where(non_cs, 1 + age.astype(np.int64), 0),
                           kind="stable")[:min(npend, cap)]
        idx[:order.size] = order
        served = np.zeros(n, bool)
        served[order] = True
        age_out = np.where(non_cs & ~served, age + 1, 0).astype(np.int32)
    return branch, idx, age_out


# mode draws (WB, VJ, CS): a loss within the chunk cap, a burst past it,
# a cold start (all WB), a steady tick, a mix
_MIXES = [(0.0002, 0.0002, 0.9996), (0.2, 0.2, 0.6), (1.0, 0.0, 0.0),
          (0.0, 0.0, 1.0), (0.001, 0.003, 0.996)]


@pytest.mark.parametrize("rotate", [False, True])
@pytest.mark.parametrize("n", [4097, 10240, 65536])
def test_tick_select_serves_any_batch_as_the_reference(n, rotate):
    """tick_select (the CPU wrapper: its twin, the kernel's stages over
    select_blocks' CTAs and their merge) past the 4,096 streams one CTA
    once took: the branch, the served slots in order and the new pend_age
    equal, exactly, the reference's rule through jax.lax.top_k
    (headtrackr_tpu/runtime/serving.py:366-424) and the one-sort
    formulation, at buckets 8 (the headline), 32 (the default) and 2,048
    (a chunk cap past the grid's shared keys), on numpy-drawn modes and
    ages 0-2 (many ties)."""
    rng = np.random.default_rng(n + rotate)
    overload = "rotate" if rotate else "full"
    for bucket in (8, 32, 2048):
        kb = min(bucket, n)
        cap = max(kb, (min(n, 4 * kb) // kb) * kb)
        m = cap // kb
        for mix in _MIXES:
            mode = rng.choice(3, n, p=mix).astype(np.int32)
            age = rng.integers(0, 3, n).astype(np.int32)
            params = torch.zeros(S.PARAM_WORDS, dtype=torch.int64)
            idx = torch.empty(cap, dtype=torch.int64)
            age_out = torch.empty(n, dtype=torch.int32)
            S.tick_select(torch.from_numpy(mode), torch.from_numpy(age), kb,
                          cap, rotate, idx, age_out, params)
            branch = int(params[S.P_BRANCH])
            where = f"bucket {bucket} mix {mix}"
            want = _one_sort_tick(mode, age, kb, cap, rotate)
            assert branch == want[0], where
            np.testing.assert_array_equal(idx.numpy(), want[1], where)
            np.testing.assert_array_equal(age_out.numpy(), want[2], where)
            name, ref_idx, ref_age, chunks = _ref_rule(mode, age, bucket,
                                                       overload)
            port = {0: "track", m + 1: "wbtrack", m + 2: "full"}.get(branch)
            if port is None:
                assert name in ("bucket", "chunks") and branch == chunks, \
                    where
                np.testing.assert_array_equal(idx.numpy()[:len(ref_idx)],
                                              ref_idx, where)
                assert (idx.numpy()[len(ref_idx):] == n).all(), where
            else:
                assert port == name, where
            np.testing.assert_array_equal(age_out.numpy(), ref_age, where)


def test_select_grid_mirrors_the_kernel():
    """select_blocks (the twins' blocks, the scratch buffer's size) uses
    csrc/schedule.cu's constants, and its grid covers every stream once,
    a CTA's keys within its shared memory, and a bucket tick's merge
    within it wherever the streams allow."""
    import pathlib
    import re
    src = (pathlib.Path(S.__file__).parent.parent / "csrc"
           / "schedule.cu").read_text()
    for name, want in (("kSelThreads", S.SELECT_THREADS),
                       ("kSelKeys", S.SELECT_KEYS),
                       ("kMaxSelCtas", S.SELECT_MAX_CTAS)):
        assert int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1)) == want, name
    for n in (1, 255, 256, 257, 4096, 4097, 10240, 65536, 1 << 20):
        for cap in (1, 8, 32, 128, 4096, 10484):
            ctas, span = S.select_blocks(n, cap)
            assert span % S.SELECT_THREADS == 0 and span <= S.SELECT_KEYS
            assert (ctas - 1) * span < n <= ctas * span
            assert ctas <= S.SELECT_MAX_CTAS
            if n <= S.SELECT_KEYS ** 2 // max(cap, S.SELECT_THREADS):
                assert ctas * cap <= S.SELECT_KEYS or ctas == 1, (n, cap)
    with pytest.raises(ValueError):
        S.select_blocks((1 << 20) + 1, 8)


@pytest.mark.parametrize("n", [4097, 10240, 65536])
def test_escape_select_serves_any_batch_as_the_reference(n):
    """escape_select (the CPU wrapper) past 4,096 streams: none, few or
    many and the few body's slots equal the reference's
    (headtrackr_tpu/runtime/serving.py:250-280, jax.lax.top_k) and the
    escaped streams' indices, at escape buckets 1, 8 and 2,048, on escape
    counts of 0, 1, the bucket, one past it and a numpy-drawn 1%."""
    rng = np.random.default_rng(n)
    for eb in (1, 8, 2048):
        for count in (0, 1, eb, eb + 1, None):
            esc = np.zeros(n, bool)
            if count is None:
                esc = rng.random(n) < 0.01
            else:
                esc[rng.choice(n, count, replace=False)] = True
            params = torch.zeros(S.PARAM_WORDS, dtype=torch.int64)
            eidx = torch.empty(eb, dtype=torch.int64)
            S.escape_select(torch.from_numpy(esc), eb, eidx, params)
            sel = int(params[S.P_ESEL])
            want_sel, want = _ref_escape(esc, eb)
            assert sel == want_sel, (eb, count)
            hit = np.nonzero(esc)[0]
            if sel == 1:
                np.testing.assert_array_equal(eidx.numpy(), want)
                np.testing.assert_array_equal(eidx.numpy()[:hit.size], hit)
            else:
                assert (eidx.numpy() == n).all(), (eb, count)


H, W = 120, 160
N = 6
K = 13
WOBBLE = [0, 2, 2, 4, 6, 6]    # the tick each stream's background settles
FACES = [(50, 45), (110, 50), (60, 70), (80, 60), (100, 80), (40, 60)]
BLUE = {(0, 23), (2, 40)}      # (stream, tick) of the loss frames
TALL = {3: 0, 4: 39}           # stream -> the tick its face outgrows the band
KW = dict(bucket=1, band=(64, 96), bandHist=True, overload="rotate",
          escape_bucket=1)


def _frame(s, t):
    f = np.full((H, W, 3), 40 + (8 if t < WOBBLE[s] and t % 2 else 0),
                np.uint8)
    if (s, t) in BLUE:
        f[...] = (0, 0, 250)
        return f
    cx, cy = FACES[s]
    cx += t % 5
    half = 26 if t >= TALL.get(s, 1 << 30) else 12
    f[cy - half:cy + half, cx - half:cx + half] = (230, 80, 60)
    return f


def _clip(ticks):
    return np.stack([np.stack([_frame(s, t) for s in range(N)])
                     for t in ticks])


@pytest.fixture(scope="module")
def reference():
    """The reference's run_scan over both clips (4 calls of K ticks), its
    outputs a tick and its state after each clip."""
    jb = ht.BatchedTracker(N, (H, W), cascade=ht.toy_cascade(),
                           histKernel="pallas", **KW)
    outs, states = [], []
    for k0 in range(0, 4 * K, K):
        ref = jb.run_scan(_clip(range(k0, k0 + K)))
        outs += [[np.asarray(v)[k] for v in ref] for k in range(K)]
        if k0 % (2 * K):
            states.append([np.asarray(x) for x in
                           jax.tree_util.tree_leaves(jb.state)])
    return outs, states


def _assert_same(ref, got, where):
    for name, a, b in zip(tft.StepOutput._fields, ref, got):
        b = b.numpy()
        a = np.broadcast_to(a, b.shape)
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=f"{where} {name}")
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-4,
                                       err_msg=f"{where} {name}")


@pytest.mark.parametrize("path", ["per_tick", "program", "poison",
                                  "poison_staging"])
@pytest.mark.parametrize("clip", ["rotate", "escape"])
def test_run_scan_matches_reference(reference, clip, path):
    """The poison case is the program with the bodies' frame buffer filled
    with 255 before each call: a body that read a stale or poisoned frame
    where it should read tick k's (in place or copied) would differ, as
    the faces move every tick.  The poison_staging case fills the many
    escape body's list and chunk slots with stream 0 before each call: the
    program must write them on a many tick before its chunks read them.
    The many body runs in small chunks of one stream, one chunk an escaped
    stream.  No body copies a frame: the poisoned buffer stays 255 through
    every call, whose wbtrack, bucket and escape ticks read the tick's
    frames in place."""
    ref_outs, ref_states = reference
    tb = pt.BatchedTracker(N, (H, W), cascade=toy_cascade(), device="cpu",
                           **KW)
    tb._steps.scheduled = path != "per_tick"
    tb._steps.escape_chunk, tb._steps.escape_tail = 4, 1

    def scan(seq):
        if path == "poison":
            tb._steps.buffers(tb.state).frames.fill_(255)
        if path == "poison_staging":
            bufs = tb._steps.program(tb.state).bufs
            for t in (bufs.elist, bufs.cidx, bufs.tidx):
                t.fill_(0)
        return tb.run_scan(seq)

    ticks = range(0, 2 * K) if clip == "rotate" else range(2 * K, 4 * K)
    if clip == "escape":  # the rotate clip first, unchecked
        for k0 in range(0, 2 * K, K):
            scan(_clip(range(k0, k0 + K)))
    runs, entry, escaped = np.zeros(16, int), [], []
    for k0 in range(ticks.start, ticks.stop, K):
        got = scan(torch.as_tensor(_clip(range(k0, k0 + K))))
        assert got.mode_after.shape == (K, N)
        for k in range(K):
            _assert_same(ref_outs[k0 + k], [v[k] for v in got],
                         f"{clip} {path} tick {k0 + k}")
        entry += got.detection.tolist()
        escaped += got.escaped.sum(1).tolist()
        if path != "per_tick":
            prog = tb._steps._programs[N]
            runs += prog.runs
            many = [e for e in got.escaped.sum(1).tolist()
                    if e > KW["escape_bucket"]]
            assert prog.chunks == sum(many)
            if path == "poison":  # nothing copied into the buffer
                assert bool((prog.bufs.frames == 255).all())
    want = ref_states[0 if clip == "rotate" else 1]
    for a, b in zip(want, convert.state_to_numpy(tb.state)):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-4)
    if clip == "rotate":  # a burst beyond chunk_cap, served oldest first
        assert max(int((np.array(m) != CS).sum()) for m in entry) > 4
        assert "bucket" in {tb.branch(np.array(m)) for m in entry}
    else:  # one stream escaping alone, and two in one tick
        assert 1 in escaped and 2 in escaped
    if path != "per_tick":  # each select counts one run a tick
        assert runs[:S.ESCAPE_RUNS].sum() == len(ticks)
        assert runs[S.ESCAPE_RUNS:].sum() == len(ticks)
        assert runs[1:5].sum() > 0
        assert runs[S.ESCAPE_RUNS + 1] > 0
        assert (runs[S.ESCAPE_RUNS + 2] > 0) == (clip == "escape")
    if path != "per_tick":  # all-CS ticks ran beside the bucket ticks
        assert runs[0] > 0


def test_scan_step_plain_rows_mode():
    """scan_step's twin in rows mode: the served slots' rows of the tick
    land in the same rows of the buffer, padding (N) is skipped, other rows
    are untouched; whole mode copies everything; nothing when the tick's
    frames are the buffer."""
    rng = np.random.default_rng(3)
    n = 7
    src = rng.integers(0, 256, (n, 5, 6, 3), dtype=np.uint8)
    before = rng.integers(0, 256, (n, 5, 6, 3), dtype=np.uint8)
    for slots in ([2], [5, 0, 3], [6, n, n], [n, n], [1, 1, 4]):
        frames = torch.from_numpy(before.copy())
        S.scan_step_plain(torch.from_numpy(src), frames,
                          torch.tensor(slots, dtype=torch.int64))
        want = before.copy()
        hit = [r for r in slots if r < n]
        want[hit] = src[hit]
        np.testing.assert_array_equal(frames.numpy(), want, str(slots))
    frames = torch.from_numpy(before.copy())
    S.scan_step_plain(torch.from_numpy(src), frames)
    np.testing.assert_array_equal(frames.numpy(), src)
    S.scan_step_plain(frames, frames, torch.tensor([0]))
    np.testing.assert_array_equal(frames.numpy(), src)


def test_histpdf_band_reads_the_redirected_frames():
    """histpdf_band's pdf mode under launch.frames_at(buffer, seq[k]) equals
    histpdf_band(seq[k]) bit for bit for every tick k, whatever the buffer
    holds (poisoned: 255); a sub-batch of the buffer (index_select) and
    the hist-only mode are not redirected; outside the block the buffer is
    read again."""
    rng = np.random.default_rng(5)
    n, K_, band = 4, 3, (8, 16)
    seq = torch.from_numpy(rng.integers(0, 256, (K_, n, 24, 32, 3),
                                        dtype=np.uint8))
    seq[:, :, 4:14, 6:20] = torch.tensor([230, 80, 60], dtype=torch.uint8)
    buf = torch.full((n, 24, 32, 3), 255, dtype=torch.uint8)
    rects = torch.tensor([[4, 2, 0, 0], [-3, 5, 0, 0], [20, 20, 0, 0],
                          [8, 0, 0, 0]], dtype=torch.int32)
    model = torch.from_numpy(rng.integers(0, 50, (n, 4096))
                             .astype(np.float32))
    for k in range(K_):
        with L.frames_at(buf, seq[k]):
            got = histpdf_band(buf, rects, model, band)
            sub = histpdf_band(buf.index_select(0, torch.arange(n)), rects,
                               model, band)
            counts = histpdf_band(buf, rects)
        want = histpdf_band(seq[k], rects, model, band)
        poisoned = histpdf_band(buf, rects, model, band)
        for a, b in zip(got, want):
            assert torch.equal(a, b), k
        for a, b in zip(sub, poisoned):
            assert torch.equal(a, b), k
        assert torch.equal(counts, histpdf_band(buf, rects))
        assert not torch.equal(poisoned[1], want[1])
