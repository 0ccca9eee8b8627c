"""npz checkpoints (runtime/checkpoint.py) across the two packages, on the CPU.

A file written by the JAX package's ``save_tracker`` loads into the port's
``BatchedTracker`` and the reverse; each resumed tracker's next six ticks
equal the uninterrupted tracker's (integers exact, floats rtol 1e-5 / atol
1e-4).  Also the format's own contract: named leaf paths, v1 positional
files, schema / shape / dtype / metadata errors, and the optional leaves'
defaults (``band_dirty`` defaults dirty).
"""

import numpy as np
import pytest
import torch

import headtrackr_tpu as ht
from headtrackr_tpu.runtime import checkpoint as jck
import headtrackr_tpu_torch as pt
from headtrackr_tpu_torch import convert
from headtrackr_tpu_torch.models import facetracker as tft
from headtrackr_tpu_torch.runtime import checkpoint as tck

torch.set_num_threads(2)

H, W = 120, 160
N = 3
LOCK, RESUME = 17, 6


def _fr(cx, cy):
    f = np.full((H, W, 3), 40, np.uint8)
    f[cy - 12:cy + 12, cx - 12:cx + 12] = (230, 80, 60)
    return f


def _frames(t):
    d = max(0, t - LOCK)  # still while locking, then drifting
    return np.stack([_fr(60 + d, 50), _fr(70, 60 + d), _fr(80 - d, 70)])


def _jax(**kw):
    return ht.BatchedTracker(N, frame_shape=(H, W), cascade=ht.toy_cascade(),
                             **kw)


def _port(**kw):
    return pt.BatchedTracker(N, (H, W), cascade=pt.toy_cascade(),
                             device="cpu", **kw)


def _ticks(bt, start, n):
    return [[np.asarray(v) for v in bt.step_auto(_frames(t))]
            for t in range(start, start + n)]


def _same_ticks(got, want):
    for t, (a_t, b_t) in enumerate(zip(got, want)):
        for name, a, b in zip(tft.StepOutput._fields, a_t, b_t):
            b = np.broadcast_to(b, a.shape)
            if a.dtype.kind in "biu":
                np.testing.assert_array_equal(a, b, err_msg=f"{t} {name}")
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4,
                                           err_msg=f"{t} {name}")


@pytest.fixture(scope="module")
def locked(tmp_path_factory):
    """A JAX and a port tracker locked on the same frames, each saved."""
    d = tmp_path_factory.mktemp("ckpt")
    jb, tb = _jax(), _port()
    for t in range(LOCK):
        jb.step_auto(_frames(t))
        tb.step_auto(_frames(t))
    assert (jb.modes == 2).all() and (tb.modes == 2).all()
    jck.save_tracker(d / "jax.npz", jb)
    tck.save_tracker(d / "port.npz", tb)
    return d, jb, tb


def test_jax_checkpoint_resumes_in_port(locked):
    d, jb, _ = locked
    tb = tck.load_tracker(d / "jax.npz", _port())
    assert (tb.modes == tft.MODE_CS).all()
    got = _ticks(tb, LOCK, RESUME)
    want = _ticks(jb, LOCK, RESUME)  # the uninterrupted reference
    _same_ticks(got, want)
    assert (tb.modes == tft.MODE_CS).all()


def test_port_checkpoint_resumes_in_jax(locked, tmp_path):
    d, _, tb = locked
    jb = jck.load_tracker(d / "port.npz", _jax())
    assert (jb.modes == 2).all()
    ref = tck.load_tracker(d / "port.npz", _port())  # the port's own resume
    got = _ticks(jb, LOCK, RESUME)
    want = _ticks(tb, LOCK, RESUME)  # the uninterrupted port tracker
    _same_ticks(got, want)
    _same_ticks(_ticks(ref, LOCK, RESUME), want)


def test_files_of_both_packages_have_the_same_schema(locked):
    d, _, _ = locked
    with np.load(d / "jax.npz") as a, np.load(d / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert a["__paths__"].tolist() == b["__paths__"].tolist()
        assert int(b["__format__"]) == 2
        assert "state/cs/model_hist" in b.files and "state/mode" in b.files
        for k in a["__paths__"].tolist():
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert b["host_modes"].tolist() == [2] * N


def test_state_round_trip_and_v1(tmp_path):
    tb = _port()
    for t in range(LOCK):
        tb.step_auto(_frames(t))
    p = tmp_path / "st.npz"
    tck.save_state(p, tb.state)
    back = tck.load_state(p, like=_port().state)
    for a, b in zip(convert.state_to_numpy(tb.state),
                    convert.state_to_numpy(back)):
        np.testing.assert_array_equal(a, b)
    # v1: positional leaf_i, validated by leaf count only
    leaves = convert.state_to_numpy(tb.state)
    v1 = tmp_path / "v1.npz"
    np.savez(v1, n_leaves=np.int32(len(leaves)),
             **{f"leaf_{i}": a for i, a in enumerate(leaves)})
    for a, b in zip(leaves, convert.state_to_numpy(
            tck.load_state(v1, like=_port().state))):
        np.testing.assert_array_equal(a, b)
    jstate = jck.load_state(v1, like=_jax().state)  # the reference reads it
    np.testing.assert_array_equal(np.asarray(jstate.cs.window), leaves[4])
    np.savez(v1, n_leaves=np.int32(len(leaves) - 1),
             **{f"leaf_{i}": a for i, a in enumerate(leaves[:-1])})
    with pytest.raises(ValueError, match="v1 checkpoint has"):
        tck.load_state(v1, like=_port().state)
    # the default template: one fresh stream
    one = tmp_path / "one.npz"
    tck.save_state(one, tft.init_state(1, device="cpu"))
    assert int(tck.load_state(one, device="cpu").mode[0]) == tft.MODE_WB


def _edited(src, dst, drop=(), put=None):
    d = dict(np.load(src).items())
    for k in drop:
        del d[k]
    d.update(put or {})
    d["__paths__"] = np.asarray([k for k in d if k.startswith("state/")])
    np.savez_compressed(dst, **d)
    return dst


def test_schema_shape_dtype_and_metadata_errors(locked, tmp_path):
    d, _, _ = locked
    src = d / "jax.npz"
    with pytest.raises(ValueError, match="streams"):
        tck.load_tracker(src, pt.BatchedTracker(
            4, (H, W), cascade=pt.toy_cascade(), device="cpu"))
    with pytest.raises(ValueError, match="frame shape"):
        tck.load_tracker(src, pt.BatchedTracker(
            N, (2 * H, 2 * W), cascade=pt.toy_cascade(), device="cpu"))
    with pytest.raises(ValueError, match="missing"):
        tck.load_tracker(_edited(src, tmp_path / "a.npz", drop=["state/mode"]),
                         _port())
    with pytest.raises(ValueError, match="unknown"):
        tck.load_tracker(_edited(src, tmp_path / "b.npz",
                                 put={"state/extra": np.zeros(N)}), _port())
    with pytest.raises(ValueError, match="shape"):
        tck.load_state(src, like=tft.init_state(1, device="cpu"))
    with pytest.raises(ValueError, match="dtype"):
        tck.load_tracker(_edited(src, tmp_path / "c.npz", put={
            "state/wb_n": np.zeros(N, np.int64)}), _port())


def test_optional_leaves_default(locked, tmp_path):
    """pend_age defaults to 0; band_dirty (absent from a tracker without the
    bandHist audit) defaults dirty in an audited tracker, in both
    packages."""
    d, _, _ = locked
    src = d / "jax.npz"
    aged = _edited(src, tmp_path / "aged.npz", drop=["state/pend_age"])
    tb = tck.load_tracker(aged, _port())
    assert tb.state.pend_age.tolist() == [0] * N
    kw = dict(band=(64, 96), bandHist=True)
    tb = tck.load_tracker(src, _port(**kw))
    assert tb.state.cs.band_dirty.tolist() == [True] * N
    jb = jck.load_tracker(src, _jax(**kw))
    assert np.asarray(jb.state.cs.band_dirty).tolist() == [True] * N
    # and the audited files load in the other package
    jck.save_tracker(tmp_path / "audited.npz", jb)
    tb2 = tck.load_tracker(tmp_path / "audited.npz", _port(**kw))
    assert tb2.state.cs.band_dirty.tolist() == [True] * N


def test_sparse_hist_jax_checkpoint_resumes_in_port(tmp_path):
    """A reference tracker with sparseHist=64 saves its sparse-model leaves
    beside the dense model; the port drops them on load and resumes with
    the reference's ticks."""
    jb = _jax(sparseHist=64)
    for t in range(LOCK):
        jb.step_auto(_frames(t))
    assert (jb.modes == 2).all()
    p = tmp_path / "sparse.npz"
    jck.save_tracker(p, jb)
    with np.load(p) as d:
        assert {"state/cs/model_bins", "state/cs/model_counts",
                "state/cs/model_overflow"} <= set(d["__paths__"].tolist())
    tb = tck.load_tracker(p, _port(sparseHist=64))
    assert (tb.modes == tft.MODE_CS).all()
    _same_ticks(_ticks(tb, LOCK, RESUME), _ticks(jb, LOCK, RESUME))
