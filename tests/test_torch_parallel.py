"""Stream sharding (parallel/mesh.py, ``BatchedTracker(mesh=...)``) on the CPU.

A CPU mesh names the CPU once a shard (``stream_mesh(["cpu"] * 8)``), the
counterpart of the reference tests' 8 virtual CPU devices.  The 8-stream
host-scheduled case is held against the JAX mesh tracker
(tests/test_parallel.py's case); the rest is the port against itself: the
mesh tracker against the meshless one (device scheduler, host scheduler,
checkpoints across shard counts) and, under overload="rotate", against one
meshless tracker a shard (the reference's shard_map semantics).  Also the
F18 and F19 repairs against the JAX package.  Toy cascade, 120x160 frames,
integers and floats exact unless noted.
"""

import numpy as np
import pytest
import torch

import jax

import headtrackr_tpu as ht
import headtrackr_tpu_torch as pt
from headtrackr_tpu.ops.imageproc import pyramid_spec as jax_pyramid_spec
from headtrackr_tpu.parallel import stream_mesh as jax_stream_mesh
from headtrackr_tpu_torch.models import facetracker as tft
from headtrackr_tpu_torch.ops.imageproc import build_pyramid, pyramid_spec
from headtrackr_tpu_torch.parallel import (gather_streams, shard_streams,
                                           stream_mesh)
from headtrackr_tpu_torch.runtime import checkpoint as tck

torch.set_num_threads(2)

H, W = 120, 160


def _fr(cx, cy):
    f = np.full((H, W, 3), 40, np.uint8)
    f[cy - 12:cy + 12, cx - 12:cx + 12] = (230, 80, 60)
    return f


def _fr_blue():
    f = np.zeros((H, W, 3), np.uint8)
    f[..., 2] = 250
    return f


def _cpu_mesh(k):
    return stream_mesh(["cpu"] * k)


def _port(n, mesh=None, **kw):
    if mesh is None:
        kw["device"] = "cpu"
    return pt.BatchedTracker(n, (H, W), cascade=pt.toy_cascade(), mesh=mesh,
                             **kw)


def _host(out):
    return [np.asarray(v) for v in out]


def _same(a, b, where=""):
    """Two StepOutputs / TrackerStates (trees of tensors) equal leaf for
    leaf, NaN where NaN."""
    la = [v for v in jax.tree_util.tree_leaves(
        tuple(a), is_leaf=torch.is_tensor)]
    lb = [v for v in jax.tree_util.tree_leaves(
        tuple(b), is_leaf=torch.is_tensor)]
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=f"{where} leaf {i}")


def test_stream_mesh_names_its_shards(monkeypatch):
    mesh = _cpu_mesh(8)
    assert mesh.devices.size == 8 and mesh.axis_names == ("streams",)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"devices=\['cpu'\] \* k"):
        stream_mesh()


def test_shard_streams_splits_the_leading_axis():
    mesh = _cpu_mesh(8)
    x = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    parts = shard_streams(x, mesh)
    assert len(parts) == 8
    for j, p in enumerate(parts):
        assert p.device == torch.device("cpu") and p.shape == (1, 4)
        np.testing.assert_array_equal(p.numpy(), x[j:j + 1])
    state = tft.init_state(16, band_audit=True, device="cpu")
    back = gather_streams(shard_streams(state, mesh), torch.device("cpu"))
    _same(back, state)
    assert back.cs.band_dirty is not None
    with pytest.raises(ValueError, match="does not split"):
        shard_streams(np.zeros((9, 4)), mesh)


def test_mesh_rejects_undivisible_batch():
    with pytest.raises(ValueError, match="not divisible"):
        _port(9, _cpu_mesh(8))


def test_mesh_tracker_matches_jax_mesh_and_meshless():
    """tests/test_parallel.py's case: 8 streams, one a shard, host
    scheduler at sync_interval 1, 18 ticks."""
    frames = np.stack([_fr(50 + 4 * i, 40 + 2 * i) for i in range(8)])
    jm = ht.BatchedTracker(8, frame_shape=(H, W), cascade=ht.toy_cascade(),
                           mesh=jax_stream_mesh(), sync_interval=1)
    pm = _port(8, _cpu_mesh(8), sync_interval=1)
    p1 = _port(8, sync_interval=1)
    for _ in range(18):
        out_j = jm.step(frames)
        out_m = pm.step(frames)
        out_1 = p1.step(frames)
    assert jm.modes.tolist() == pm.modes.tolist() == p1.modes.tolist() \
        == [tft.MODE_CS] * 8
    np.testing.assert_array_equal(out_m.face_x.numpy(), np.asarray(out_j.face_x))
    np.testing.assert_allclose(out_m.head_z.numpy(), np.asarray(out_j.head_z),
                               rtol=1e-6)
    _same(out_m, out_1)
    assert len({s.device for s in pm._shards}) == 1 and len(pm._shards) == 8


def _loss_seq(n, t_loss, losses, ticks):
    base = [_fr(50 + (3 * i) % 60, 40 + (2 * i) % 40) for i in range(n)]

    def tick(t):
        fs = list(base)
        if t == t_loss:
            for s in losses:
                fs[s] = _fr_blue()
        return np.stack(fs)

    return np.stack([tick(t) for t in range(ticks)])


def test_mesh_run_scan_with_losses_and_reset_equals_meshless():
    """tests/test_parallel.py's serving shape: 32 streams on 8 shards, a
    device-scheduled scan with losses on two shards at tick 20, a
    reset_stream, 16 more ticks: every leaf and the state equal."""
    seq = _loss_seq(32, 20, (5, 29), 30)
    bm, b1 = _port(32, _cpu_mesh(8)), _port(32)
    out_m, out_1 = bm.run_scan(seq), b1.run_scan(seq)
    bm.reset_stream(11)
    b1.reset_stream(11)
    assert bm.modes[11] == b1.modes[11] == tft.MODE_WB
    out_m2, out_12 = bm.run_scan(seq[-16:]), b1.run_scan(seq[-16:])
    _same(out_m, out_1, "scan 1")
    _same(out_m2, out_12, "scan 2")
    _same(bm.state, b1.state, "state")
    st = out_m.status.numpy()
    assert (st[20, [5, 29]] & tft.STATUS_REDETECTING).all()
    assert not (st[20, [4, 6, 28]] & tft.STATUS_REDETECTING).any()
    assert bm.modes.tolist() == b1.modes.tolist()
    assert bm.modes[[5, 29]].tolist() == [tft.MODE_CS] * 2
    assert bm.stream_info(29) == b1.stream_info(29)


def test_mesh_rotate_equals_independent_shard_trackers():
    """overload="rotate" with 6 and 5 losses on two shards of 8 (chunk cap
    4 at bucket 1): each shard serves its own oldest pending streams, as
    two meshless trackers of 8 do."""
    n = 16
    seq = _loss_seq(n, 19, (0, 1, 2, 4, 6, 7, 8, 10, 11, 13, 15), 28)
    kw = dict(bucket=1, overload="rotate")
    bm = _port(n, _cpu_mesh(2), **kw)
    halves = [_port(n // 2, **kw) for _ in range(2)]
    rotated = False
    for f in seq:
        out = bm.step_auto(f)
        want = [h.step_auto(f[j * 8:(j + 1) * 8]) for j, h in enumerate(halves)]
        _same(out, tft.StepOutput(*(torch.cat(v) for v in zip(*want))))
        rotated |= bool((bm.state.pend_age > 0).any())
    assert rotated
    _same(bm.state, gather_streams([h.state for h in halves],
                                   torch.device("cpu")))
    assert (bm.modes == tft.MODE_CS).all()


def test_mesh_host_step_equals_meshless():
    """The host scheduler at sync_interval 8: a global mode view, the
    bucket clamped to a shard's 4 streams; 6 losses (more than the bucket:
    "full" on every shard), then 3 (the bucket split by shard)."""
    n = 16
    seq = np.concatenate([_loss_seq(n, 24, (0, 5, 6, 9, 14, 15), 32),
                          _loss_seq(n, 2, (3, 8, 13), 14)])
    bm = _port(n, _cpu_mesh(4), sync_interval=8)
    b1 = _port(n, sync_interval=8, bucket=4)
    assert bm.bucket == b1.bucket == 4
    for t, f in enumerate(seq):
        _same(bm.step(f), b1.step(f), f"tick {t}")
    _same(bm.state, b1.state, "state")
    assert bm.modes.tolist() == b1.modes.tolist() == [tft.MODE_CS] * n


def test_f18_mesh_none_and_mesh_with_device():
    frames = np.stack([_fr(60, 50), _fr(90, 70)])
    a = pt.BatchedTracker(2, (H, W), cascade=pt.toy_cascade(), device="cpu")
    b = pt.BatchedTracker(2, (H, W), cascade=pt.toy_cascade(), device="cpu",
                          mesh=None)
    assert type(b) is pt.BatchedTracker and b.mesh is None
    for _ in range(18):
        _same(a.step_auto(frames), b.step_auto(frames))
    clips = [np.stack([f] * 18) for f in frames]
    sa = pt.BatchedSession(2, sources=clips, frame_shape=(H, W),
                           cascade=pt.toy_cascade(), device="cpu")
    sb = pt.BatchedSession(2, sources=clips, frame_shape=(H, W),
                           cascade=pt.toy_cascade(), device="cpu", mesh=None)
    sm = pt.BatchedSession(2, sources=clips, frame_shape=(H, W),
                           cascade=pt.toy_cascade(), mesh=_cpu_mesh(2))
    assert sb.tracker.mesh is None and sm.tracker.mesh.devices.size == 2
    assert sa.run(sync=True) == sb.run(sync=True) == sm.run(sync=True) == 18
    assert sa.fanout.status == sb.fanout.status == sm.fanout.status
    _same(sa.tracker.state, sb.tracker.state)
    _same(sa.tracker.state, sm.tracker.state)
    with pytest.raises(ValueError, match="not both"):
        pt.BatchedTracker(2, (H, W), cascade=pt.toy_cascade(),
                          mesh=_cpu_mesh(2), device="cpu")


def test_checkpoint_migrates_across_shard_counts(tmp_path):
    """tests/test_checkpoint.py's migration: a file saved from 8 shards
    loads into 8 shards, none and 2; a meshless file loads into 8; each
    continues with the same outputs."""
    n = 8
    frames = np.stack([_fr(50 + 4 * i, 40 + 2 * i) for i in range(n)])
    src = {}
    for name, mesh in (("mesh8", _cpu_mesh(8)), ("none", None)):
        bt = _port(n, mesh, sync_interval=1)
        for _ in range(18):
            bt.step(frames)
        assert (bt.modes == tft.MODE_CS).all()
        src[name] = tmp_path / f"{name}.npz"
        tck.save_tracker(src[name], bt)
    outs = []
    for name, k in (("mesh8", 8), ("mesh8", None), ("mesh8", 2),
                    ("none", 8)):
        bt = _port(n, k and _cpu_mesh(k), sync_interval=1)
        tck.load_tracker(src[name], bt)
        assert (bt.modes == tft.MODE_CS).all()
        if k:
            assert [s.n for s in bt._shards] == [n // k] * k
        outs.append(_host(bt.step(frames, sync=True)))
        assert (bt.modes == tft.MODE_CS).all()
    for got in outs[1:]:
        for a, b in zip(outs[0], got):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["frontalface", "toy_cascade"])
def test_f19_cascade_helpers_equal_the_reference(name):
    jc, pc = getattr(ht, name)(), getattr(pt, name)()
    assert pc.n_weak == jc.n_weak
    assert [pc.stage_slice(s) for s in range(pc.count)] == \
        [jc.stage_slice(s) for s in range(jc.count)]
    assert pc.stage_slice(pc.count - 1)[1] == pc.n_weak


def test_f19_plane_key_equals_the_reference():
    ps, js = pyramid_spec(320, 240), jax_pyramid_spec(320, 240)
    assert len(ps.dims) == len(js.dims)
    for i, _ in ps.dims:
        for q in range(4):
            assert ps.plane_key(i, q) == js.plane_key(i, q) == i * 4 + q
    assert ps.plane_key(3) == js.plane_key(3)
    pyr, spec = build_pyramid(torch.zeros((1, 48, 64), dtype=torch.uint8))
    top = spec.scale_upto + 2 * spec.next
    want = {spec.plane_key(i) for i in range(top)} | {
        spec.plane_key(i, q) for i in range(2 * spec.next, top)
        for q in (1, 2, 3)}
    assert set(pyr) == want
