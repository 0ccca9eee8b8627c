"""The relock tick's device form (runtime/serving.py ``_Steps.bucket_device``,
the serving program's bucket body for the bucket and chunk ticks on the
card) run on the CPU without capture:

- ``BatchedTracker.step_auto`` through the program's CPU twin
  (``_Steps.scheduled``)
  equals the eager ticks bit for bit over a clip with a cold start, a lock,
  losses and relocks (bucket ticks of one pending stream, chunk ticks of
  several), with and without a band (escapes every band tick), and on a
  mesh of two CPU shards;
- one ``bucket_device`` call, its sub-batch merged into the track pass's
  results as scan_commit merges it (the twin, ``scan_commit_plain``, by
  its slots), equals the eager ``bucket_tick``, with a stream in CS among
  the slots (dropped) and padding slots;
- under a ``TorchDispatchMode`` the device form dispatches no op that reads
  the host (``_local_scalar_dense``, ``item``, ``nonzero``, ``equal``,
  ``is_nonzero``, ``masked_select``, ``index`` with a bool mask) outside the
  kernels' wrappers: each ``*_plain`` twin stands for its kernel's one
  launch on the card, and the cascade's twin compacts on the host, which the
  kernel does not.

Per stream against the reference package's ``step_auto``:
tests/test_torch_serving_band.py runs the program over its clip
beside the reference tracker it already compiles."""

import inspect

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import headtrackr_tpu_torch as pt
import headtrackr_tpu_torch.kernels as kernels_pkg
from headtrackr_tpu_torch.models import facetracker as tft
from headtrackr_tpu_torch.parallel.mesh import stream_mesh

torch.set_num_threads(2)

H, W, N = 120, 160, 6
TICKS = 34
SETTLE = [0, 3, 7, 7, 12, 9]  # the tick each stream's brightness settles
BLUE = {(0, 24), (1, 24), (2, 24), (4, 28)}  # loss frames: 3 at once, 1


def _frame(s, t):
    bg = 40 + (8 if t < SETTLE[s] and t % 2 else 0)
    f = np.full((H, W, 3), bg, np.uint8)
    if (s, t) in BLUE:
        f[...] = (0, 0, 250)
        return f
    cx, cy = 40 + 16 * s + t % 5, 50 + 4 * s
    half = 26 if s == 3 else 12  # stream 3 outgrows a 64-row band
    f[cy - half:cy + half, cx - half:cx + half] = (230, 80, 60)
    return f


def _clip():
    return np.stack([np.stack([_frame(s, t) for s in range(N)])
                     for t in range(TICKS)])


def _tracker(scheduled, **kw):
    if "mesh" not in kw:
        kw["device"] = "cpu"
    bt = pt.BatchedTracker(N, (H, W), cascade=pt.toy_cascade(), bucket=2,
                           **kw)
    for s in (bt._shards if bt.mesh is not None else [bt]):
        s._steps.scheduled = scheduled
    return bt


def _outputs(bt, clip):
    rows, branches = [], []
    for frames in clip:
        branches.append(bt.branch(bt.modes))
        rows.append([v.numpy() for v in bt.step_auto(frames)])
    return rows, branches


@pytest.mark.parametrize("kw", [{}, dict(band=(64, 96), bandHist=True)],
                         ids=["frame", "band"])
def test_replayed_ticks_equal_eager_ticks(kw):
    clip = _clip()
    want, branches = _outputs(_tracker(False, **kw), clip)
    got, _ = _outputs(_tracker(True, **kw), clip)
    for t, (a_t, b_t) in enumerate(zip(want, got)):
        for name, a, b in zip(tft.StepOutput._fields, a_t, b_t):
            np.testing.assert_array_equal(b, a, err_msg=f"tick {t} {name}")
    det = np.stack([r[tft.StepOutput._fields.index("detection")]
                    for r in want])
    pending = (det != tft.MODE_CS).sum(1)
    ticks = [t for t, b in enumerate(branches) if b == "bucket"]
    assert any(pending[t] == 1 for t in ticks)   # a bucket tick
    assert any(pending[t] > 2 for t in ticks)    # a chunk tick (bucket 2)
    assert det[25, 0] == tft.MODE_VJ and det[-1].tolist() == [2] * N
    if kw:
        esc = np.stack([r[tft.StepOutput._fields.index("escaped")]
                        for r in want])
        assert esc[ticks, 3].any()  # escapes merged beside a bucket


def test_replayed_ticks_on_a_cpu_mesh_equal_meshless():
    clip = _clip()[:20]
    want, _ = _outputs(_tracker(False), clip)
    got, _ = _outputs(_tracker(True, mesh=stream_mesh(["cpu"] * 2)), clip)
    for t, (a_t, b_t) in enumerate(zip(want, got)):
        for name, a, b in zip(tft.StepOutput._fields, a_t, b_t):
            np.testing.assert_array_equal(b, a, err_msg=f"tick {t} {name}")


def _locked_state():
    """A state with streams in CS, VJ and WB, and its frames."""
    bt = _tracker(False)
    clip = _clip()
    for frames in clip[:20]:
        bt.step_auto(frames)
    state = bt.state._replace(mode=torch.tensor(
        [tft.MODE_CS, tft.MODE_VJ, tft.MODE_CS, tft.MODE_WB, tft.MODE_CS,
         tft.MODE_VJ], dtype=torch.int32))
    return bt, state, torch.as_tensor(clip[20])


def test_bucket_device_equals_eager_bucket_tick():
    bt, state, frames = _locked_state()
    steps = bt._steps
    # stream 0 stays in CS after the track pass (dropped); streams 2 and 4
    # lose track in it (the mode vector above is not their state's), and
    # stream 2, named, is served; N pads the slots
    idx = torch.tensor([0, 1, 2, 3, 5, N], dtype=torch.int64)
    new, out, merge = steps.bucket_device(state, frames, idx)
    assert merge.keep.tolist() == [False, True, True, True, True, False]
    new, out = _merged(new, merge.state, merge), _merged(out, merge.out,
                                                         merge)
    want_state, want_out = steps.bucket_tick(state, frames,
                                             np.array([0, 1, 2, 3, 5]))
    for name, a, b in zip(tft.StepOutput._fields, want_out, out):
        np.testing.assert_array_equal(b.numpy(), a.numpy(), err_msg=name)
    for a, b in zip(tft.TrackerState._fields, range(len(want_state))):
        x, y = want_state[b], new[b]
        if isinstance(x, tuple):
            for u, v in zip(x, y):
                assert u is None or torch.equal(u, v), a
        else:
            assert torch.equal(x, y), a
    # served streams report the mode they entered the full step in
    assert out.detection.tolist() == [2, 1, 1, 0, 2, 1]
    assert new.mode[0] == tft.MODE_CS and new.mode[4] == tft.MODE_VJ


def _merged(tree, sub, merge):
    """``tree`` (N rows) with the rows ``merge`` keeps taken from ``sub``,
    as the program's commit merges a bucket body's sub-batch."""
    from headtrackr_tpu_torch.kernels.schedule import Slots, scan_commit_plain
    leaves = [t.clone() for t in steps_leaves(tree)]
    scan_commit_plain(None, [(None, d, s) for d, s in
                             zip(leaves, steps_leaves(sub))], [],
                      Slots(merge.idx, merge.keep))
    it = iter(leaves)

    def rebuild(t):
        if isinstance(t, tuple):
            return type(t)(*(rebuild(v) for v in t))
        return None if t is None else next(it)
    return rebuild(tree)


def test_step_bucket_replayed_equals_eager_and_keeps_pend_age():
    """``_Steps.bucket_step`` (the functional step_bucket: the program
    forced to its bucket body, then the read) equals ``bucket_tick`` and
    keeps the
    caller's ``pend_age``; with donate=False the caller's state is
    untouched."""
    bt, state, frames = _locked_state()
    state = state._replace(pend_age=torch.arange(N, dtype=torch.int32))
    steps = bt._steps
    want_state, want_out = steps.bucket_tick(state, frames, np.array([1, 3]))
    before = [t.clone() for t in steps_leaves(state)]
    steps.scheduled = True
    new, out = steps.bucket_step(state, frames, np.array([1, 3]),
                                  donate=False)
    for a, b in zip(before, steps_leaves(state)):
        assert torch.equal(a, b)
    for name, a, b in zip(tft.StepOutput._fields, want_out, out):
        np.testing.assert_array_equal(b.numpy(), a.numpy(), err_msg=name)
    for a, b in zip(steps_leaves(want_state), steps_leaves(new)):
        assert torch.equal(a, b)
    assert new.pend_age.tolist() == list(range(N))


def steps_leaves(tree):
    from headtrackr_tpu_torch.runtime.serving import _leaves
    return _leaves(tree)


HOST_READS = {"aten::_local_scalar_dense", "aten::item", "aten::nonzero",
              "aten::equal", "aten::is_nonzero", "aten::masked_select"}


class _HostReads(TorchDispatchMode):
    """Records the ops that read the host, except inside ``opaque``."""

    def __init__(self):
        super().__init__()
        self.seen = []
        self.opaque = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name
        bad = name in HOST_READS or (name == "aten::index" and any(
            t is not None and t.dtype == torch.bool for t in args[1]))
        if bad and not self.opaque:
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


def _opaque_twins(monkeypatch, mode):
    """Wrap every kernel wrapper module's ``*_plain`` twin so that the mode
    ignores what it dispatches (it stands for the kernel's launch)."""
    import importlib
    import pkgutil
    wrapped = 0
    for info in pkgutil.iter_modules(kernels_pkg.__path__):
        mod = importlib.import_module(f"{kernels_pkg.__name__}.{info.name}")
        for name, fn in list(vars(mod).items()):
            if name.endswith("_plain") and inspect.isfunction(fn):
                def twin(*a, _fn=fn, **k):
                    mode.opaque += 1
                    try:
                        return _fn(*a, **k)
                    finally:
                        mode.opaque -= 1
                monkeypatch.setattr(mod, name, twin)
                wrapped += 1
    assert wrapped >= 8


@pytest.mark.parametrize("kw", [{}, dict(band=(64, 96), bandHist=True)],
                         ids=["frame", "band"])
def test_device_form_reads_no_host(monkeypatch, kw):
    bt, state, frames = _locked_state()
    steps = pt.BatchedTracker(N, (H, W), cascade=pt.toy_cascade(),
                              device="cpu", bucket=2, **kw)._steps
    if kw:
        state = state._replace(cs=state.cs._replace(
            band_dirty=torch.zeros((N,), dtype=torch.bool)))
    idx = torch.tensor([1, 2, 3, 5, N, N], dtype=torch.int64)
    with _HostReads() as probe:
        torch.tensor([1.0]).item()
    assert probe.seen == ["aten::_local_scalar_dense"]  # the probe sees reads
    mode = _HostReads()
    _opaque_twins(monkeypatch, mode)
    with mode:
        steps.bucket_device(state, frames, idx)
        steps._auto_track(state, frames)
    assert mode.seen == []
