"""The kernel wrappers past 65,535 streams (kernels/histpdf.py, histmma.py,
pyramid.py, cascade.py) on the CPU: the launches each makes on the card.

Each of these kernels puts the stream on the grid's y dimension, which
takes at most 65,535, so each wrapper splits a larger batch into launches
of at most that many (kernels/histbins.py ``row_chunks``, which
``hist_bins`` and ``pdf_bins`` already split by).  Here the card path of
each wrapper runs on CPU tensors with its launcher recorded instead of
called (``on_cuda`` made true, ``torch.cuda.device`` a no-op), at N =
65,535, 65,536 and 70,000 streams of tiny frames: one launch a chunk,
chunks covering the batch in order, every pointer advanced by the chunk's
first stream's rows (``histpdf_band`` reading in place: the frames'
address word unchanged and the byte offset of the chunk's first frame),
every launch's stream count within the grid.  The launchers themselves
refuse more (csrc; tests/test_torch_cuda.py on the card).  The tick's
PyTorch frame ops that a large batch would copy whole in a wide type
(``whitebalance``, ``grayscale``) keep their temporaries bounded and equal
the reference's values."""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headtrackr_tpu.ops import imageproc as jip

from headtrackr_tpu_torch import toy_cascade
from headtrackr_tpu_torch.cascade import frontalface
from headtrackr_tpu_torch.kernels import cascade as KC
from headtrackr_tpu_torch.kernels import histmma as KM
from headtrackr_tpu_torch.kernels import histpdf as KH
from headtrackr_tpu_torch.kernels import launch as L
from headtrackr_tpu_torch.kernels import pyramid as KP
from headtrackr_tpu_torch.kernels.histbins import MAX_ROWS, row_chunks
from headtrackr_tpu_torch.models.detector import detector_tables
from headtrackr_tpu_torch.ops import imageproc as ip

NS = (65_535, 65_536, 70_000)
H, W = 2, 16


@pytest.mark.parametrize("n", NS)
def test_row_chunks_split_rule(n):
    """Chunks of at most 65,535 streams, in order, covering the batch;
    ``most`` caps them further (the cascade's work list)."""
    want = {65_535: [(0, 65_535)],
            65_536: [(0, 65_535), (65_535, 65_536)],
            70_000: [(0, 65_535), (65_535, 70_000)]}[n]
    assert MAX_ROWS == 65_535 and row_chunks(n) == want
    capped = row_chunks(n, 30_000)
    assert capped[0][0] == 0 and capped[-1][1] == n
    assert all(0 < r1 - r0 <= 30_000 for r0, r1 in capped)
    assert all(a[1] == b[0] for a, b in zip(capped, capped[1:]))


@pytest.fixture
def recorded(monkeypatch):
    """The wrappers' card paths on CPU tensors, each launch recorded as
    (launcher, args)."""
    calls = []

    def rec(key, fn, *args):
        calls.append((fn, args))

    for mod, names in ((KH, ("_launch", "_on_cuda", "_sm_count")),
                       (KM, ("launch", "on_cuda", "sm_count")),
                       (KP, ("launch", "on_cuda", "sm_count")),
                       (KC, ("launch", "on_cuda", "sm_count"))):
        monkeypatch.setattr(mod, names[0], rec)
        monkeypatch.setattr(mod, names[1], lambda *t: True)
        monkeypatch.setattr(mod, names[2], lambda dev: 132)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    return calls


def _check(calls, fn, n, ptrs, count_at):
    """The launches of ``fn``: one a chunk of row_chunks(n), in order, the
    args at ``ptrs`` (index -> (tensor, bytes a stream)) advanced by r0
    streams, the stream count at ``count_at``."""
    got = [a for f, a in calls if f == fn]
    chunks = row_chunks(n)
    assert len(got) == len(chunks), fn
    for (r0, r1), args in zip(chunks, got):
        assert args[count_at] == r1 - r0 <= MAX_ROWS, fn
        for i, (t, row) in ptrs.items():
            assert args[i] == t.data_ptr() + r0 * row, (fn, i, r0)


@pytest.mark.parametrize("n", NS)
def test_histpdf_wrappers_split(recorded, n):
    frames = torch.zeros((n, H, W, 3), dtype=torch.uint8)
    rects = torch.zeros((n, 4), dtype=torch.int32)
    weights = torch.zeros((n, 4096), dtype=torch.float32)
    fb, tb = H * W * 3, 4096 * 4
    out = KH.hist4096(frames, rects)
    _check(recorded, "hist4096_launch", n, {0: (frames, fb), 1: (rects, 16),
                                             2: (out, tb)}, 3)
    recorded.clear()
    pdf = KH.backproject(frames, weights)
    _check(recorded, "backproject_launch", n,
           {0: (frames, fb), 1: (weights, tb), 2: (pdf, 4 * H * W)}, 3)
    recorded.clear()
    pdf = KH.backproject(frames, weights, rects, (1, 8))
    _check(recorded, "backproject_rect_launch", n,
           {0: (frames, fb), 1: (weights, tb), 2: (rects, 16),
            3: (pdf, 4 * 8)}, 4)
    recorded.clear()
    cur, pdf = KH.histpdf_band(frames, rects, weights, (1, 8))
    _check(recorded, "histpdf_band_launch", n,
           {0: (frames, fb), 1: (rects, 16), 2: (weights, tb), 3: (cur, tb),
            4: (pdf, 4 * 8)}, 5)
    assert all(a[11] == 0 for _, a in recorded)  # no address word
    recorded.clear()
    word = torch.zeros((1,), dtype=torch.int64)
    with L.frames_at(frames, word):
        KH.histpdf_band(frames, rects, weights, (1, 8))
    got = [a for _, a in recorded]
    assert [(a[11], a[12]) for a in got] == [
        (word.data_ptr(), r0 * fb) for r0, _ in row_chunks(n)]
    recorded.clear()
    KH.histpdf_band(frames, rects)
    _check(recorded, "hist4096_launch", n, {0: (frames, fb)}, 3)


@pytest.mark.parametrize("n", NS)
def test_hist_mma_splits(recorded, n):
    frames = torch.zeros((n, H, W, 3), dtype=torch.uint8)
    rects = torch.zeros((n, 4), dtype=torch.int32)
    out = KM.hist_mma(frames, rects)
    _check(recorded, "hist_mma_launch", n,
           {0: (frames, H * W * 3), 1: (rects, 16), 3: (out, 4096 * 4)}, 4)
    # the chunks run in turn on one scratch of partial counts
    assert len({a[2] for _, a in recorded}) == 1


@pytest.mark.parametrize("n", NS)
def test_pyramid_splits(recorded, n):
    tables = detector_tables(32, 32, toy_cascade(), 5, device="cpu")
    gray = torch.zeros((n, 32, 32), dtype=torch.uint8)
    out = KP.pyramid(gray, tables)
    _check(recorded, "pyramid_launch", n,
           {0: (gray, 32 * 32), 2: (out, tables.L)}, 9)
    if tables.plan.S:  # the scratch planes, a row a stream
        starts = [a[1] for _, a in recorded]
        assert [s - starts[0] for s in starts] == [
            r0 * tables.plan.S for r0, _ in row_chunks(n)]


@pytest.mark.parametrize("n", NS)
def test_cascade_splits(recorded, n):
    """The dense and deep launches a chunk (each chunk's bitmap rows,
    candidate confidences and buffer rows; the shared list and count), the
    compaction once over the batch."""
    tables = detector_tables(32, 32, frontalface(), 5, device="cpu")
    buf = torch.zeros((n, tables.L), dtype=torch.uint8)
    KC.cascade(buf, tables, 1)
    chunks = row_chunks(n, KC._LIST_MAX // max(tables.M, 1))
    assert chunks == row_chunks(n)
    dense = [a for f, a in recorded if f == "cascade_dense_launch"]
    deep = [a for f, a in recorded if f == "cascade_deep_launch"]
    compact = [a for f, a in recorded if f == "cascade_compact_launch"]
    assert len(dense) == len(deep) == len(chunks) and len(compact) == 1
    assert compact[0][9] == n
    words = -(-tables.M // 32)
    for (r0, r1), a, b in zip(chunks, dense, deep):
        bits, count, conf, work, m = a[15:20]
        assert m == r1 - r0 and b[16:21] == (bits, count, conf, work, m)
        assert a[14] == b[0] == buf.data_ptr() + r0 * tables.L
        assert bits - dense[0][15] == 4 * r0 * words
        assert conf - dense[0][17] == 4 * r0 * tables.M
        assert count == dense[0][16] and work == dense[0][18]
    np.testing.assert_array_equal([a[19] for a in dense],
                                  [r1 - r0 for r0, r1 in chunks])


def test_frame_ops_bounded_equal_reference(monkeypatch):
    """``whitebalance`` summed a slice of 5 streams at a time (its integer
    sums, then f64) equals its one f64 sum over the batch bit for bit and
    the reference's f32 mean (headtrackr_tpu/ops/imageproc.py) to rtol
    1e-6, as tests/test_torch_imageproc.py holds it; ``grayscale`` in
    int16 equals the reference's bit for bit; random frames with the
    all-255 extreme among them."""
    rng = np.random.default_rng(21)
    x = rng.integers(0, 256, (37, 24, 32, 3), dtype=np.uint8)
    x[3] = 255
    monkeypatch.setattr(ip, "_WB_SLICE_BYTES", 5 * 3 * 24 * 32 * 4)
    got = ip.whitebalance(torch.from_numpy(x)).numpy()
    m = torch.from_numpy(x).sum(dim=(1, 2), dtype=torch.float64) / (24 * 32)
    np.testing.assert_array_equal(
        got, ((m[:, 0] + m[:, 1] + m[:, 2]) / 3.0).float().numpy())
    np.testing.assert_allclose(
        got, np.asarray(jnp.stack([jip.whitebalance(jnp.asarray(f))
                                   for f in x])), rtol=1e-6)
    np.testing.assert_array_equal(ip.grayscale(torch.from_numpy(x)).numpy(),
                                  np.asarray(jip.grayscale(jnp.asarray(x))))
