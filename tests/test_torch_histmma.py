"""``hist_mma`` (the int8 one-hot histogram, TPU kernel X6) on the CPU: its
plain twin against the JAX package's default histogram formulation
(``histogram_scan`` over the frame, ``histogram_rect`` over a rect), bit for
bit, on seeded random, one-bin and rect-masked frames; the launch split;
and the ``histKernel`` routing (None -> hist_mma, "pallas" -> hist4096,
anything else raises)."""

import numpy as np
import pytest
import torch

from headtrackr_tpu.ops import histogram as jhg
import headtrackr_tpu_torch as pt
from headtrackr_tpu_torch.kernels import histmma, histpdf
from headtrackr_tpu_torch.models import camshift as tcs
from headtrackr_tpu_torch.models import facetracker as tft
from headtrackr_tpu_torch.ops import histogram as hg

torch.set_num_threads(2)


def _frames(kind, n, shape, seed):
    rng = np.random.default_rng(seed)
    H, W = shape
    if kind == "random":
        return rng.integers(0, 256, (n, H, W, 3), dtype=np.uint8)
    if kind == "one_bin":  # every pixel in one bin: the camera-like worst case
        return np.broadcast_to(np.array([120, 100, 90], np.uint8),
                               (n, H, W, 3)).copy()
    f = np.full((n, H, W, 3), 40, np.uint8)  # a face-like blob on a flat bg
    f[:, H // 4:H // 2, W // 3:W // 2] = (230, 80, 60)
    f += rng.integers(0, 8, f.shape, dtype=np.uint8)
    return f


def _jax_scan(frames):
    return np.stack([np.asarray(jhg.histogram_scan(jhg.rgb_bins(f)))
                     for f in frames])


@pytest.mark.parametrize("kind", ["random", "one_bin", "blob"])
@pytest.mark.parametrize("shape", [(120, 160), (57, 99)])
def test_twin_equals_reference_histogram_scan(kind, shape):
    frames = _frames(kind, 3, shape, seed=len(kind))
    got = hg.hist_mma_plain(torch.from_numpy(frames),
                            hg.full_rects(3, shape, "cpu"))
    want = _jax_scan(frames)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the twin for CPU tensors, and equals hist4096's
    np.testing.assert_array_equal(
        hg.histogram_full(torch.from_numpy(frames)).numpy(), want)
    np.testing.assert_array_equal(
        histpdf.hist4096(torch.from_numpy(frames),
                         hg.full_rects(3, shape, "cpu")).numpy(), want)


def test_twin_equals_reference_histogram_rect():
    shape = (57, 99)
    frames = _frames("random", 6, shape, seed=4)
    rects = np.array([[0, 0, 99, 57], [-5, -3, 20, 20], [10, 7, 200, 200],
                      [3, 4, 0, 5], [30, 20, 24, 17], [98, 56, 1, 1]],
                     np.int32)
    got = histmma.hist_mma(torch.from_numpy(frames), torch.from_numpy(rects))
    for f, r, h in zip(frames, rects, got.numpy()):
        want = np.asarray(jhg.histogram_rect(jhg.rgb_bins(f), *r.tolist()))
        np.testing.assert_array_equal(h, want)


def test_split_frame_covers_each_frame():
    for n, npx in [(256, 76800), (1, 76800), (8, 19200), (3, 1), (1, 31),
                   (1000, 100), (7, 5643)]:
        blocks, block_px = histmma.split_frame(n, npx, 132)
        assert block_px % 1024 == 0 and block_px >= 1024  # whole stages
        assert blocks * block_px >= npx > (blocks - 1) * block_px
    # a wave of 4 blocks an SM: two a stream at 256 streams, 75 of one
    # stage each at one stream
    assert histmma.split_frame(256, 76800, 132) == (2, 38912)
    assert histmma.split_frame(128, 76800, 132) == (4, 19456)
    assert histmma.split_frame(1, 76800, 132) == (75, 1024)
    assert histmma.split_frame(600, 76800, 132) == (1, 76800)


def test_hist_kernel_routing(monkeypatch):
    frames = torch.from_numpy(_frames("blob", 2, (24, 32), seed=1))
    calls = []

    def spy(name, fn):
        def wrapped(*a):
            calls.append(name)
            return fn(*a)
        return wrapped

    monkeypatch.setattr(histmma, "hist_mma", spy("hist_mma", histmma.hist_mma))
    monkeypatch.setattr(histpdf, "hist4096", spy("hist4096", histpdf.hist4096))
    a = hg.histogram_full(frames)
    b = hg.histogram_full(frames, "pallas")
    assert calls == ["hist_mma", "hist4096"]
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="histKernel"):
        hg.histogram_full(frames, "triton")
    # the choice travels from the config through make_step to camshift
    calls.clear()
    state = tcs.init_state(2, device="cpu")
    tcs.track(state, frames)
    tcs.track(state, frames, kernel="pallas")
    assert calls == ["hist_mma", "hist4096"]
    cfg = pt.TrackerConfig(histKernel="mxu")
    with pytest.raises(ValueError, match="histKernel"):
        tft.make_step(pt.toy_cascade(), cfg, (24, 32), "track",
                      device="cpu")
    with pytest.raises(ValueError, match="histKernel"):
        pt.BatchedTracker(2, (24, 32), cascade=pt.toy_cascade(),
                          device="cpu", histKernel="mxu")
    calls.clear()
    bt = pt.BatchedTracker(2, (24, 32), cascade=pt.toy_cascade(),
                           device="cpu", band=None, histKernel="pallas")
    bt.state = bt.state._replace(mode=torch.full((2,), tft.MODE_CS,
                                                 dtype=torch.int32))
    bt._modes = np.full((2,), tft.MODE_CS, np.int32)
    bt.step_auto(frames)
    assert calls == ["hist4096"]
