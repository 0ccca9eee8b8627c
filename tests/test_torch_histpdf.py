"""The port's histogram/backprojection kernels' plain twins against the
reference package's Pallas kernels (interpret mode on the CPU, as
tests/test_kernels.py runs them): bit-exact, batched over streams."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headtrackr_tpu.kernels.histpdf import hist_pallas, pdf_pallas
from headtrackr_tpu.ops import histogram as jhg
from headtrackr_tpu_torch.kernels import histpdf as K
from headtrackr_tpu_torch.kernels.launch import launches
from headtrackr_tpu_torch.ops import histogram as thg

torch.set_num_threads(2)


@pytest.mark.parametrize("shape", [(240, 320), (120, 160), (57, 99)])
def test_hist_and_pdf_twins_match_pallas(shape, rng):
    N = 2
    rgb = rng.integers(0, 256, (N,) + shape + (3,), np.uint8)
    rgb[0, : shape[0] // 2] = (120, 100, 90)  # a flat region: one hot bin
    w = rng.random((N, 4096)).astype(np.float32)
    bins = jax.vmap(jhg.rgb_bins)(jnp.asarray(rgb))
    want_h = np.asarray(jax.vmap(hist_pallas)(bins))
    want_p = np.asarray(jax.vmap(pdf_pallas)(bins, jnp.asarray(w)))

    frames = torch.as_tensor(rgb)
    np.testing.assert_array_equal(thg.rgb_bins(frames).numpy(),
                                  np.asarray(bins))
    got_h = K.hist4096(frames, thg.full_rects(N, shape, "cpu"))
    got_p = K.backproject(frames, torch.as_tensor(w))
    assert got_h.dtype == torch.float32 and got_p.dtype == torch.float32
    np.testing.assert_array_equal(got_h.numpy(), want_h)
    np.testing.assert_array_equal(got_p.numpy(), want_p)


def test_histogram_rect_matches_reference(rng):
    H, W = 57, 99
    rgb = rng.integers(0, 256, (4, H, W, 3), np.uint8)
    rects = np.array([[5, 7, 12, 9], [-3, -2, 20, 10], [80, 40, 40, 40],
                      [0, 0, 0, 5]], np.int32)
    want = np.stack([np.asarray(jhg.histogram_rect(
        jhg.rgb_bins(jnp.asarray(f)), *map(int, r))) for f, r in zip(rgb, rects)])
    got = thg.histogram_rects(torch.as_tensor(rgb), torch.as_tensor(rects))
    np.testing.assert_array_equal(got.numpy(), want)


def test_ops_histogram_rect_has_the_reference_signature(rng):
    """``ops.histogram_rect(bins, x, y, w, h, block=None)`` as the
    reference's: one (H, W) bin image and a rect, bit-exact, rects past
    every edge included; and batched, a rect per stream."""
    import headtrackr_tpu.ops as jops
    import headtrackr_tpu_torch.ops as tops
    H, W = 57, 99
    rgb = rng.integers(0, 256, (4, H, W, 3), np.uint8)
    rgb[0, :20] = (120, 100, 90)
    rects = np.array([[5, 7, 12, 9], [-3, -2, 20, 10], [80, 40, 40, 40],
                      [0, 0, 0, 5]], np.int32)
    bins = thg.rgb_bins(torch.as_tensor(rgb))
    want = np.stack([np.asarray(jops.histogram_rect(
        jhg.rgb_bins(jnp.asarray(f)), *map(int, r)))
        for f, r in zip(rgb, rects)])
    for (b, r), w in zip(zip(bins, rects), want):
        got = tops.histogram_rect(b, *map(int, r), block=512)
        assert got.shape == (4096,) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), w)
    got = tops.histogram_rect(bins, *torch.as_tensor(rects).T)
    np.testing.assert_array_equal(got.numpy(), want)


def test_backprojection_weights_bit_exact(rng):
    m = rng.integers(0, 50, (3, 4096)).astype(np.float32)
    c = rng.integers(0, 50, (3, 4096)).astype(np.float32)
    c[:, :100] = 0
    want = np.asarray(jhg.backprojection_weights(jnp.asarray(m), jnp.asarray(c)))
    got = thg.backprojection_weights(torch.as_tensor(m), torch.as_tensor(c))
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_check_inputs_and_count_only_kernel_launches():
    frames = torch.zeros((2, 4, 5, 3), dtype=torch.uint8)
    rects = thg.full_rects(2, (4, 5), "cpu")
    before = dict(launches)
    K.hist4096(frames, rects)
    K.backproject(frames, torch.zeros((2, 4096)))
    assert launches == before  # the CPU twin is not a kernel launch
    with pytest.raises(ValueError):
        K.hist4096(frames.to(torch.int32), rects)
    with pytest.raises(ValueError):
        K.hist4096(frames, rects[:1])
    with pytest.raises(ValueError):
        K.backproject(frames, torch.zeros((2, 4096), dtype=torch.float64))
    with pytest.raises(ValueError):
        K.backproject(frames.to("meta"), torch.zeros((2, 4096), device="meta"))


@pytest.mark.parametrize("cols", [320, 128, 99, 1])
def test_cluster_split_covers_each_row_once(cols):
    """The cluster kernel's C (a power of two <= 16, one CTA a row at most)
    and each CTA's rows (the kernel's cta_share): every row of a stream is
    counted by exactly one CTA, in order, and no counting CTA is empty."""
    for n in (1, 2, 3, 128, 256, 600):
        for rows in (240, 241, 96, 57, 1):
            c = K.cluster_split(n, rows, cols, 132)
            assert 1 <= c <= 16 and c & (c - 1) == 0 and c <= rows
            spans = K.cluster_rows(c, rows, cols)
            assert len(spans) == c
            covered = [r for r0, r1 in spans for r in range(r0, r1)]
            assert covered == list(range(rows))
            counting = [s for s in spans if s[1] > s[0]]
            assert spans[:len(counting)] == counting
    # one wave of 4 CTAs an SM over 132 SMs, at least 3,072 pixels a CTA:
    # the full frame and the 96x128 band at 256 streams, at one, past a wave
    assert K.cluster_split(256, 240, 320, 132) == 2
    assert K.cluster_split(256, 96, 128, 132) == 2
    assert K.cluster_split(128, 240, 320, 132) == 4
    assert K.cluster_split(1, 240, 320, 132) == 16
    assert K.cluster_split(1, 96, 128, 132) == 4
    assert K.cluster_split(600, 240, 320, 132) == 1
    assert K.cluster_rows(2, 240, 320) == [(0, 120), (120, 240)]
    assert K.cluster_rows(16, 241, 320)[:2] == [(0, 15), (15, 30)]
    # a 60x60 box counts on two CTAs of eight
    assert K.cluster_rows(8, 60, 60) == [(0, 30), (30, 60)] + [(60, 60)] * 6
