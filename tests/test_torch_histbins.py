"""The bins-in histograms (TPU kernel X5's function) against the JAX package.

The same seeded i32 bin ids go through the reference's ``histogram_4096``,
``histogram_scan`` and the Pallas ``hist_pallas`` (interpret mode on the CPU,
as the JAX package's own tests run it) and through the port's
``hist_bins_plain``, ``histogram_4096`` and ``histogram_scan`` (the
``hist_bins`` kernel's plain twin on CPU tensors).  Counts are integers, so
the tolerance is 0: X5's workload shape scaled down to (4, 8, 96),
out-of-range ids (the -1 and -64 pads, ids >= 4096, the i32 extremes), a
row length with a tail (P % 4 != 0), a mask, and one stream of 70,000 equal
bins (a count past 2^16 in one bin).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headtrackr_tpu.kernels.histpdf import hist_pallas
from headtrackr_tpu.ops import histogram as jh
from headtrackr_tpu_torch.kernels import histbins
from headtrackr_tpu_torch.kernels.histbins import (hist_bins, id_shares,
                                                   row_chunks, split_bins)
from headtrackr_tpu_torch.ops import histogram as hg

torch.set_num_threads(2)

I32 = np.iinfo(np.int32)


def _x5(rng):
    """tools/kernel_experiments.py:212's workload at (4, 8, 96)."""
    return rng.integers(0, 4096, (4, 8, 96)).astype(np.int32)


def _pads(rng):
    """Ids of [-100, 5000) plus the pads and the i32 extremes; 7 x 11 = 77
    ids a stream (77 % 4 == 1)."""
    b = rng.integers(-100, 5000, (3, 7, 11)).astype(np.int32)
    b[:, 0, :6] = [-1, -64, 4096, 4095, I32.min, I32.max]
    return b


def _one_bin(rng):
    return np.full((1, 1, 70_000), 1234, np.int32)


def _narrow(rng):
    """Camera-like ids: a few bins for most pixels."""
    return rng.choice(np.array([17, 18, 273, 4000], np.int32), (2, 30, 41))


CASES = {"x5": _x5, "pads_tail": _pads, "one_bin_70000": _one_bin,
         "narrow": _narrow}


@pytest.fixture(scope="module")
def ref():
    """name -> (bins (N, H, W), the JAX counts by histogram_4096,
    histogram_scan and hist_pallas, each (N, 4096))."""
    rng = np.random.default_rng(5)
    h4096 = jax.jit(jax.vmap(jh.histogram_4096))
    scan = jax.jit(jax.vmap(jh.histogram_scan))
    pallas = jax.vmap(hist_pallas)
    out = {}
    for name, make in CASES.items():
        b = make(rng)
        jb = jnp.asarray(b)
        out[name] = (b, [np.asarray(f(jb)) for f in (h4096, scan, pallas)])
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_hist_bins_plain_equals_reference(ref, name):
    b, want = ref[name]
    got = hg.hist_bins_plain(torch.as_tensor(b).reshape(b.shape[0], -1))
    assert got.dtype == torch.float32 and got.shape == (b.shape[0], 4096)
    for w in want:
        np.testing.assert_array_equal(got.numpy(), w)


@pytest.mark.parametrize("name", sorted(CASES))
def test_histogram_4096_and_scan_equal_reference(ref, name):
    b, want = ref[name]
    t = torch.as_tensor(b)
    for got in (hg.histogram_4096(t), hg.histogram_scan(t, block=512),
                hist_bins(t.reshape(t.shape[0], -1))):
        for w in want:
            np.testing.assert_array_equal(got.numpy(), w)
    # one image: (H, W) -> (4096,), like the reference's unbatched call
    np.testing.assert_array_equal(hg.histogram_4096(t[0]).numpy(), want[0][0])


def test_histogram_4096_mask_equals_reference():
    rng = np.random.default_rng(6)
    b = _pads(rng)
    mask = rng.random(b.shape) < 0.6
    want = np.asarray(jax.vmap(jh.histogram_4096)(jnp.asarray(b),
                                                  jnp.asarray(mask)))
    got = hg.histogram_4096(torch.as_tensor(b), torch.as_tensor(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    # a mask broadcast over the streams
    want = np.asarray(jax.vmap(jh.histogram_4096, (0, None))(
        jnp.asarray(b), jnp.asarray(mask[0])))
    got = hg.histogram_4096(torch.as_tensor(b), torch.as_tensor(mask[0]))
    np.testing.assert_array_equal(got.numpy(), want)


def test_leading_dims_and_empty_rows():
    rng = np.random.default_rng(7)
    b = torch.as_tensor(rng.integers(-5, 4100, (2, 3, 5, 6)).astype(np.int32))
    got = hg.histogram_4096(b)
    assert got.shape == (2, 3, 4096)
    np.testing.assert_array_equal(
        got.reshape(6, 4096).numpy(),
        hg.hist_bins_plain(b.reshape(6, 30)).numpy())
    assert hg.histogram_4096(torch.zeros((0, 4, 4), dtype=torch.int32)).shape \
        == (0, 4096)
    assert float(hg.histogram_4096(
        torch.zeros((2, 0, 3), dtype=torch.int32)).abs().sum()) == 0.0


def test_hist_bins_rejects_what_it_does_not_take():
    with pytest.raises(ValueError, match="int32"):
        hist_bins(torch.zeros((2, 8), dtype=torch.int64))
    with pytest.raises(ValueError, match="int32"):
        hist_bins(torch.zeros((8,), dtype=torch.int32))


def test_split_bins_covers_the_card():
    """One wave of 4 CTAs an SM split over the rows, as a power of two of at
    most 16: at the bench's 256 x 76,800 ids on 132 SMs two CTAs a row, at
    the facade's N = 1 sixteen; never more than one a 3,072 ids; never
    fewer than one."""
    assert split_bins(256, 76_800, 132) == 2
    assert split_bins(1, 76_800, 132) == 16
    assert split_bins(1, 12_288, 132) == 4
    assert split_bins(1, 5_000, 132) == 2
    assert split_bins(4096, 76_800, 132) == 1
    assert split_bins(1, 0, 132) == 1
    for n in (1, 2, 3, 7, 100, 256, 529, 70_000):
        for p in (0, 1, 16, 3071, 3073, 9_999, 76_800, 10 ** 6):
            c = split_bins(n, p, 132)
            assert c in (1, 2, 4, 8, 16), (n, p)
            assert c == 1 or (c <= -(-p // 3072) and c * n <= 4 * 132)


@pytest.mark.parametrize("c", [1, 2, 4, 8, 16])
def test_id_shares_cover_each_id_once(c):
    """The kernel's split of a row: every id counted by exactly one CTA,
    whatever the row's length and its head (0-3 ids before the 16-byte
    boundary); the vectors dealt evenly (shares differ by at most one
    vector) to a prefix of the CTAs; the head and tail ids on CTA 0."""
    for p in (0, 1, 2, 3, 4, 5, 15, 16, 17, 63, 64, 65, 4099, 76_799):
        for head in range(4):
            shares = id_shares(c, p, head)
            assert len(shares) == c
            ids = sorted(i for r in shares for lo, hi in r
                         for i in range(lo, hi))
            assert ids == list(range(p)), (p, head)
            h = min(head, p)
            nvec = (p - h) // 4
            body = [sum(hi - lo for lo, hi in r
                        if lo >= h and hi <= h + 4 * nvec) for r in shares]
            dealt = [b for b in body if b]
            assert max(dealt, default=0) - min(dealt, default=0) <= 4
            active = max(1, min(c, nvec))
            assert all(shares[:active]) or p == 0
            assert not any(shares[active:])


def test_hist_bins_chunks_rows_past_the_grid(monkeypatch):
    """A batch of more rows than a launch takes goes in chunks of at most
    MAX_ROWS (65,535 on the card), each through the kernel's path (here the
    twin's, on the CPU), and the counts equal the twin's on the whole."""
    assert row_chunks(65_537) == [(0, 65_535), (65_535, 65_537)]
    assert row_chunks(65_535) == [(0, 65_535)]
    assert row_chunks(0) == []
    rng = np.random.default_rng(9)
    ids = torch.as_tensor(rng.integers(-5, 4100, (11, 37)).astype(np.int32))
    calls = []

    def twin(b):
        calls.append(tuple(b.shape))
        return hg.hist_bins_plain(b)

    monkeypatch.setattr(histbins, "MAX_ROWS", 4)
    monkeypatch.setattr(histbins, "hist_bins_plain", twin)
    got = hist_bins(ids)
    assert calls == [(4, 37), (4, 37), (3, 37)]
    np.testing.assert_array_equal(got.numpy(),
                                  hg.hist_bins_plain(ids).numpy())
