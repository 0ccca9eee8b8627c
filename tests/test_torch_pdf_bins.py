"""The bins-in weight lookup (TPU kernel K2's function on bin ids) against
the JAX package.

The same seeded i32 bin ids and f32 weights go through the reference's
Pallas ``pdf_pallas`` (interpret mode on the CPU, as the JAX package's own
tests run it) and through the port's ``pdf_bins_plain`` and
``kernels.pdf_pallas`` (the ``pdf_bins`` kernel's plain twin on CPU
tensors).  The lookup is exact, so the tolerance is 0: a stream of 23 x 29
ids (P % 4 == 3) at N = 1 and 3 and in the (H, W) form, the ids -1, -64,
4096 and the i32 extremes (looked up as +0.0), and zero weights.  Then the
twin alone, bit for bit, on -0.0 and denormal weights, which the
reference's bf16 planes do not keep; and the kernel's split of a row
(``pdf_split`` with ``id_shares``), which must cover every id of every
stream exactly once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headtrackr_tpu.kernels import histpdf as jk
from headtrackr_tpu_torch import kernels as tk
from headtrackr_tpu_torch.kernels.histbins import id_shares
from headtrackr_tpu_torch.kernels.pdfbins import pdf_bins, pdf_split
from headtrackr_tpu_torch.ops import histogram as hg

torch.set_num_threads(2)

I32 = np.iinfo(np.int32)
ODD = [-1, -64, 4096, I32.min, I32.max]
H100_SMS = 132


def _random(rng, n):
    return (rng.integers(0, 4096, (n, 23, 29)).astype(np.int32),
            rng.random((n, 4096)).astype(np.float32))


def _odd_ids(rng, n):
    b, w = _random(rng, n)
    b[:, 0, :5] = ODD
    b[:, -1, -5:] = ODD[::-1]
    return b, w


def _zero_weights(rng, n):
    b, w = _random(rng, n)
    w[:, ::2] = 0.0
    w[-1] = 0.0
    return b, w


CASES = {"random": _random, "odd_ids": _odd_ids, "zero_weights": _zero_weights}


def _reference(bins, weights):
    """The JAX package's pdf_pallas frame by frame: (N, 23, 29) f32."""
    return np.stack([np.asarray(jk.pdf_pallas(jnp.asarray(b), jnp.asarray(w)))
                     for b, w in zip(bins, weights)])


@pytest.mark.parametrize("n", [1, 3, "hw"])
@pytest.mark.parametrize("case", list(CASES))
def test_pdf_bins_equal_reference(case, n):
    """pdf_bins_plain, the pdf_bins wrapper on CPU tensors and
    kernels.pdf_pallas equal the reference's pdf_pallas bit for bit; an id
    outside [0, 4096) looks up +0.0."""
    rng = np.random.default_rng(170 + list(CASES).index(case))
    bins, weights = CASES[case](rng, 1 if n == "hw" else n)
    want = _reference(bins, weights)
    tb, tw = torch.as_tensor(bins), torch.as_tensor(weights)
    if n == "hw":  # one frame: (H, W) ids and one (4096,) table
        tb, tw, want = tb[0], tw[0], want[0]
    else:
        flat = pdf_bins(tb.view(n, -1), tw)
        np.testing.assert_array_equal(flat.view(tb.shape).numpy(), want)
    for got in (hg.pdf_bins_plain(tb, tw), tk.pdf_pallas(tb, tw, 128)):
        assert got.dtype == torch.float32 and got.shape == tb.shape
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      want.view(np.uint32))
    if case == "odd_ids":
        assert (got.numpy().view(np.uint32)[..., 0, :5] == 0).all()


def test_pdf_bins_twin_keeps_every_weight_bit():
    """The twin is an exact lookup: -0.0, denormal and extreme weights come
    back with their bits (the reference keeps normal weights only: its
    bf16 planes give +0.0 for these), and an id outside the range +0.0."""
    w = np.linspace(-3, 3, 4096).astype(np.float32)
    special = np.array([-0.0, 1e-40, -1e-45, 2.0 ** -149, 1.17e-38,
                        np.finfo(np.float32).max, -np.inf, np.inf],
                       np.float32)
    w[:special.size] = special
    bins = np.arange(-6, 4102, dtype=np.int32)[None]
    bins[0, :8] = np.arange(8)
    got = hg.pdf_bins_plain(torch.as_tensor(bins), torch.as_tensor(w[None]))
    want = np.where((bins >= 0) & (bins < 4096), w[np.clip(bins, 0, 4095)],
                    np.float32(0.0))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert (got.numpy().view(np.uint32)[0, -6:] == 0).all()


@pytest.mark.parametrize("n", [0, 1, 8, 256])
@pytest.mark.parametrize("p", [1, 3, 76_800, 307_200])
def test_pdf_split_covers_every_id_once(n, p):
    """On a 132-SM card, the CTAs pdf_split gives a row, split as the
    kernel splits it (id_shares, for each of the four alignments a row's
    start can have), look up each id of the row exactly once; the grid is
    four waves at most (32 CTAs an SM), and a row has no more CTAs than
    ceil(p / 2,048)."""
    c = pdf_split(n, p, H100_SMS)
    assert c >= 1
    assert n * c <= max(32 * H100_SMS, n)
    assert c <= -(-p // 2048)
    for head in range(4):  # ids before the row's first 16-byte boundary
        seen = np.zeros(p, np.int32)
        for share in id_shares(c, p, head):
            for lo, hi in share:
                seen[lo:hi] += 1
        assert (seen == 1).all(), (c, head)


def test_pdf_split_spreads_one_stream():
    """One stream of 240 x 320 ids spreads over at least 32 CTAs of a
    132-SM card; 256 such streams take 16 CTAs each, four waves of 8 CTAs
    an SM."""
    assert pdf_split(1, 240 * 320, H100_SMS) >= 32
    assert pdf_split(256, 240 * 320, H100_SMS) == 16


def test_pdf_pallas_rejects_what_it_does_not_take():
    b = torch.zeros((2, 4, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="weights"):
        tk.pdf_pallas(b, torch.zeros((3, 4096)))
    with pytest.raises(ValueError, match="bins"):
        tk.pdf_pallas(b.long(), torch.zeros((2, 4096)))
    with pytest.raises(ValueError, match="weights"):
        pdf_bins(b.view(2, -1), torch.zeros((2, 4096), dtype=torch.float64))


@pytest.mark.parametrize("shape", [(0, 24, 32), (3, 0, 32), (24, 0)])
def test_pdf_pallas_empty(shape):
    """No streams, or frames of no pixels, give an empty f32 lookup of the
    bins' shape."""
    lead = shape[:-2]
    got = tk.pdf_pallas(torch.zeros(shape, dtype=torch.int32),
                        torch.zeros(lead + (4096,)))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
