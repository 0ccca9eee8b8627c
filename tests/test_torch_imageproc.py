"""The port's image primitives against the reference package and the oracle:
grayscale exact, whitebalance to rtol 1e-6 (f32 means summed in another
order), every pyramid plane bit-exact against the oracle's defined spec and
against the reference package's planes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headtrackr_tpu.ops import imageproc as ji
from headtrackr_tpu.oracle import imageproc as oi
from headtrackr_tpu_torch.ops import imageproc as ti

torch.set_num_threads(2)

SHAPES = [(120, 160), (240, 320)]


@pytest.mark.parametrize("shape", SHAPES)
def test_grayscale_and_whitebalance(shape, rng):
    rgb = rng.integers(0, 256, (2,) + shape + (3,), np.uint8)
    frames = torch.as_tensor(rgb)
    np.testing.assert_array_equal(
        ti.grayscale(frames).numpy(),
        np.asarray(jax.vmap(ji.grayscale)(jnp.asarray(rgb))))
    np.testing.assert_allclose(
        ti.whitebalance(frames).numpy(),
        np.asarray(jax.vmap(ji.whitebalance)(jnp.asarray(rgb))), rtol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_pyramid_planes_bit_exact(shape, rng):
    gray = rng.integers(0, 256, (2,) + shape, np.uint8)
    pyr_t, spec = ti.build_pyramid(torch.as_tensor(gray))
    assert (dataclasses.astuple(spec) ==
            dataclasses.astuple(ji.pyramid_spec(shape[1], shape[0], 5)))
    pyr_o = [oi.build_pyramid(g)[0] for g in gray]
    for n in range(2):
        assert set(pyr_t) == set(pyr_o[n])
        for k, want in pyr_o[n].items():
            np.testing.assert_array_equal(pyr_t[k][n].numpy(), want,
                                          err_msg=f"stream {n} plane {k}")

    # Against the reference package: bit-exact wherever its XLA:CPU build
    # meets the defined spec.  On these seeded frames it misses the oracle
    # by one u8 step on 9 and 18 isolated pixels of ~48k and ~195k (f32
    # rounding in its compiled lerp); there the port keeps the oracle's value.
    pyr_j = jax.jit(lambda g: ji.build_pyramid(g)[0])(jnp.asarray(gray[0]))
    ref_misses = n_px = 0
    for k, got in pyr_j.items():
        got = np.asarray(got)
        miss = got != pyr_o[0][k]
        np.testing.assert_array_equal(pyr_t[k][0].numpy()[~miss], got[~miss],
                                      err_msg=f"plane {k}")
        assert np.abs(got[miss].astype(int) - pyr_o[0][k][miss]).max(
            initial=0) <= 1
        ref_misses += int(miss.sum())
        n_px += miss.size
    assert ref_misses <= 1e-3 * n_px
