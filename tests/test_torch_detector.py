"""The port's detector (its kernels' plain twins on the CPU, 256 candidate
slots a stream) against the reference package's ``detect_best`` and the
oracle's ``detect_objects``: the toy cascade at 120x160 and the real
cascade at 240x320 on the synthface fixture.  ``found`` and ``floor(rect)``
exact, x/y/w/h to rtol 1e-6, confidence to atol 1e-5, grouped box set equal
to the oracle's (rtol 1e-6 against its f64 values)."""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headtrackr_tpu.cascade import frontalface as j_frontalface
from headtrackr_tpu.cascade import toy_cascade as j_toy
from headtrackr_tpu.models import detector as jd
from headtrackr_tpu.ops.imageproc import grayscale as j_gray
from headtrackr_tpu.oracle import detector as od
from headtrackr_tpu_torch.models import detector as td

# the module: the package's ``cascade`` attribute is the bundled model, as
# the reference package's is
tc = importlib.import_module("headtrackr_tpu_torch.cascade")

torch.set_num_threads(2)


def _toy_frames():
    H, W = 120, 160
    f = np.full((3, H, W, 3), 40, np.uint8)
    f[0, 38:62, 48:72] = (230, 80, 60)
    f[1, 10:34, 20:44] = (230, 80, 60)
    f[1, 70:110, 100:140] = (200, 200, 200)
    return f            # stream 2: no face


def _face_frames():
    face = np.load(os.path.join(tc.DATA_DIR, "synthface.npz"))["rgb"]
    f = np.full((2, 240, 320, 3), (120, 100, 90), np.uint8)
    f[0, 108:132, 148:172] = face
    f[1, 40:64, 60:84] = face
    return f


CASES = {"toy_120x160": (j_toy, tc.toy_cascade, _toy_frames),
         "real_240x320": (j_frontalface, tc.frontalface, _face_frames)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_detect_best_matches_reference_and_oracle(case):
    j_casc, t_casc, frames_fn = CASES[case]
    rgb = frames_fn()
    gray = np.array(jax.vmap(j_gray)(jnp.asarray(rgb)))
    N, H, W = gray.shape

    def ref(g):
        grouped = jd.detect_objects_padded(g, j_casc(), 5, 1, 256, 4096, 512)
        return grouped["overflow"], jd.detect_best(g, j_casc(), 5, 1, 256,
                                                   4096, 512)

    overflow, best_j = jax.jit(jax.vmap(ref))(jnp.asarray(gray))
    assert (np.asarray(overflow) == 0).all()  # parity rule F7
    best_j = [np.asarray(a) for a in best_j]

    tables = td.detector_tables(W, H, t_casc(), 5, "cpu")
    tg = torch.as_tensor(gray)
    found, *vals = [a.numpy() for a in td.detect_best(tg, tables)]
    np.testing.assert_array_equal(found, best_j[0])
    assert found.any()
    f = found
    rect_t = np.floor(np.stack(vals[:4], 1)[f])
    rect_j = np.floor(np.stack(best_j[1:5], 1)[f])
    np.testing.assert_array_equal(rect_t, rect_j)
    np.testing.assert_allclose(np.stack(vals[:4], 1)[f],
                               np.stack(best_j[1:5], 1)[f], rtol=1e-6)
    np.testing.assert_allclose(vals[4][f], best_j[5][f], rtol=0, atol=1e-5)

    g = td.detect_objects_padded(tg, tables)
    for n in range(N):
        k = g["kept"][n].numpy()
        mine = sorted(zip(*(g[c][n].numpy()[k].astype(np.float64)
                            for c in ("x", "y", "width", "height",
                                      "neighbors"))))
        want = sorted((d["x"], d["y"], d["width"], d["height"],
                       d["neighbors"])
                      for d in od.detect_objects(gray[n], t_casc(), 5, 1))
        assert len(mine) == len(want), n
        np.testing.assert_allclose(np.array(mine).reshape(-1, 5),
                                   np.array(want).reshape(-1, 5), rtol=1e-6)


def test_cascade_to_torch_carries_reference_parameters():
    ref = j_frontalface()
    got = tc.cascade_to_torch(ref, "cpu")
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]), err_msg=k)
    mine = tc.frontalface()
    assert (mine.count, mine.width, mine.height) == (ref.count, ref.width,
                                                     ref.height)
    assert mine.alpha.shape == (2015, 2)
