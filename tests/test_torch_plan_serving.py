"""The port's ``plan_serving`` against the JAX package's.

The capacity planner is host arithmetic (no kernel), so the test is
equality of the returned dicts: on the reference's own test inputs
(tests/test_runtime.py ``test_plan_serving_rules``) and on a grid of
stream counts, frame shapes, face sizes, loss counts, the latency flag and
``model_bins``.  Its kwargs must build a port ``BatchedTracker`` that runs.
"""

import itertools

import numpy as np
import pytest

from headtrackr_tpu.runtime.serving import plan_serving as jax_plan
import headtrackr_tpu_torch as pt
from headtrackr_tpu_torch.runtime.serving import plan_serving

# tests/test_runtime.py test_plan_serving_rules' calls
REFERENCE_CALLS = [
    ((256,), dict(max_face_px=40)),
    ((64,), dict(max_face_px=20, simultaneous_losses=3,
                 latency_sensitive=True)),
    ((256,), dict(model_bins=40)),
    ((256,), dict(model_bins=90)),
    ((256,), dict(model_bins=200)),
    ((2,), dict(frame_shape=(60, 80), max_face_px=500,
                simultaneous_losses=99)),
]


@pytest.mark.parametrize("args,kw", REFERENCE_CALLS)
def test_plan_serving_equals_reference_on_its_tests(args, kw):
    assert plan_serving(*args, **kw) == jax_plan(*args, **kw)


@pytest.mark.parametrize("frame_shape", [(240, 320), (60, 80), (480, 640),
                                         (120, 160), (7, 500)])
def test_plan_serving_equals_reference_on_a_grid(frame_shape):
    for n, face, losses, latency, bins in itertools.product(
            (1, 2, 24, 25, 50, 256, 1000), (1, 10, 24, 40, 99.5, 100, 500),
            (None, 0, 1, 3, 99), (False, True),
            (None, 0, 40, 49, 50, 90, 200)):
        kw = dict(frame_shape=frame_shape, max_face_px=face,
                  simultaneous_losses=losses, latency_sensitive=latency,
                  model_bins=bins)
        got, want = plan_serving(n, **kw), jax_plan(n, **kw)
        assert got == want, (n, kw)
        assert [type(v) for v in got.values()] == \
            [type(v) for v in want.values()], (n, kw)


def test_plan_serving_is_exported():
    assert pt.plan_serving is plan_serving
    assert pt.runtime.plan_serving is plan_serving
    assert "plan_serving" in pt.__all__


def test_plan_serving_kwargs_build_a_tracker():
    """The planned kwargs (sparse_hist as sparseHist) build a BatchedTracker
    on the CPU that takes its bucket and band and locks a bright blob."""
    H, W = 60, 80
    p = plan_serving(4, frame_shape=(H, W), max_face_px=16,
                     simultaneous_losses=1, model_bins=30)
    assert p["band"] == (48, 48) and p["bucket"] == 2
    assert p["sparse_hist"] == 64
    bt = pt.BatchedTracker(4, (H, W), device="cpu", cascade=pt.toy_cascade(),
                           band=p["band"], bucket=p["bucket"],
                           overload=p["overload"], bandHist=p["bandHist"],
                           sparseHist=p["sparse_hist"])
    assert bt.bucket == 2 and bt.band == (48, 48)
    f = np.full((4, H, W, 3), 40, np.uint8)
    f[:, 20:44, 28:52] = (230, 80, 60)
    for _ in range(17):
        bt.step_auto(f)
    assert (bt.modes == 2).all()
