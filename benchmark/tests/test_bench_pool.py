"""The traffic generator: the same seed gives the same frames, the loss
schedules keep their counts, the texture keeps the cascade's gray."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark.lib.pool import (BLUE, build_pool, face_rgb, lost_streams,
                                offsets)
from benchmark.reference.imageproc import grayscale

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def traffic(name):
    with open(os.path.join(ROOT, "benchmark", "traffic",
                           name + ".json")) as f:
        return json.load(f)


def test_same_seed_same_frames_other_seed_other_frames():
    t = traffic("steady")
    a = build_pool(8, (240, 320), t, 2**31 + 17, "cpu")
    b = build_pool(8, (240, 320), t, 2**31 + 17, "cpu")
    c = build_pool(8, (240, 320), t, 2**31 + 18, "cpu")
    assert torch.equal(a.ticks, b.ticks) and torch.equal(a.lock, b.lock)
    assert not torch.equal(a.ticks, c.ticks)


def test_offsets_ping_pong():
    assert offsets(16, 2) == [0, 2, 4, 6, 8, 10, 12, 14,
                              16, 14, 12, 10, 8, 6, 4, 2]


@pytest.mark.parametrize("n,share,per_tick", [(4096, 0.02, 82),
                                              (64, 0.0625, 4)])
def test_rotating_loss_each_stream_at_most_once_a_pass(n, share, per_tick):
    perm = np.random.default_rng(1).permutation(n)
    sched = lost_streams(n, 16, {"kind": "rotating", "share": share}, perm)
    assert [t for t, _ in sched] == list(range(16))
    assert all(s.size == per_tick for _, s in sched)
    every = np.concatenate([s for _, s in sched])
    assert np.unique(every).size == every.size == 16 * per_tick


def test_fixed_loss_counts_and_tick():
    perm = np.random.default_rng(2).permutation(4096)
    sched = lost_streams(4096, 16, {"kind": "fixed", "share": 1 / 64,
                                    "tick": 8}, perm)
    assert len(sched) == 1 and sched[0][0] == 8 and sched[0][1].size == 64


def test_rotating_loss_refuses_more_than_the_streams():
    with pytest.raises(ValueError):
        lost_streams(100, 16, {"kind": "rotating", "share": 0.1},
                     np.arange(100))


def test_losses_are_blue_frames_and_faces_keep_the_gray():
    t = traffic("churn")
    p = build_pool(64, (240, 320), t, 5, "cpu")
    blue = torch.tensor(BLUE, dtype=torch.uint8)
    for tick, streams in p.losses:
        assert streams.size == 1  # round(0.02 * 64)
        assert (p.ticks[tick, int(streams[0])] == blue).all()
    face = face_rgb(t["face_scale"])
    gray, size = grayscale(face), face.shape[0]
    bins = []
    for i, (x, y) in enumerate(p.places):
        assert x % 4 == 0 and y % 8 == 0
        crop = p.lock[i, y:y + size, x:x + size].numpy()
        assert (grayscale(crop) == gray).all()
        c = crop.astype(np.int64)
        bins.append(np.unique((c[..., 0] >> 4) * 256 + (c[..., 1] >> 4) * 16
                              + (c[..., 2] >> 4)).size)
    assert 80 <= np.median(bins) <= 110  # a webcam face's palette


@pytest.mark.parametrize("name", ["bandhist-4096", "exact-4096"])
def test_configs_take_their_knobs_from_the_planner(name):
    from headtrackr_tpu_torch.runtime.serving import plan_serving
    with open(os.path.join(ROOT, "benchmark", "configs",
                           name + ".json")) as f:
        config = json.load(f)
    plan = config["planner"]
    p = plan_serving(plan["n_streams"], tuple(plan["frame_shape"]),
                     plan["max_face_px"])
    kw = config["tracker"]
    assert config["streams"] == plan["n_streams"]
    assert tuple(kw["band"]) == p["band"] and kw["bucket"] == p["bucket"]
    assert kw["overload"] == p["overload"]
    assert kw["bandHist"] == (name == "bandhist-4096")
    # the faces the traffic draws fit the planner's sizing
    for t in ("steady", "live", "churn"):
        assert 24 * traffic(t)["face_scale"] <= plan["max_face_px"]


@pytest.mark.parametrize("x,y", [(8, 8), (70, 64), (140, 128)])
def test_the_cascade_finds_the_scaled_face(x, y):
    from benchmark.lib.check import CASCADE, ref
    from benchmark.lib.pool import BACKGROUND
    from benchmark.reference.detector import detect_objects
    from benchmark.reference.pipeline import CONFIDENCE_THRESHOLD
    face = face_rgb(traffic("steady")["face_scale"])
    frame = np.empty((240, 320, 3), np.uint8)
    frame[:] = BACKGROUND
    frame[y:y + face.shape[0], x:x + face.shape[1]] = face
    found = detect_objects(grayscale(frame), ref.load_cascade(CASCADE), 5, 1)
    best = max(found, key=lambda c: c["confidence"])
    assert best["confidence"] > CONFIDENCE_THRESHOLD
    assert abs(best["x"] - x) < 16 and abs(best["y"] - y) < 16
    assert 0.9 * face.shape[1] < best["width"] < 1.2 * face.shape[1]
