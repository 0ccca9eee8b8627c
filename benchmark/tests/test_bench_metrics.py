"""The metric arithmetic and the readers, on synthetic spans and
profiles; the whole-name import guard."""

import statistics
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark.lib import guard, layers, roofline, stats
from benchmark.lib.readers import reader_of


def test_p95_and_spread():
    v = list(range(1, 101))
    assert stats.p95(v) == pytest.approx(np.percentile(v, 95))
    q1, med, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / med)


def test_union_and_idle():
    assert stats.union_seconds([(0, 1), (0.5, 2), (3, 4)]) == 3
    assert stats.idle_pct(3.0, 4.0) == pytest.approx(25.0)
    with pytest.raises(ValueError):
        stats.idle_pct(1.0, 0.0)


def window(**kw):
    w = SimpleNamespace(ticks=32, seconds=2.0, calls=[], runs=[],
                        tick_ms=[], launch_ms=[])
    w.__dict__.update(kw)
    return w


def test_end_to_end_readers():
    w = window(tick_ms=list(np.linspace(1.0, 2.0, 101)))
    ctx = {"window": w, "n": 100, "setup_s": 7.5}
    assert reader_of("frames_per_s")(ctx) == pytest.approx(1600.0)
    assert reader_of("setup_s")(ctx) == 7.5
    assert reader_of("tick_p95_ms")(ctx) == pytest.approx(1.95)
    assert reader_of("tick_p95_ms")({"window": window()}) is None


def test_window_readers():
    w = window(calls=[(0.0, 0.010, 0.011, 16), (0.02, 0.026, 0.027, 16)],
               runs=[[15, 1, 0, 0], [16, 0, 0, 0]], launch_ms=[500.0, 500.0])
    ctx = {"window": w, "relock_bodies": [1, 2, 3],
           "traffic": {"call": {"kind": "scan"}}}
    assert reader_of("host_call_ms")(ctx) == pytest.approx(8.0)
    assert reader_of("relock_tick_pct")(ctx) == pytest.approx(100 / 32)
    assert reader_of("device_idle_pct")(ctx) == pytest.approx(50.0)
    assert reader_of("tick_device_p95_ms.live")(ctx) is None


def profile(**kernels):
    return {"kernels": kernels, "ticks": 4, "pending": [0, 64, 0, 0]}


def test_layer_times_and_rooflines():
    p = profile(**{"void cluster_hist_kernel<true, false>(...)": (4, 1e-3),
                   "void (anonymous namespace)::meanshift_kernel(...)":
                       (4, 2e-4),
                   "void cascade_dense_kernel(...)": (1, 1e-4),
                   "cascade_deep_kernel": (1, 1e-4),
                   "Memcpy DtoH (Device -> Pinned)": (4, 1e-5)})
    ctx = {"profile": p, "n": 4096, "frame": (240, 320),
           "config": {"tracker": {"band": [96, 128]}}}
    assert layers.ms_per_tick(ctx, "camshift") == pytest.approx(0.3)
    assert layers.ms_per_tick(ctx, "detector") == pytest.approx(0.05)
    assert layers.ms_per_tick(ctx, "sched") == 0
    assert layers.ms_per_tick({"profile": None}, "sched") is None
    b, o = roofline.histpdf_band_work(4096, (96, 128))
    want = 100 * 4 * roofline.bound_s(b, o) / 1e-3
    assert reader_of("histpdf_band_roofline")(ctx) == pytest.approx(want)
    assert 0 < want <= 100
    assert reader_of("hist_mma_roofline")(ctx) is None  # no such kernel
    got = reader_of("cascade_roofline")(ctx)
    assert 0 < got <= 100


@pytest.mark.parametrize("names,found", [
    (["headtrackr_tpu_torch", "headtrackr_tpu_torch.runtime.serving",
      "benchmark.lib.check", "jaxtyping", "benchmarks", "torch"], []),
    (["headtrackr_tpu.ops.imageproc"], ["headtrackr_tpu"]),
    (["jax.numpy", "jaxlib.xla_client"], ["jax", "jaxlib"]),
    (["bench", "bench_torch"], ["bench", "bench_torch"]),
    (["flax.linen"], ["flax"]),
])
def test_import_guard_compares_whole_top_level_names(names, found):
    assert guard.forbidden_loaded(names) == found


def test_every_cell_reports_what_its_metrics_move():
    """Each metric of BENCHMARK.json has its reader; each cell reports
    setup_s, another end-to-end metric and a per-layer metric; each
    per-layer metric's cells report the end-to-end metric it moves."""
    import json
    import os

    from .conftest import ROOT
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cells = [w["name"] for w in spec["workloads"]]

    def where(m):
        return m.get("workloads", cells)

    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(reader_of(m["name"])), m["name"]
        assert set(where(m)) <= set(cells), m["name"]
    e2e = {m["name"]: where(m) for m in spec["end_to_end"]}
    for c in cells:
        assert c in e2e["setup_s"]
        assert any(c in ws for n, ws in e2e.items() if n != "setup_s"), c
        assert any(c in where(m) for m in spec["per_layer"]), c
    for m in spec["per_layer"]:
        assert set(where(m)) <= set(e2e[m["moves"]]), m["name"]


def test_live_readers_read_as_their_twins():
    w = window(calls=[(0.0, 0.001, 0.0012, 1)] * 4, runs=[[0, 1]] * 4,
               ticks=4, launch_ms=[0.5] * 4)
    ctx = {"window": w, "relock_bodies": [1]}
    for name in ("host_call_ms", "relock_tick_pct", "device_idle_pct"):
        assert reader_of(name + ".live")(ctx) == reader_of(name)(ctx)
