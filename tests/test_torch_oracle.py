"""The port's copy of the NumPy oracle (headtrackr_tpu_torch/oracle/) and its
conformance gate (tools/torch_verify_gpu.py) on the CPU.

The copy gives the JAX package's oracle's results: the HeadTracker session
loop row for row over a verify clip (real cascade, 320x240, smoothing and
head position on), detect_objects on a crowd frame, and Smoother and
HeadPositionTracker on a box sequence (all exact).  The gate passes on the
default clip with ``--device cpu``, and the tool imports nothing of jax or
of the JAX package (an AST check).
"""

import ast
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import headtrackr_tpu as ht
from headtrackr_tpu import oracle as jor
import headtrackr_tpu_torch as pt
from headtrackr_tpu_torch import oracle as por

torch.set_num_threads(2)

TOOL = pathlib.Path(__file__).resolve().parent.parent / "tools" / \
    "torch_verify_gpu.py"


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location("torch_verify_gpu", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same(a, b):
    """Equal nested dicts / lists / tuples of numbers and strings, NaN where
    NaN."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, (float, np.floating)) and np.isnan(a):
        assert np.isnan(b)
    else:
        assert a == b, (a, b)


def test_head_tracker_rows_equal(tool):
    clip = tool.build_clip(40, noise=3)
    j = jor.HeadTracker(ht.frontalface(), 320, 240)
    p = por.HeadTracker(pt.frontalface(), 320, 240)
    for f in clip:
        _same(p.step(f), j.step(f))
    _same(p.events, j.events)
    dedup = [s for i, s in enumerate(p.statuses)
             if i == 0 or s != p.statuses[i - 1]]
    assert dedup == ["whitebalance", "detecting", "found"]
    assert any(e[0] == "headtrackingEvent" for e in p.events)


def test_detect_objects_equal_on_a_crowd(tool):
    gray = por.grayscale(tool.build_crowd())
    got = por.detect_objects(gray, pt.frontalface(), 5, 1)
    assert len(got) > 1
    _same(got, jor.detect_objects(gray, ht.frontalface(), 5, 1))


def test_smoother_and_head_position_equal():
    rng = np.random.default_rng(11)
    boxes = [dict(x=160.0 + 3 * t + rng.normal(), y=120.0 - 2 * t,
                  width=40.0 + rng.normal(), height=48.0 + t % 3,
                  angle=0.0, confidence=1.0, detection="CS")
             for t in range(24)]
    for mode in ("ema", "desp"):
        js, ps = jor.Smoother(mode=mode), por.Smoother(mode=mode)
        js.init(boxes[0])
        ps.init(boxes[0])
        for b in boxes:
            _same(ps.smooth(b), js.smooth(b))
    jh = jor.HeadPositionTracker(boxes[0], 320, 240)
    ph = por.HeadPositionTracker(boxes[0], 320, 240)
    assert ph.get_fov() == jh.get_fov()
    for b in boxes + [dict(boxes[0], x=2.0, y=3.0)]:  # an edge case last
        _same(ph.track(b), jh.track(b))


def test_gate_passes_on_the_cpu(tool, capsys):
    assert tool.main(["--device", "cpu", "--frames", "30"]) == 0
    out = capsys.readouterr().out
    assert "realistic full step: 31 camshift frames" in out
    assert out.splitlines()[-1].endswith("PASS")


def test_gate_tool_imports_no_jax():
    for node in ast.walk(ast.parse(TOOL.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "headtrackr_tpu"), n
