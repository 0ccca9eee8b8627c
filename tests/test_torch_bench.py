"""The port's bench (bench_torch.py) and its part timers (tools/torch_bench_*.py)
on the CPU.

``bench_torch.main`` with ``--device cpu`` and the real cascade at 2
streams prints its JSON line with every key and passes its gate; a run that
misses the gate says so in its record; without ``--device`` and without a
card it raises (no fallback).  The emission timer runs on the CPU; the two
card timers refuse to run without a card.  An AST check holds every file of
the bench free of ``jax`` and ``headtrackr_tpu`` imports.  (The protocol's
counts against bench.py's are in tests/test_torch_batched_steps.py, beside
the reference tracker they reuse.)
"""

import ast
import importlib.util
import json
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))  # bench.py and bench_torch.py

import bench_torch  # noqa: E402

torch.set_num_threads(2)

KEYS = ("metric", "value", "unit", "exact_value", "cold_start_value",
        "cold_start_unit", "latency_p50_ms", "latency_p99_ms", "h2d_value",
        "locked", "relocks", "redetects", "escapes", "device", "vs_limit",
        "launches")
SLICE = ("bench_torch.py", "tools/torch_bench_parts.py",
         "tools/torch_bench_emit.py", "tools/torch_bench_h2d.py",
         "chip_smoke.py", "headtrackr_tpu_torch/runtime/serving.py",
         "headtrackr_tpu_torch/models/camshift.py")
SMOKE = ["--device", "cpu", "--streams", "2", "--pool", "4", "--ticks", "8"]


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_smoke_prints_every_key(capsys):
    rec = bench_torch.main(SMOKE + ["--latency-ticks", "4", "--h2d"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == rec
    for k in KEYS:
        assert rec.get(k) is not None, k
    assert rec["gate_ok"] and rec["locked"] == 1.0 and rec["relocks"] > 0
    assert rec["redetects"] >= rec["relocks"] and rec["device"] == "cpu"
    assert rec["vs_limit"] == round(rec["value"] / 7680.0, 4)
    assert rec["latency_p99_ms"] >= rec["latency_p50_ms"] > 0
    assert rec["h2d_value"] > 0 and rec["h2d_pinned_value"] > 0
    assert set(rec["launches"].values()) == {0}  # the CPU runs the twins


def test_a_missed_gate_is_in_the_record(capsys, monkeypatch):
    real = bench_torch.measure_serving

    def half_locked(*a, **k):
        return dict(real(*a, **k), locked=0.5)

    monkeypatch.setattr(bench_torch, "measure_serving", half_locked)
    rec = bench_torch.main(SMOKE + ["--latency-ticks", "0",
                                    "--no-exact-arm"])
    assert rec["gate_ok"] is False and rec["exact_value"] is None
    assert "GATE MISSED" in capsys.readouterr().err


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_no_card_no_fallback():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.main(["--streams", "2", "--pool", "4"])
    for name in ("torch_bench_parts", "torch_bench_h2d"):
        with pytest.raises(SystemExit, match="no CUDA device"):
            _tool(name).main([])


def test_emit_timer_on_the_cpu(capsys):
    res = _tool("torch_bench_emit").main(["--streams", "16", "--iters", "3"])
    steady, worst = res["steady(face+head)"], res["worst(+2 status)"]
    assert steady[1] == 2 * 16 and worst[1] == 4 * 16
    assert "emit steady(face+head)  16 streams" in capsys.readouterr().out


def test_bench_files_import_no_jax():
    for rel in SLICE:
        for node in ast.walk(ast.parse((ROOT / rel).read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib",
                                               "headtrackr_tpu"), (rel, n)
