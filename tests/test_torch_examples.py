"""The port's examples (examples/torch_*.py) on the CPU.

Each example's ``main`` runs with ``--device cpu`` and the toy cascade at
its small size, and its printed lines are checked; the batched serving
example's run_scan track is the one its JAX namesake prints on the same
clips (examples/batched_serving.py, the toy cascade, on the CPU).  An AST
check holds every ``examples/torch_*.py`` free of ``jax`` and
``headtrackr_tpu`` imports.
"""

import ast
import importlib.util
import pathlib
import sys

import pytest
import torch

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
PORTED = ("torch_facetracking", "torch_head_coupled_camera",
          "torch_batched_serving", "torch_net_ingest_serving",
          "torch_mesh_serving")

torch.set_num_threads(2)


def _load(name, monkeypatch):
    """examples/<name>.py as the module ``name`` (importable by that name,
    as the ingest example's spawned producers need)."""
    monkeypatch.syspath_prepend(str(EXAMPLES))
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, name, mod)
    spec.loader.exec_module(mod)
    return mod


def test_every_example_is_ported_and_imports_no_jax():
    jax_examples = {p.stem for p in EXAMPLES.glob("*.py")
                    if not p.stem.startswith("torch_")}
    assert {f"torch_{s}" for s in jax_examples} == set(PORTED)
    for path in EXAMPLES.glob("torch_*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "headtrackr_tpu"), \
                    (path.name, n)


def test_facetracking(monkeypatch, capsys):
    mod = _load("torch_facetracking", monkeypatch)
    tracker = mod.main(["--toy", "--device", "cpu", "--frames", "24"])
    lines = capsys.readouterr().out.splitlines()
    assert tracker.status == "tracking" and tracker.device.type == "cpu"
    status = [ln for ln in lines if ln.startswith("[status]")]
    assert status[0] == "[status] whitebalance"
    assert status[-2:] == ["[status] detecting", "[status] found"]
    assert any(ln.startswith("[face] x=") for ln in lines)
    assert any(ln.startswith("[head] x=") for ln in lines)
    assert lines[-1].startswith("processed 24 frames; final status: "
                                "tracking; fov=")


def test_head_coupled_camera(monkeypatch, capsys):
    mod = _load("torch_head_coupled_camera", monkeypatch)
    poses = mod.main(["--toy", "--device", "cpu", "--frames", "24"])
    lines = capsys.readouterr().out.splitlines()
    assert poses > 0
    assert sum(ln.startswith("[camera] pos=(") for ln in lines) == poses
    assert lines[-1] == "final status: tracking"


def test_batched_serving(monkeypatch, capsys):
    mod = _load("torch_batched_serving", monkeypatch)
    heads, modes, xs = mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert modes == [2] * mod.N
    assert [len(h) for h in heads] == [18] * mod.N
    assert "session: 40 ticks, status=['tracking', 'tracking', 'tracking', " \
        "'tracking']" in out
    assert ("plan_serving: {'band': (56, 56), 'bucket': 2, 'overload': "
            "'full', 'scan_len': 16, 'sparse_hist': None, 'bandHist': True}"
            in out)
    # what examples/batched_serving.py prints for stream 0
    assert xs[:, 0].astype(int).tolist() == [39, 41, 42, 43, 44, 45, 46, 47,
                                             48, 49, 50, 51, 52, 53, 54, 55]


def test_mesh_serving(monkeypatch, capsys):
    mod = _load("torch_mesh_serving", monkeypatch)
    modes, lost, shards = mod.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert shards == 8 and modes == [2] * mod.N and lost == [3, mod.N - 1]
    assert lines[0].startswith("mesh: 8 shards ['cpu', ")
    assert "lock: 32/32 streams tracking, 4 a shard" in lines
    assert lines[3] == ("  shard 0 (cpu): streams 0-3, modes [2, 2, 2, 2], "
                        "redetect ticks 1")
    assert lines[-1].startswith("run_scan: 16 ticks a call; streams [3, 31] "
                                "lost track at tick 8")


def test_net_ingest_ring_only(monkeypatch, capsys):
    mod = _load("torch_net_ingest_serving", monkeypatch)
    total, statuses = mod.main(["--ring-only", "--frames", "6"])
    out = capsys.readouterr().out
    assert total == mod.N_STREAMS * 6 and statuses is None
    assert f"ingested {total} frames" in out
    assert "'dropped_stale': 0" in out


@pytest.mark.parametrize("argv", [["--track", "--ring-only"], ["--bogus"]])
def test_net_ingest_rejects_bad_flags(monkeypatch, argv):
    mod = _load("torch_net_ingest_serving", monkeypatch)
    with pytest.raises(SystemExit):
        mod.main(argv)
