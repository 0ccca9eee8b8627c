"""Fixtures of the benchmark's own tests: a small cell written to a
directory of its own, and the card, decided inside a fixture."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SMALL = "small.steady"


@pytest.fixture
def small_root(tmp_path):
    """A directory whose BENCHMARK.json holds one cell: the bandhist-4096
    configuration and the steady traffic cut to 4 streams, one of which
    loses its face once a pass; the metrics of BENCHMARK.json's
    bandhist-4096.steady cell."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "bandhist-4096.json")) as f:
        config = json.load(f)
    with open(os.path.join(ROOT, "benchmark", "traffic",
                           "steady.json")) as f:
        traffic = json.load(f)
    config.update(name="small", streams=4)
    config["tracker"]["bucket"] = 2
    config["check"]["sample"] = {"n_lost": 1, "n_kept": 2}
    traffic["loss"]["share"] = 0.25
    spec["configs"] = [dict(spec["configs"][0], name="small",
                            file="benchmark/configs/small.json")]
    spec["workloads"] = [{"name": SMALL, "config": "small",
                          "traffic": "small", "chips": 1, "why": "tests"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ([SMALL] if "bandhist-4096.steady"
                              in m["workloads"] else [])
    for sub in ("configs", "traffic"):
        (tmp_path / "benchmark" / sub).mkdir(parents=True)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    (tmp_path / "benchmark" / "configs" / "small.json").write_text(
        json.dumps(config))
    (tmp_path / "benchmark" / "traffic" / "small.json").write_text(
        json.dumps(traffic))
    return str(tmp_path)


@pytest.fixture
def card():
    """Skip unless a CUDA device is present."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
