"""A small cell end to end on the CPU (the kernels' plain twins, the
serving program's twin), its result line, and the control; a real cell
on the card."""

import json

import pytest

from benchmark import control
from benchmark.run import main

from .conftest import ROOT, SMALL


def run(root, *extra, trace=0, hook=None):
    return main(["--workload", SMALL, "--seed", str(2**31 + 41),
                 "--seconds", "1", "--trace", str(trace), "--device", "cpu",
                 "--root", root, "--workers", "1", *extra], hook=hook)


def test_small_cell_is_correct_and_prints_its_metrics(small_root, capsys):
    rc, r = run(small_root)
    assert rc == 0 and r["correct"] and r["failed"] == 0
    assert set(r["metrics"]) == {"frames_per_s", "setup_s"}
    assert r["attempted"] % 4 == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    assert r["checks"]["state_mismatch"] == {"value": 0, "limit": 0}
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == r
    assert err.strip().splitlines()[-1].startswith("check unchecked: 0")


def test_small_cell_traced_reads_its_window_metrics(small_root):
    rc, r = run(small_root, trace=1)
    assert rc == 0 and r["correct"]
    # no profiler on the CPU: the window's own metrics alone
    assert set(r["metrics"]) == {"host_call_ms", "relock_tick_pct"}
    assert r["metrics"]["relock_tick_pct"]["value"] == pytest.approx(6.25)


def test_no_card_no_result(small_root, capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc, r = main(["--workload", SMALL, "--seed", "1", "--seconds", "1",
                  "--root", small_root])
    assert rc != 0 and r is None
    assert capsys.readouterr().out == ""


def test_control_is_not_correct(small_root):
    for seed in (3, 2**31 + 7, 4000000001):
        numbers, limits, correct = control.control(small_root, SMALL, seed,
                                                   400, "cpu", workers=1)
        assert not correct, numbers
        assert numbers["box_gap_px"] > limits["box_gap_px"]


@pytest.mark.cuda
def test_first_cell_on_the_card(card):
    rc, r = main(["--workload", "bandhist-4096.steady", "--seed",
                  str(2**31 + 99), "--seconds", "2", "--root", ROOT])
    assert rc == 0 and r["correct"], r
    assert r["device"]["platform"] == "gpu"
