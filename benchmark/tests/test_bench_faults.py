"""The check calls a broken timed path not correct: each tick's step
keeping its state, half the batch left out, an answer altered where it is
produced.  Each fault is planted on the tracker (on the CPU, in the
serving program's twin) once the lock phase and the warm pass are over."""

import pytest
import torch

from .test_bench_cell import run

WARM_CALLS = 16 + 1  # the lock phase's ticks and the warm pass's scan


def frozen_state(bt, live):
    """Every tick commits its outputs and not its state."""
    prog = bt._steps._programs[bt.n]
    commit = prog._commit_plain

    def keep_state(k, packs, table, hold=None):
        if live[0]:
            table = ([],) + tuple(table[1:])
        return commit(k, packs, table, hold)

    prog._commit_plain = keep_state
    return lambda call, out: out


def half_left_out(bt, live):
    """The second half of the streams' outputs never produced."""
    n = bt.n // 2

    def cut(call, out):
        return type(out)(*(torch.cat([v[..., :n], torch.zeros_like(
            v[..., n:])], -1) for v in out))
    return cut


def altered(bt, live):
    """One tick's smoothed x moved by half a pixel, every stream."""
    def alter(call, out):
        if call != WARM_CALLS + 1:
            return out
        x = out.smooth_x.clone()
        x[..., 0] += 0.5
        return out._replace(smooth_x=x)
    return alter


def planting(fault):
    def hook(bt):
        calls, live = [0], [False]
        after = fault(bt, live)

        def wrap(fn):
            def call(*args):
                calls[0] += 1
                live[0] = calls[0] > WARM_CALLS
                out = fn(*args)
                return after(calls[0], out) if live[0] else out
            return call

        bt.step_auto = wrap(bt.step_auto)
        bt.run_scan = wrap(bt.run_scan)
    return hook


@pytest.mark.parametrize("fault", [frozen_state, half_left_out, altered])
def test_fault_is_not_correct(small_root, fault):
    rc, r = run(small_root, hook=planting(fault))
    assert rc == 0 and not r["correct"] and r["failed"] > 0, r["checks"]
