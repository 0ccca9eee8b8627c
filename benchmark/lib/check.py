"""What decides ``correct``: the program's outputs on a sample of streams,
every tick of the run, against the plain reference (``reference/``).

The sample is drawn from the seed: streams that lose their face in the
pool (the relock path: detector, handoff, bucket merge) and streams that
never do (band or full-frame camshift every tick).  The reference replays
each sampled stream from its frames alone (``reference.serving``) in
worker processes, once the program's window has closed.

The numbers compared (``NUMBERS``), each against the configuration's
limit:

* ``state_mismatch``: stream-ticks whose status bits, mode after the tick
  or head-valid flag differ from the reference's (exact: limit 0);
* ``box_gap_px``: the widest gap of the face box and the smoothed box
  (x, y, width, height), in px;
* ``head_gap_cm``: the widest gap of the head position (x, y, z) on ticks
  where both give one, in cm;
* ``pending_max``: the most streams pending after a tick of the run (every
  stream, not the sample), which the configuration holds under its
  ``chunk_cap``: above it the program serves some pending streams a tick
  late and a stream's outputs no longer depend on its frames alone;
* ``unchecked``: sampled stream-ticks the reference could not reach
  (limit 0).
"""

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from ..reference import serving as ref

__all__ = ["NUMBERS", "sample_streams", "reference_cycles", "compare",
           "judge"]

NUMBERS = ("state_mismatch", "box_gap_px", "head_gap_cm", "pending_max",
           "unchecked")
_BOX = [ref.FIELDS.index(f) for f in ("face_x", "face_y", "face_w",
                                      "face_h", "smooth_x", "smooth_y",
                                      "smooth_w", "smooth_h")]
_HEAD = [ref.FIELDS.index(f) for f in ("head_x", "head_y", "head_z")]
_EXACT = [ref.FIELDS.index(f) for f in ("head_valid", "status",
                                        "mode_after")]
_VALID = ref.FIELDS.index("head_valid")
CASCADE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "frontalface.npz")


def sample_streams(n, lost, seed, n_lost, n_kept):
    """Sorted stream indices: up to n_lost of ``lost`` and up to n_kept of
    the others, drawn from ``seed``."""
    rng = np.random.default_rng(int(seed))
    lost = np.asarray(lost, dtype=np.int64)
    kept = np.setdiff1d(np.arange(n), lost)
    pick = [rng.choice(a, min(k, a.size), replace=False)
            for a, k in ((lost, n_lost), (kept, n_kept)) if a.size and k]
    return np.sort(np.concatenate(pick)) if pick else np.zeros(0, np.int64)


def _cycle(args):
    lock, pool, band, band_hist, precision, n_lock = args
    return ref.stream_rows(lock, pool, ref.load_cascade(CASCADE), band=band,
                           band_hist=band_hist, precision=precision,
                           n_lock=n_lock)


def reference_cycles(frames, band, band_hist, precision="f64", n_lock=16,
                     workers=None):
    """``reference.serving.stream_rows`` of each (lock, pool) in
    ``frames``, in up to ``workers`` processes (default: the cores but
    two, at most 6); every process ends before this returns."""
    tasks = [(lock, pool, band, band_hist, precision, n_lock)
             for lock, pool in frames]
    if workers is None:
        workers = min(6, max(1, (os.cpu_count() or 2) - 2))
    workers = max(1, min(workers, len(tasks)))
    if workers == 1:
        return [_cycle(t) for t in tasks]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as ex:
        return list(ex.map(_cycle, tasks))


def compare(got, ticks, cycles, limits, pending_max=0):
    """The numbers of ``NUMBERS`` for the program's outputs ``got`` (T, S,
    len(FIELDS)) at run ticks ``ticks`` (T,) of S sampled streams, against
    the reference's ``cycles`` (one a stream), and the run's
    ``pending_max``.  Returns (numbers, the count of stream-ticks that miss
    a limit)."""
    T, S = got.shape[:2]
    numbers = dict.fromkeys(NUMBERS, 0)
    numbers["pending_max"] = int(pending_max)
    failed = np.zeros((T, S), dtype=bool)
    for s, (t0, period, rows) in enumerate(cycles):
        want = np.full((T, rows.shape[1]), np.nan)
        reach = (np.ones(T, dtype=bool) if period
                 else ticks < rows.shape[0])
        want[reach] = ref.expand(t0, period, rows, ticks[reach])
        g = got[:, s]
        exact = reach & (g[:, _EXACT] != want[:, _EXACT]).any(1)
        both = reach & (g[:, _VALID] > 0) & (want[:, _VALID] > 0)
        box = np.zeros(T)
        head = np.zeros(T)
        box[reach] = np.nan_to_num(np.abs(g[reach][:, _BOX]
                                          - want[reach][:, _BOX]),
                                   nan=np.inf).max(1)
        head[both] = np.nan_to_num(np.abs(g[both][:, _HEAD]
                                          - want[both][:, _HEAD]),
                                   nan=np.inf).max(1)
        numbers["state_mismatch"] += int(exact.sum())
        numbers["unchecked"] += int((~reach).sum())
        numbers["box_gap_px"] = max(numbers["box_gap_px"], float(box.max()))
        numbers["head_gap_cm"] = max(numbers["head_gap_cm"],
                                     float(head.max()))
        failed[:, s] = (exact | ~reach | (box > limits["box_gap_px"])
                        | (head > limits["head_gap_cm"]))
    return numbers, int(failed.sum())


def judge(numbers, limits):
    """(correct, {name: {"value", "limit"}}): correct when every number is
    at most its limit."""
    rows = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}
    return all(numbers[k] <= limits[k] for k in NUMBERS), rows
