"""The serving program's commit (kernels/schedule.py ``segments``,
``scan_commit_plain``, ``commit_chunks``; runtime/serving.py ``_Program``'s
tables) on the CPU.

  * a body keeps its own results, and a state leaf it passes through (the
    all-CS body's model histograms: ``tree_where`` of a tensor with
    itself) is ``state_in``'s own tensor and gets no commit entry; every
    other carried state leaf but pend_age is flagged held (a many escape
    tick's commit leaves the escaped streams' rows of it);
  * a result that overlaps the state it commits into any other way raises,
    in the tables and in the twin;
  * the byte-balanced chunk map (the kernel's: an entry's first 16-byte
    chunk in its table's run, bisection then a walk) copies exactly what
    ``scan_commit_plain`` copies, on entries of every size and alignment
    (rows of 13 bools among them) and a column of an (n, 5) tensor (a 1-D
    strided view, gathered element by element), emulated with
    ``ctypes.memmove`` on the CPU tensors' own addresses; any other
    non-contiguous result raises;
  * the few escape body's table holds the kept rows alone of the leaves
    its step changed and of its outputs (``escaped`` and pend_age
    excepted), emulated against ``scan_commit_plain`` as above;
  * a many escape tick's commit of the tick body's table (the all-CS
    body's and a bucket body's, merged entries among them) with the
    escaped streams' rows held: the kernel's byte logic, emulated, equals
    ``scan_commit_plain`` with its ``Hold``: held rows of every state leaf
    but pend_age untouched, every other byte written.
"""

import ctypes

import numpy as np
import pytest
import torch

import headtrackr_tpu_torch as pt
from headtrackr_tpu_torch import toy_cascade
from headtrackr_tpu_torch.kernels import schedule as S
from headtrackr_tpu_torch.runtime.serving import _leaves

torch.set_num_threads(2)


def _program(**kw):
    tb = pt.BatchedTracker(4, (48, 64), cascade=toy_cascade(), device="cpu",
                           bucket=1, **kw)
    tb._steps.scheduled = True
    return tb._steps.program(tb.state)


def test_passed_through_leaf_gets_no_entry():
    """The all-CS body under a band passes the camshift model histograms
    (and every other leaf its step leaves unchanged) through as
    ``state_in``'s own tensors: no commit pair copies them, while
    pend_age is committed from tick_select's ``age``; the carried leaves
    but pend_age are flagged held (MERGE_HOLD, with their row bytes) in
    the program's tables."""
    prog = _program(band=(32, 48), bandHist=True)
    bufs = prog.bufs
    state, out = prog.bodies[0].run()
    assert state.cs.model_hist is bufs.state_in.cs.model_hist
    carry, rows = prog._commit_pairs(state, out)
    dsts = [d for _, d in carry]
    assert not any(d is bufs.state_in.cs.model_hist for d in dsts)
    assert any(s is bufs.age and d is bufs.state_in.pend_age
               for s, d in carry)
    for src, dst in carry:
        assert src.data_ptr() != dst.data_ptr()
    assert len(rows) == len(out)
    assert len(prog.held) == len(_leaves(bufs.state_in)) - 1
    assert not any(h is bufs.state_in.pend_age for h in prog.held)
    table = S.segments([(carry, rows)], "cpu", prog.held)
    want = sum(s.nbytes for s, _ in carry) + sum(v.nbytes for v, _, _ in rows)
    assert int(table.segs[:, 2].sum()) == want
    flags = table.merges[:len(carry)].tolist()
    for (src, dst), (_, rb, _, kind) in zip(carry, flags):
        held = dst is not bufs.state_in.pend_age
        assert kind == (S.MERGE_HOLD if held else S.MERGE_NONE)
        assert rb == (dst.nbytes // dst.shape[0] if held else 0)
    assert not table.merges[len(carry):].any()
    # a body that changes the histograms (the full tick's) commits them
    full = prog.bodies[-1]
    state, out = full.run()
    carry, _ = prog._commit_pairs(state, out)
    assert any(d is bufs.state_in.cs.model_hist for _, d in carry)


def test_overlapping_result_raises():
    """A source that overlaps a destination of the same commit (a view of
    the state it is copied over, or an output row read from a leaf the
    commit writes) raises when the table is built and in the twin; a leaf
    of one tensor on both sides is no entry at all, and an output row that
    reads a leaf the commit does not write is fine."""
    dst = torch.arange(32, dtype=torch.int32)
    other = torch.zeros(32, dtype=torch.int32)
    pack = torch.zeros((1, 2, 32), dtype=torch.int32)
    bad = [([(dst.flip(0)[:16].contiguous(), dst[:16])], []),  # fine: a copy
           ([(dst[8:24], dst[:16])], []),
           ([(other, dst)], [(dst, 0, 0)])]
    S.segments([bad[0]], "cpu")
    for carry, rows in bad[1:]:
        with pytest.raises(ValueError, match="overlaps"):
            S.segments([(carry, rows)], "cpu")
        with pytest.raises(ValueError, match="overlaps"):
            S.scan_commit_plain(0, carry, [(s, pack, r) for s, _, r in rows])
    S.segments([([(other, dst)], [(torch.ones(32, dtype=torch.int32), 0, 0)])],
               "cpu")
    grid = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="1-D strided"):
        S.segments([([(grid[:, :4], torch.zeros((4, 4), dtype=torch.int32))],
                     [])], "cpu")
    S.segments([([], [(grid[:, 3], 0, 0)])], "cpu")


def _emulate(params, ct, t):
    """scan_commit's kernel on table t of ``ct`` (CPU addresses): each
    chunk of ``commit_chunks`` copied from its entry's source to its
    destination (a pack row: row * K + k of params' pack ``slot``)."""
    k, K = int(params[S.P_K]) - 1, int(params[S.P_TICKS])
    for e, off, nbytes in S.commit_chunks(ct, t):
        src, dst, size, slot, row, _, pitch, elem = ct.segs[e].tolist()
        if slot >= 0:
            dst = int(params[S.P_OUT + slot]) + (row * K + k) * size
        if not pitch:
            ctypes.memmove(dst + off, src + off, nbytes)
            continue
        for i in range(off, off + nbytes, elem):  # a strided source
            ctypes.memmove(dst + i, src + i // elem * pitch, elem)


@pytest.mark.parametrize("n", [13, 16, 100])
def test_chunk_map_copies_what_the_twin_copies(n):
    """Three tables (a tick body's, an escape body's, one empty) of state
    leaves of (n,), (n, 4), (n, 4096) f32, (n,) bool and (n, 15) i32 and
    output rows of every dtype, some sources off the 16-byte grid: the
    chunk map covers each entry's bytes exactly once, in order, and its
    copies equal scan_commit_plain's, leaves and pack rows, at tick k = 2
    of K = 3."""
    rng = np.random.default_rng(n)

    def leaf(shape, dtype):
        if dtype == torch.bool:
            return torch.from_numpy(rng.random(shape) < 0.5)
        return torch.from_numpy(rng.integers(-99, 99, shape)).to(dtype)

    shapes = [((n,), torch.float32), ((n, 4), torch.int32),
              ((n, 4096), torch.float32), ((n,), torch.bool),
              ((n, 15), torch.int32)]
    out_dtypes = [torch.float32, torch.bool, torch.int32, torch.float32]
    K, k = 3, 2
    packs = {dt: torch.zeros((sum(d == dt for d in out_dtypes), K, n),
                             dtype=dt) for dt in (torch.float32, torch.bool,
                                                  torch.int32)}
    slots = {dt: j for j, dt in enumerate(packs)}
    rows_of = [sum(d == dt for d in out_dtypes[:i])
               for i, dt in enumerate(out_dtypes)]
    tables, plain = [], []
    for t in range(3):
        srcs = [leaf(s, d) for s, d in shapes]
        srcs[3] = leaf((n + 1,), torch.bool)[1:]  # off the 16-byte grid
        dsts = [torch.zeros(s, dtype=d) for s, d in shapes]
        outs = [leaf((n,), d) for d in out_dtypes]
        outs[1] = leaf((n + 3,), torch.bool)[3:]
        outs[3] = leaf((n, 5), torch.float32)[:, 2]  # a column: strided
        if t == 2:
            srcs, dsts, outs = [], [], []
        carry = list(zip(srcs, dsts))
        rows = [(v, slots[d], r) for v, d, r in zip(outs, out_dtypes,
                                                    rows_of)]
        tables.append((carry, rows))
        plain.append(([(s, d.clone()) for s, d in carry],
                      [(v, packs[d].clone(), r) for v, d, r in
                       zip(outs, out_dtypes, rows_of)]))
    ct = S.segments(tables, "cpu")
    params = torch.zeros(S.PARAM_WORDS, dtype=torch.int64)
    params[S.P_K], params[S.P_TICKS] = k + 1, K
    for dt, j in slots.items():
        params[S.P_OUT + j] = packs[dt].data_ptr()
    assert ct.chunks == max(int(ct.tables[t, 2]) for t in range(3))
    for t, (carry, rows) in enumerate(tables):
        first, count, chunks, _ = ct.tables[t].tolist()
        seen = {}
        for e, off, nbytes in S.commit_chunks(ct, t):
            assert first <= e < first + count and 0 < nbytes <= 16
            assert off == seen.get(e, 0)
            seen[e] = off + nbytes
        assert [seen[e] for e in sorted(seen)] == \
            ct.segs[first:first + count, 2].tolist()
        for pk in packs.values():
            pk.zero_()
        _emulate(params, ct, t)
        pcarry, prows = plain[t]
        S.scan_commit_plain(k, pcarry, prows)
        for (_, got), (_, want) in zip(carry, pcarry):
            assert torch.equal(got, want), t
        for (_, slot, row), (_, want, r) in zip(rows, prows):
            dt = want.dtype
            assert torch.equal(packs[dt][row, k], want[r, k]), (t, dt, row)


def _emulate_merged(params, ct, t, held=None):
    """scan_commit's kernel on table t of ``ct`` with its slot map (CPU
    addresses), byte by byte in the kernel's logic: a merged entry's byte
    of a row the map names from that row's sub row, any other from its
    source; a rows entry's chunks over its sub rows, each landing on its
    slot's row where kept and not padding.  ``held`` (rows flagged, or
    None): an entry flagged MERGE_HOLD leaves its held rows' bytes."""
    k, K = int(params[S.P_K]) - 1, int(params[S.P_TICKS])
    idx_p, keep_p, nslots, n = ct.maps[t].tolist()
    idx = (ctypes.c_int64 * nslots).from_address(idx_p) if nslots else []
    keep = (ctypes.c_uint8 * nslots).from_address(keep_p) if nslots else []
    rows = {j: idx[j] for j in range(nslots)
            if keep[j] and 0 <= idx[j] < n}
    slot_of = {r: j for j, r in rows.items()}
    byte = lambda a: ctypes.c_uint8.from_address(a)  # noqa: E731
    for e, off, nbytes in S.commit_chunks(ct, t):
        src, dst, size, slot, row, _, pitch, elem = ct.segs[e].tolist()
        sub, rb, sub_pitch, kind = ct.merges[e].tolist()
        hold = held is not None and kind & S.MERGE_HOLD
        kind &= ~S.MERGE_HOLD
        if kind == S.MERGE_ROWS:
            j, o = divmod(off, rb)
            if j not in rows:
                continue
            base = dst if slot < 0 else \
                int(params[S.P_OUT + slot]) + (row * K + k) * n * rb
            from_ = sub + (j * sub_pitch if sub_pitch else j * rb)
            ctypes.memmove(base + rows[j] * rb + o, from_ + o, nbytes)
            continue
        if slot >= 0:
            dst = int(params[S.P_OUT + slot]) + (row * K + k) * size
        for i in range(off, off + nbytes):
            if hold and held[i // rb]:
                continue
            j = slot_of.get(i // rb) if kind == S.MERGED else None
            if j is not None:
                at = sub + (j * sub_pitch if sub_pitch else j * rb) + i % rb
            else:
                at = src + (i // elem * pitch + i % elem if pitch else i)
            byte(dst + i).value = byte(at).value


@pytest.mark.parametrize("n", [9, 40])
def test_merged_entries_copy_what_the_twin_copies(n):
    """A bucket body's table: its slot map (8 slots, a dropped slot and
    padding with N), merged entries (a whole copy whose served rows come
    from the sub rows) of (n,), (n, 4) i32, (n, 15) f32 and (n,) bool
    leaves, rows-alone entries (the leaf passed through: only its served
    rows written) of an (n, 4096) f32 and an (n,) i32 leaf, merged output
    rows of every dtype, a strided source and a strided sub among them;
    beside a table without a map.  The chunk map covers each entry once
    (a rows entry's chunks its S sub rows', row by row), and the kernel's
    byte logic, emulated, equals scan_commit_plain's merge: the kept rows
    from the sub rows, the rest from the source (or untouched)."""
    rng = np.random.default_rng(n)

    def leaf(shape, dtype):
        if dtype == torch.bool:
            return torch.from_numpy(rng.random(shape) < 0.5)
        return torch.from_numpy(rng.integers(-99, 99, shape)).to(dtype)

    s = 8
    idx = torch.tensor([3, 0, n - 1, 5, 7, n, n, n], dtype=torch.int64)
    keep = torch.tensor([True, True, True, False, True, False, True, False])
    slots = S.Slots(idx, keep)
    merged = [((n,), torch.float32), ((n, 4), torch.int32),
              ((n, 15), torch.float32), ((n,), torch.bool)]
    alone = [((n, 4096), torch.float32), ((n,), torch.int32)]
    out_dtypes = [torch.float32, torch.bool, torch.int32, torch.float32]
    K, k = 2, 1
    packs = {dt: torch.zeros((sum(d == dt for d in out_dtypes), K, n),
                             dtype=dt) for dt in (torch.float32, torch.bool,
                                                  torch.int32)}
    pslot = {dt: j for j, dt in enumerate(packs)}
    rows_of = [sum(d == dt for d in out_dtypes[:i])
               for i, dt in enumerate(out_dtypes)]
    carry = [(leaf(sh, dt), leaf(sh, dt), leaf((s,) + sh[1:], dt))
             for sh, dt in merged]
    carry[0] = (leaf((n, 3), torch.float32)[:, 1],) + carry[0][1:]
    carry += [(None, leaf(sh, dt), leaf((s,) + sh[1:], dt))
              for sh, dt in alone]
    outs = [leaf((n,), d) for d in out_dtypes]
    subs = [leaf((s,), d) for d in out_dtypes]
    subs[3] = leaf((s, 3), torch.float32)[:, 2]  # a strided sub
    rows = [(v, pslot[d], r, sv) for v, d, r, sv in zip(outs, out_dtypes,
                                                        rows_of, subs)]
    plain_carry = [(c[0], c[1].clone(), c[2]) for c in carry]
    plain_packs = {dt: p.clone() for dt, p in packs.items()}
    other = ([(leaf((n,), torch.int32), torch.zeros(n, dtype=torch.int32))],
             [])
    ct = S.segments([other, (carry, rows, slots)], "cpu")
    first, count, chunks, _ = ct.tables[1].tolist()
    assert ct.maps[0].tolist() == [0, 0, 0, 0]
    assert ct.maps[1].tolist()[2:] == [s, n]
    kinds = ct.merges[first:first + count, 3].tolist()
    assert kinds.count(S.MERGE_ROWS) == 2 and kinds.count(S.MERGED) == 8
    # a rows entry moves its S rows, not the leaf
    assert int(ct.segs[first + 4, 2]) == s * 4096 * 4
    seen = {}
    for e, off, nbytes in S.commit_chunks(ct, 1):
        assert off == seen.get(e, 0) and 0 < nbytes <= 16
        seen[e] = off + nbytes
    assert [seen[e] for e in sorted(seen)] == \
        ct.segs[first:first + count, 2].tolist()
    params = torch.zeros(S.PARAM_WORDS, dtype=torch.int64)
    params[S.P_K], params[S.P_TICKS] = k + 1, K
    for dt, j in pslot.items():
        params[S.P_OUT + j] = packs[dt].data_ptr()
    _emulate_merged(params, ct, 1)
    S.scan_commit_plain(k, plain_carry,
                        [(v, plain_packs[d], r, sv) for v, d, r, sv in
                         zip(outs, out_dtypes, rows_of, subs)], slots)
    for i, (c, w) in enumerate(zip(carry, plain_carry)):
        assert torch.equal(c[1], w[1]), i
    for dt in packs:
        assert torch.equal(packs[dt][:, k], plain_packs[dt][:, k]), dt
    # the kept rows took their sub rows; the dropped slot's row did not
    dst, sub = plain_carry[4][1], plain_carry[4][2]
    assert torch.equal(dst[3], sub[0]) and torch.equal(dst[n - 1], sub[2])
    assert not torch.equal(dst[5], sub[3])


def test_few_table_writes_kept_rows_alone():
    """The few escape body's table (``_Program._few_pairs``): rows-alone
    entries only (no source), the kept rows of each state leaf the "track"
    step changed (not the model histograms it passes through, not
    pend_age) and of each output but ``escaped``, into a pack row of the
    program's layout; S sub rows each, no leaf whole.  The kernel's byte
    logic, emulated, equals scan_commit_plain's merge: the kept slot's rows
    written, the padding's dropped, every other row untouched."""
    prog = _program(band=(32, 48), bandHist=True, escape_bucket=2)
    bufs = prog.bufs
    bufs.eidx.copy_(torch.tensor([2, 4]))  # one escaped stream, padding
    merge = prog.few.run()
    carry, rows, slots = prog._few_pairs(merge)
    assert carry and all(c[0] is None for c in carry)
    assert not any(c[1] is bufs.state_in.cs.model_hist
                   or c[1] is bufs.state_in.pend_age for c in carry)
    assert len(rows) == len(merge.out) - 1 and all(r[0] is None
                                                   for r in rows)
    assert slots.keep.tolist() == [True, False]
    ct = S.segments([(carry, rows, slots)], "cpu")
    first, count = ct.tables[0, :2].tolist()
    assert set(ct.merges[first:first + count, 3].tolist()) == {S.MERGE_ROWS}
    assert int(ct.segs[:, 2].sum()) == sum(c[2].nbytes for c in carry) + \
        sum(r[3].nbytes for r in rows)
    K, k, n = 2, 1, bufs.state_in.mode.shape[0]
    packs = [torch.zeros((bufs.packs[dt][0], K, n), dtype=dt)
             for dt in prog.dtypes]
    plain = [p.clone() for p in packs]
    dsts = [c[1].clone() for c in carry]
    params = torch.zeros(S.PARAM_WORDS, dtype=torch.int64)
    params[S.P_K], params[S.P_TICKS] = k + 1, K
    for j, p in enumerate(packs):
        params[S.P_OUT + j] = p.data_ptr()
    was = [c[1].clone() for c in carry]
    _emulate_merged(params, ct, 0)
    S.scan_commit_plain(k, [(None, d, c[2]) for d, c in zip(dsts, carry)],
                        [(None, plain[r[1]], r[2], r[3]) for r in rows],
                        slots)
    for c, d, w in zip(carry, dsts, was):
        assert torch.equal(c[1], d)
        assert torch.equal(c[1][[0, 1, 3]], w[[0, 1, 3]])  # rows not kept
    for p, q in zip(packs, plain):
        assert torch.equal(p, q)


@pytest.mark.parametrize("body", [0, 1])
def test_held_rows_stay_as_they_are(body):
    """A many escape tick's commit of the tick body's table (the all-CS
    body's; the bucket body's at 1 slot, a served stream merged in) with
    the escaped streams 0, 2 and 3 held: the kernel's byte logic,
    emulated, equals ``scan_commit_plain`` with ``Hold``: the held rows
    of every carried leaf but pend_age keep the state's bytes, pend_age
    and the outputs are written whole, the rest of each leaf is the
    body's."""
    prog = _program(band=(32, 48), bandHist=True)
    bufs = prog.bufs
    n = bufs.state_in.mode.shape[0]
    bufs.idx.copy_(torch.tensor([1] + [n] * (bufs.idx.numel() - 1)))
    bufs.state_in.mode[1] = 1  # the served stream: VJ, kept
    res = prog.bodies[body].run()
    table = prog._commit_pairs(*res[:2], *(res[2:] or [None]))
    carry, rows, *slots = table
    ct = S.segments([table], "cpu", prog.held)
    esc = torch.tensor([True, False, True, True])
    K, k = 2, 1
    packs = [torch.zeros((bufs.packs[dt][0], K, n), dtype=dt)
             for dt in prog.dtypes]
    plain = [p.clone() for p in packs]
    for c in carry:  # distinct bytes to keep or overwrite
        c[1].view(torch.uint8).copy_(torch.randint(
            0, 256, c[1].view(torch.uint8).shape, dtype=torch.uint8))
    was = [c[1].clone() for c in carry]
    params = torch.zeros(S.PARAM_WORDS, dtype=torch.int64)
    params[S.P_K], params[S.P_TICKS] = k + 1, K
    for j, p in enumerate(packs):
        params[S.P_OUT + j] = p.data_ptr()
    _emulate_merged(params, ct, 0, esc.tolist())
    got = [c[1].clone() for c in carry]
    for c, w in zip(carry, was):
        c[1].copy_(w)
    S.scan_commit_plain(k, carry, [(r[0], plain[r[1]], r[2]) + tuple(r[3:])
                                   for r in rows], *(slots or [None]),
                        hold=S.Hold(esc, prog.held))
    bits = lambda t: t.contiguous().view(torch.uint8)  # noqa: E731
    for c, g, w in zip(carry, got, was):
        assert torch.equal(bits(g), bits(c[1]))
        if any(c[1] is h for h in prog.held):
            assert torch.equal(bits(g[esc]), bits(w[esc]))
        elif c[0] is not None:
            assert torch.equal(bits(g[esc]), bits(c[0][esc]))
    for p, q in zip(packs, plain):
        assert torch.equal(p, q)
    assert any(c[1] is bufs.state_in.pend_age for c in carry)
