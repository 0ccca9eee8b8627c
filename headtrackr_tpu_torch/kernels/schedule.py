"""Wrappers of the serving program's CUDA kernels (``csrc/schedule.cu``),
their plain twins, and the program's CUDA graph.

  tick_select    the control flow of headtrackr_tpu/runtime/serving.py:326
                 auto_step: the branch rule (its lax.switch), the
                 oldest-first top_k of the served streams and their new
                 pend_age (_aged); and :426 scan_steps' tick count
  escape_select  :225 _escape_checked: none / few / many (its lax.switch)
                 and the top_k of the escaped streams (few), or all of
                 them, listed for the many body's chunks
  scan_step      :426 scan_steps (lax.scan): tick k's frames, which
                 tick_select locates, into a buffer (rows or whole); the
                 program runs none, since every body reads them in place
  scan_commit    the scan's carried state and its stacked outputs: the
                 tick body's results (each body keeps its own), by
                 ``segments``' table of that body; a sub-batch's rows
                 merged in by the table's slot map (:210-223
                 _scatter_subbatch): a bucket body's, and an escape
                 body's rows alone after the tick body's (the many body's
                 a chunk at a time, after a tick commit that holds the
                 escaped streams' state rows: :264-274 many's tree_where)
  slot_gather    :299-320 _apply_bucket's and :249-274 the escape
                 branches' gathers over the state (a[safe]) and their
                 ``valid`` flags (the bucket's rule or the escape's), one
                 launch (the many body's: a chunk of escape_select's list)

None replaces a Pallas kernel: the reference leaves these to XLA's control
flow inside one program.  Dispatch as the other wrappers: a CPU tensor
takes the plain twin, a CUDA tensor launches the kernel, any other device
raises.  In the program (``Graph``) the two selects also set CUDA graph
conditional handles, which choose the IF node of the tick's body and of
the escape fallback's, and tick_select also the WHILE node's (k < K
after it advances k); launched alone here they set none.  On the CPU the serving program (runtime/serving.py
``_Program``) runs the twins, whose selection drives a Python ``if``: the
conditional nodes' twin.

Branches of a tick (``tick_select``): 0 "track"; 1 .. m the bucket over
s * kb slots (m = chunk_cap // kb; the bucket and chunk ticks, and the
rotation at s = m); m + 1 "wbtrack"; m + 2 "full" (overload "full" only).
"""

import ctypes
import functools
from typing import NamedTuple

import torch

from .launch import frames_of, frames_source, launch, on_cuda

__all__ = ["tick_select", "tick_select_plain", "escape_select",
           "escape_select_plain", "escape_list_plain", "scan_step",
           "scan_step_plain",
           "scan_commit", "scan_commit_plain", "segments", "Graph",
           "PARAM_WORDS", "select_blocks", "scratch_bytes",
           "scratch", "select_floor", "CommitTables", "commit_ctas",
           "commit_chunks", "check_commit", "Slots", "slot_gather",
           "slot_gather_plain", "SLOT_LEAVES", "gather_ctas", "TABLE_PICK",
           "TABLE_TICK", "Hold", "CHUNK_START", "CHUNK_NEXT", "TAIL_NEXT",
           "chunk_plan"]

MODE_VJ, MODE_CS = 1, 2
# a select's grid (csrc/schedule.cu kSelThreads, kSelKeys, kMaxSelCtas):
# CTAs of SELECT_THREADS threads, each over a block of streams in passes of
# SELECT_THREADS, its keys in SELECT_KEYS words of shared memory
SELECT_THREADS = 256
SELECT_KEYS = 4096
SELECT_MAX_CTAS = 256
# the parameter block's 64-bit words (csrc/schedule.cu Params)
PARAM_WORDS = 38
P_K, P_TICKS, P_FORCE, P_STEPS, P_BRANCH, P_ESEL, P_FRAMES, P_OUT = range(8)
P_COMMITS = 11  # scan_commit's runs this launch (P_STEPS: scan_step's)
P_FRAME_AT = 12  # the tick's frames: tick_select writes P_FRAMES + k bytes
P_CHUNKS = 15  # the many escape body's big chunks this tick
P_RUNS = 16  # runs this launch: tick_select's by its body from here,
ESCAPE_RUNS = 8  # escape_select's at P_RUNS + ESCAPE_RUNS + sel
RUN_WORDS = 16  # the runs' words
P_CHUNK = 32  # the many body's big chunk that runs (slot_gather reads it)
P_CHUNK_RUNS = 33  # its big chunks run this launch
P_TAIL, P_TAILS = 34, 35  # its small chunk that runs, the end of them
P_TAIL_RUNS = 36  # its small chunks run this launch
# sched_program_build's argument words (csrc/schedule.cu BuildArg)
BUILD_ARGS = ("mode", "age", "idx", "age_out", "params", "n", "kb", "cap",
              "rotate", "esc_at", "eidx", "eb", "frame_bytes", "tables",
              "segs", "commit_ctas", "few", "many", "sel_scratch",
              "sel_bytes", "esc_scratch", "esc_bytes", "merges", "maps",
              "elist", "chunk_rows", "list_len", "tail", "tail_rows")
# scan_commit's grid (csrc/schedule.cu kCopyThreads): CTAs of COMMIT_THREADS
# threads, a thread a 16-byte chunk of the table at a time, at most
# COMMIT_CTAS_PER_SM CTAs an SM (one wave: 2,048 threads an SM)
COMMIT_THREADS = 256
COMMIT_CHUNK = 16
COMMIT_CTAS_PER_SM = 8
# a commit entry's merge kinds (csrc/schedule.cu Merge): none, a whole copy
# whose mapped rows come from the sub rows, the mapped rows alone; the flag
# of a leaf whose held rows a commit with held rows leaves
MERGE_NONE, MERGED, MERGE_ROWS, MERGE_HOLD = 0, 1, 2, 4
# scan_commit's table arguments below 0 (csrc/schedule.cu kTablePick,
# kTableTick): the program's pick; the tick body's
TABLE_PICK, TABLE_TICK = -1, -2
# scan_commit's steps of the many body's chunk loops (csrc/schedule.cu
# kChunkStart, kChunkNext, kTailNext)
CHUNK_START, CHUNK_NEXT, TAIL_NEXT = 1, 2, 3
# the small chunks past the big ones at most (csrc/schedule.cu kTailChunks)
TAIL_CHUNKS = 2
# slot_gather's leaves a launch (csrc/schedule.cu kMaxLeaves) and its grid
# (kWarpBytes, kGatherWarps, kGatherSpan): a leaf's row in warp-units of
# GATHER_WARP_BYTES, GATHER_SPAN of them a warp, GATHER_WARPS warps a CTA
SLOT_LEAVES = 32
GATHER_WARP_BYTES = 512
GATHER_WARPS = 8
GATHER_SPAN = 1
MIN_DRIVER = 12040  # conditional nodes: CUDA 12.4
# cudaGraphNodeType
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
              5: "empty", 6: "wait event", 7: "event record",
              8: "external semaphore signal", 9: "external semaphore wait",
              10: "memory allocation", 11: "memory free",
              12: "batch memory operation", 13: "conditional"}


def select_blocks(n, cap):
    """A select's grid for n streams and cap slots (csrc/schedule.cu
    select_grid): (ctas, span), CTA b over the streams [b * span, (b + 1)
    * span).  At most SELECT_KEYS // cap CTAs, so that a bucket tick's
    merge fits in shared memory; at least n / SELECT_KEYS, so that a
    CTA's keys do; at most one a pass of SELECT_THREADS streams."""
    tiles = -(-n // SELECT_THREADS)
    g = max(min(max(1, SELECT_KEYS // cap), tiles, SELECT_MAX_CTAS),
            -(-n // SELECT_KEYS))
    if g > SELECT_MAX_CTAS:
        raise ValueError(f"a select takes at most "
                         f"{SELECT_MAX_CTAS * SELECT_KEYS} streams, got {n}")
    span = -(-tiles // g) * SELECT_THREADS
    return -(-n // span), span


def scratch_bytes(n, cap):
    """The bytes of a select's scratch buffer (csrc/schedule.cu
    select_scratch): the ticket, the CTAs' counts and candidates, and a
    merge past SELECT_KEYS candidates."""
    ctas, span = select_blocks(n, cap)
    return (8 + -(-12 * ctas // 8) * 8 + 8 * ctas * span
            + 8 * (1 << max(0, n - 1).bit_length()))


_scratch = {}


def scratch(n, cap, device):
    """A zeroed scratch buffer for a select of n streams and cap slots on
    ``device``, one a (device, bytes), kept: a select leaves its ticket at
    0, so launches on one stream share it (the serving program allocates
    its own)."""
    key = (torch.device(device), scratch_bytes(n, cap))
    if key not in _scratch:
        _scratch[key] = torch.zeros(key[1], dtype=torch.uint8, device=device)
    return _scratch[key]


def _blocks(flags, n, cap):
    """``flags`` (N,) as (ctas, span) rows of the select's CTAs, padded
    with zeros."""
    ctas, span = select_blocks(n, cap)
    return torch.nn.functional.pad(flags, (0, ctas * span - n)) \
        .view(ctas, span)


def tick_select_plain(mode, age, kb, cap, rotate, force=0, idx=None):
    """The tick_select kernel's twin: (branch, idx, age_out) for a tick
    whose streams enter in ``mode`` (N,) i32 with ``age`` (N,) i32 pend_age,
    at bucket kb and chunk cap ``cap`` (a multiple of kb), overload
    "rotate" when ``rotate``.  idx: (cap,) i64, the served streams of a
    bucket branch oldest first (key 1 + age, ties to the lower index, the
    reference's top_k), padded with N, else all N; age_out: the reference's
    ``_aged`` on a bucket branch (served and CS streams 0, pending unserved
    streams age + 1), else 0.  force = 1 + slots (the host's own bucket of
    ``idx``, step_bucket): the bucket over that many slots (0: "track"),
    ``idx`` as given and pend_age kept.

    In the kernel's stages: the streams in blocks of ``select_blocks``'s
    span (a multiple of SELECT_THREADS), each block's pending count,
    pending-VJ count and candidates (its pending streams' keys (1 + age)
    << 32 | ~i; past cap of them its cap largest under "rotate", else
    none); then the merge: the counts summed, the branch, the candidates
    sorted descending, the min(npend, cap) first served and, on a rotation
    past cap, the pending streams whose key is below the last served one
    aged by one."""
    n = mode.shape[0]
    m = cap // kb
    if force:
        return (force - 1) // kb, idx, age.clone()
    pend = mode != MODE_CS
    key = torch.where(pend, (1 + age.long()) << 32
                      | (0xFFFFFFFF - torch.arange(n, device=mode.device)),
                      0)
    # the CTAs: counts and candidates
    blocks = _blocks(key, n, cap)
    counts = (blocks > 0).sum(1)
    counts_vj = _blocks((mode == MODE_VJ).int(), n, cap).sum(1)
    top = blocks.sort(1, descending=True).values
    keep = torch.where(counts <= cap, counts, cap if rotate else 0)
    cand = top[torch.arange(top.shape[1], device=mode.device) < keep[:, None]]
    # the last CTA: the merge
    npend, npend_vj = int(counts.sum()), int(counts_vj.sum())
    if npend == 0:
        branch = 0
    elif npend_vj == 0:
        branch = m + 1
    elif npend <= cap or rotate:
        branch = min(-(-npend // kb), m)
    else:
        branch = m + 2
    out = torch.full((cap,), n, dtype=torch.int64, device=mode.device)
    age_out = torch.zeros_like(age)
    if 1 <= branch <= m:
        served = min(npend, cap)
        merged = cand.sort(descending=True).values[:served]
        out[:served] = 0xFFFFFFFF - (merged & 0xFFFFFFFF)
        if npend > cap:
            age_out = torch.where(pend & (key < merged[-1]), age + 1, 0) \
                .to(age.dtype)
    return branch, out, age_out


def escape_select_plain(esc, eb):
    """The escape_select kernel's twin: (sel, eidx) for the escaped
    streams ``esc`` (N,) bool and escape bucket ``eb``: sel 0 (none
    escaped), 1 (few: 1 .. eb escaped and eb < N) or 2 (many); eidx (eb,)
    i64, on few the escaped streams lowest first, padded with N (the
    reference's top_k of the escaped flags), else all N.

    In the kernel's stages: the streams in blocks of ``select_blocks``'s
    span, each block's escaped count and its escaped streams in order
    (past eb of them none); then the merge: the counts summed, the
    selection, and on few the blocks' streams in block order."""
    n = esc.shape[0]
    blocks = _blocks(esc.to(torch.uint8), n, eb)
    counts = blocks.sum(1)
    kept = blocks * (counts <= eb)[:, None]  # a block's streams, in order
    nesc = int(counts.sum())
    sel = 0 if nesc == 0 else 1 if eb < n and nesc <= eb else 2
    eidx = torch.full((eb,), n, dtype=torch.int64, device=esc.device)
    if sel == 1:
        eidx[:nesc] = torch.nonzero(kept.flatten()).flatten()
    return sel, eidx


def chunk_plan(nesc, m, mb):
    """The many escape body's chunks for ``nesc`` escaped streams
    (csrc/schedule.cu chunk_plan): (big, tail0, tails), big chunks of
    ``mb`` slots of the list (nesc // mb, one more where the rest exceeds
    TAIL_CHUNKS small chunks), then the small chunks [tail0, tails) of
    ``m`` slots (mb a multiple of m) for what is left."""
    big = nesc // mb
    if nesc - big * mb > TAIL_CHUNKS * m:
        big += 1
    tail0 = big * (mb // m)
    return big, tail0, max(tail0, -(-nesc // m))


def escape_list_plain(esc, m, mb):
    """The escape_select kernel's list on many: (elist, plan) for the
    escaped streams ``esc`` (N,) bool, the many body's small chunk of
    ``m`` slots and big chunk of ``mb`` (a multiple of m): elist (ceil(N
    / mb) * mb,) i64, every escaped stream lowest first, padded with N;
    plan ``chunk_plan``'s.  In the kernel's stages: each block's escaped
    streams in order, the blocks' in block order."""
    n = esc.shape[0]
    idx = torch.nonzero(esc.flatten()).flatten()
    elist = torch.full((-(-n // mb) * mb,), n, dtype=torch.int64,
                       device=esc.device)
    elist[:idx.numel()] = idx
    return elist, chunk_plan(idx.numel(), m, mb)


def scan_step_plain(src, frames, rows=None):
    """The scan_step kernel's twin: a tick's frames ``src`` into the
    buffer ``frames`` of their shape, whole, or with ``rows`` (i64 slots)
    only those rows into the same rows, a slot outside [0, N) skipped
    (padding); nothing when they are one."""
    if src.data_ptr() == frames.data_ptr():
        return
    if rows is None:
        frames.copy_(src)
        return
    rows = rows[(rows >= 0) & (rows < frames.shape[0])]
    frames.index_copy_(0, rows, src.index_select(0, rows))


def _span(t):
    """[first, last) bytes a tensor's elements cover."""
    last = sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
    end = t.data_ptr() + (last + 1) * t.element_size() if t.numel() else \
        t.data_ptr()
    return t.data_ptr(), end


def _pitch(src):
    """A source's element pitch in bytes: 0 when contiguous, its stride for
    a 1-D strided view; any other layout raises."""
    if src.is_contiguous():
        return 0
    if src.dim() != 1:
        raise ValueError(f"a result of shape {tuple(src.shape)} and strides "
                         f"{src.stride()}: the commit takes contiguous "
                         f"tensors and 1-D strided views")
    return src.stride(0) * src.element_size()


class Slots(NamedTuple):
    """A bucket body's slot map: its sub-batch row j lands on stream
    ``idx[j]`` where ``keep[j]`` (and idx[j] < N: padding is dropped).
    idx (S,) i64, keep (S,) bool."""
    idx: torch.Tensor
    keep: torch.Tensor


class Hold(NamedTuple):
    """A commit's held rows (the many escape body's tick): in each carried
    leaf of ``leaves`` (destination tensors, by identity) the rows of the
    streams that ``rows`` ((N,) bool) flags stay as they are."""
    rows: torch.Tensor
    leaves: tuple


def check_commit(carry, rows):
    """Raise unless no source of ``carry`` ((src, dst[, sub]) entries) or
    ``rows`` ((src, slot, row[, sub]) entries), sub rows included, overlaps
    a destination of ``carry`` (a copy must not read what the same copy
    writes), every destination is contiguous and every source contiguous
    or a 1-D strided view.  A body's state leaf that is the destination
    tensor itself (passed through) has no pair, or src None with its sub
    rows (the leaf's served rows alone)."""
    for c in carry:
        if not c[1].is_contiguous():
            raise ValueError("a commit destination must be contiguous")
    dsts = [_span(c[1]) for c in carry]
    srcs = [c[0] for c in carry] + [r[0] for r in rows] + \
        [c[2] for c in carry if len(c) > 2] + [r[3] for r in rows
                                                if len(r) > 3]
    for src in srcs:
        if src is None:
            continue
        _pitch(src)
        a0, a1 = _span(src)
        for d0, d1 in dsts:
            if a0 < d1 and d0 < a1:
                raise ValueError("a body's result overlaps the state it "
                                 "commits into (only a leaf passed through "
                                 "whole may be that state's own tensor)")


def _merge_rows(dst, sub, slots):
    """Rows ``slots.idx`` of ``dst`` (N rows) set from ``sub``'s where kept
    and not padding."""
    sel = slots.keep & (slots.idx >= 0) & (slots.idx < dst.shape[0])
    dst[slots.idx[sel]] = sub[sel].to(dst.dtype)


def scan_commit_plain(k, carry, rows, slots=None, hold=None):
    """The scan_commit kernel's twin: each (src, dst) of ``carry`` copied
    whole (a destination among ``hold``'s leaves all but its held rows),
    each (src, pack, row) of ``rows`` into ``pack[row, k]``; an entry with
    sub rows (a fourth or fifth element) then takes the rows ``slots``
    (``Slots``) names from them, src None copying nothing else.  A source
    that overlaps a destination raises (``check_commit``)."""
    check_commit(carry, rows)
    held = () if hold is None else hold.leaves
    for c in carry:
        if c[0] is not None and any(c[1] is h for h in held):
            c[1][~hold.rows] = c[0][~hold.rows]
        elif c[0] is not None:
            c[1].copy_(c[0])
        if len(c) > 2:
            _merge_rows(c[1], c[2], slots)
    for r in rows:
        src, pack, row = r[:3]
        if src is not None:
            pack[row, k].copy_(src)
        if len(r) > 3:
            _merge_rows(pack[row, k], r[3], slots)


def slot_gather_plain(state, idx, escape=False, extra=(), at=None,
                      into=None):
    """The slot_gather kernel's twin: (sub, keep, *rows): ``sub`` every
    leaf's rows min(idx, N - 1) of ``state`` (a NamedTuple tree of (N, ...)
    tensors, None leaves kept None), ``keep`` (S,) bool, the reference's
    ``valid``: idx < N and, under the bucket's rule, the row's ``mode`` not
    CS (:318); under the escape's (``escape``: every escaped stream entered
    in CS) idx < N alone (:260); then each (N, ...) tensor of ``extra``'s
    same rows.  ``at`` (a (1,) i64 word holding the chunk c) and ``into``
    ((S,) i64): the slots are idx[c S, (c + 1) S), copied into ``into``
    (the many escape body's chunk of escape_select's list).  An ``extra``
    tensor that ``launch.frames_at`` redirects is read at its source."""
    if at is not None:
        c, s = int(at[0]), into.numel()
        into.copy_(idx[c * s:(c + 1) * s])
        idx = into
    n = state.mode.shape[0]
    safe = torch.clamp(idx, max=n - 1)
    extra = tuple(frames_of(t, False)[0] for t in extra)

    def rows(t):
        if isinstance(t, tuple):
            return type(t)(*(rows(v) for v in t))
        return None if t is None else t.index_select(0, safe)

    sub = rows(state)
    keep = idx < n
    if not escape:
        keep &= sub.mode != MODE_CS
    return (sub, keep) + tuple(rows(t) for t in extra)


class _GatherArgs(ctypes.Structure):
    """csrc/schedule.cu's GatherArgs, field for field (``warps`` and
    ``first`` the launcher fills)."""
    _fields_ = [("idx", ctypes.c_void_p), ("mode", ctypes.c_void_p),
                ("keep", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("mode_pitch", ctypes.c_longlong), ("slots", ctypes.c_int),
                ("leaves", ctypes.c_int), ("escape", ctypes.c_int),
                ("warps", ctypes.c_int),
                ("src", ctypes.c_void_p * SLOT_LEAVES),
                ("dst", ctypes.c_void_p * SLOT_LEAVES),
                ("rb", ctypes.c_longlong * SLOT_LEAVES),
                ("pitch", ctypes.c_longlong * SLOT_LEAVES),
                ("first", ctypes.c_int * SLOT_LEAVES),
                ("at", ctypes.c_void_p), ("slots_out", ctypes.c_void_p),
                ("src_at", ctypes.c_void_p), ("src_leaf", ctypes.c_longlong)]


def gather_ctas(row_bytes):
    """slot_gather's grid along x for leaves of ``row_bytes`` bytes a row
    (csrc/schedule.cu gather_layout): each row cut into warp-units of
    GATHER_WARP_BYTES, a leaf starting a warp-unit of its own, a CTA over
    GATHER_WARPS * GATHER_SPAN of them; the grid's y is the slot."""
    warps = sum(-(-rb // GATHER_WARP_BYTES) for rb in row_bytes)
    return max(1, -(-warps // (GATHER_WARPS * GATHER_SPAN)))


def _tree_leaves(tree):
    if isinstance(tree, tuple):
        return [t for v in tree for t in _tree_leaves(v)]
    return [] if tree is None else [tree]


def _rebuild(tree, it):
    if isinstance(tree, tuple):
        return type(tree)(*(_rebuild(v, it) for v in tree))
    return None if tree is None else next(it)


def slot_gather(state, idx, escape=False, extra=(), at=None, into=None):
    """A sub-batch in one launch: ``slot_gather_plain``'s contract (state
    a NamedTuple tree of (N, ...) tensors with a ``mode`` (N,) i32 leaf,
    contiguous or 1-D strided, and ``extra`` (N, ...) tensors gathered in
    the same launch, one of them read in place where ``launch.frames_at``
    redirects it; idx (S,) i64 padded with N, or with ``at`` and ``into``
    a list of chunks of len(into) slots, chunk at[0] gathered and its
    slots written into ``into``; ``escape``: the keep rule).  Returns
    (sub, keep, *rows), the rows fresh contiguous (S, ...) tensors."""
    leaves = _tree_leaves(state) + list(extra)
    n = state.mode.shape[0]
    slots = idx if into is None else into
    if (at is None) != (into is None) or slots.dtype != torch.int64 or \
            slots.dim() != 1 or not 1 <= slots.numel() <= 65535 or \
            (at is not None and (idx.numel() % into.numel() or
                                 at.dtype != torch.int64)):
        raise ValueError("slot_gather's idx is 1 to 65,535 i64 slots, or a "
                         "list of chunks of into's with the word at")
    if any(t.shape[0] != n for t in leaves) or state.mode.dtype != \
            torch.int32:
        raise ValueError("slot_gather takes (N, ...) leaves and an i32 mode")
    if len(leaves) > SLOT_LEAVES:
        raise ValueError(f"slot_gather takes at most {SLOT_LEAVES} leaves")
    if not on_cuda(idx, state.mode):
        return slot_gather_plain(state, idx, escape, extra, at, into)
    s, dev = slots.numel(), idx.device
    subs = [torch.empty((s,) + tuple(t.shape[1:]), dtype=t.dtype, device=dev)
            for t in leaves]
    keep = torch.empty((s,), dtype=torch.bool, device=dev)
    a = _GatherArgs(idx.data_ptr(), state.mode.data_ptr(), keep.data_ptr(),
                    n, state.mode.stride(0), s, len(leaves), int(escape))
    if at is not None:
        a.at, a.slots_out = at.data_ptr(), into.data_ptr()
    for j, (t, d) in enumerate(zip(leaves, subs)):
        if t.device != dev:
            raise ValueError("idx and the state lie on different devices")
        source = frames_source(t) if j >= len(leaves) - len(extra) else None
        if source is not None:  # read in place at the word's address
            if source.dtype != torch.int64 or source.numel() != 1 or \
                    source.device != dev or a.src_at:
                raise ValueError("slot_gather reads one tensor in place, "
                                 "through a (1,) i64 word on its device")
            a.src_at, a.src_leaf = source.data_ptr(), j
        a.src[j], a.dst[j] = t.data_ptr(), d.data_ptr()
        a.rb[j] = d.nbytes // s
        a.pitch[j] = _pitch(t) if t.dim() == 1 else 0
        if t.dim() > 1 and not t.is_contiguous():
            raise ValueError("slot_gather takes contiguous leaves and 1-D "
                             "strided views")
    with torch.cuda.device(dev):
        _checked_gather_layout()
        launch("slot_gather", "slot_gather_launch", ctypes.addressof(a))
    k = len(subs) - len(extra)
    return (_rebuild(state, iter(subs[:k])), keep) + tuple(subs[k:])


@functools.lru_cache(maxsize=1)
def _checked_gather_layout():
    """Raise unless the library's GatherArgs is this module's (once)."""
    from .build import load_library
    got = load_library().fn("slot_gather_args_bytes")()
    if got != ctypes.sizeof(_GatherArgs):
        raise RuntimeError(f"slot_gather's GatherArgs is {got} bytes, the "
                           f"wrapper's {ctypes.sizeof(_GatherArgs)}")


def _check_select(params, n, cap):
    if params.dtype != torch.int64 or params.shape != (PARAM_WORDS,):
        raise ValueError(f"params must be ({PARAM_WORDS},) int64, got "
                         f"{tuple(params.shape)} {params.dtype}")
    if n < 1:
        raise ValueError("a select takes at least one stream")
    select_blocks(n, cap)  # raises past the grid's streams


def tick_select(mode, age, kb, cap, rotate, idx, age_out, params,
                frame_bytes=0):
    """One tick's selection into ``idx`` (cap,) i64 and ``age_out`` (N,)
    i32, its branch into ``params[P_BRANCH]`` and one run into that
    branch's ``params[P_RUNS + branch]``; ``params[P_FORCE]`` is read (see
    tick_select_plain), the tick's frames' address ``params[P_FRAMES] +
    params[P_K] * frame_bytes`` written into ``params[P_FRAME_AT]`` and
    ``params[P_K]`` advanced.  The kernel's scratch buffer is the kept one
    of ``scratch``."""
    n = mode.shape[0]
    _check_select(params, n, cap)
    if mode.dtype != torch.int32 or age.dtype != torch.int32 or \
            idx.dtype != torch.int64 or age_out.dtype != torch.int32 or \
            idx.shape != (cap,) or age.shape != (n,) or \
            age_out.shape != (n,) or cap % kb or not kb <= cap <= n:
        raise ValueError("tick_select takes (N,) i32 mode, age and age_out "
                         "and (cap,) i64 idx, cap a multiple of kb, kb <= "
                         "cap <= N")
    if not on_cuda(mode, age, idx, age_out, params):
        branch, i, a = tick_select_plain(mode, age, kb, cap, rotate,
                                         int(params[P_FORCE]), idx)
        idx.copy_(i)
        age_out.copy_(a)
        params[P_BRANCH] = branch
        params[P_RUNS + branch] += 1
        params[P_FRAME_AT] = params[P_FRAMES] + params[P_K] * frame_bytes
        params[P_K] += 1
        return
    buf = scratch(n, cap, mode.device)
    with torch.cuda.device(mode.device):
        launch("tick_select", "tick_select_launch", mode.data_ptr(),
               age.data_ptr(), idx.data_ptr(), age_out.data_ptr(),
               params.data_ptr(), buf.data_ptr(), buf.numel(), n, kb, cap,
               int(bool(rotate)), int(frame_bytes))


def escape_select(esc, eb, eidx, params, elist=None, m=1, mb=1):
    """The escape fallback's selection into ``eidx`` (eb,) i64, its body
    into ``params[P_ESEL]`` and one run into
    ``params[P_RUNS + ESCAPE_RUNS + sel]`` (see escape_select_plain).
    With ``elist`` (i64, at least N slots, a multiple of the big chunk
    ``mb``, itself a multiple of the small chunk m >= 1): on many the list
    of escape_list_plain and its plan, the big chunks into
    ``params[P_CHUNKS]`` (``params[P_CHUNK]`` zeroed) and the small ones
    [``params[P_TAIL]``, ``params[P_TAILS]``); none on none or few.  The
    kernel's scratch buffer is the kept one of ``scratch``."""
    n = esc.shape[0]
    _check_select(params, n, max(1, eb))
    if esc.dtype != torch.bool or eidx.dtype != torch.int64 or \
            eidx.shape != (eb,) or eb < 1:
        raise ValueError("escape_select takes (N,) bool esc and (eb,) i64 "
                         "eidx, eb >= 1")
    if elist is not None and (elist.dtype != torch.int64 or m < 1 or
                              mb < m or mb % m or elist.dim() != 1 or
                              elist.numel() < n or elist.numel() % mb):
        raise ValueError("escape_select's list is at least N i64 slots, a "
                         "multiple of mb, itself a multiple of m >= 1")
    tensors = (esc, eidx, params) + (() if elist is None else (elist,))
    if not on_cuda(*tensors):
        sel, e = escape_select_plain(esc, eb)
        eidx.copy_(e)
        if elist is not None:
            lst, plan = escape_list_plain(esc, m, mb)
            if sel == 2:
                elist[:lst.numel()] = lst
                elist[lst.numel():] = n
            else:
                plan = chunk_plan(0, m, mb)
            params[P_CHUNKS], params[P_TAIL], params[P_TAILS] = plan
            params[P_CHUNK] = 0
        params[P_ESEL] = sel
        params[P_RUNS + ESCAPE_RUNS + sel] += 1
        return
    buf = scratch(n, eb, esc.device)
    with torch.cuda.device(esc.device):
        launch("escape_select", "escape_select_launch", esc.data_ptr(),
               eidx.data_ptr(), params.data_ptr(), buf.data_ptr(),
               buf.numel(), n, eb, 0 if elist is None else elist.data_ptr(),
               int(m), int(mb), 0 if elist is None else elist.numel())


def select_floor(n, cap):
    """An empty kernel at the grid of a select of n streams and cap slots,
    on the current stream (the floor of one device operation, which
    measurements set beside the selects' times)."""
    from .build import load_library
    err = load_library().fn("select_floor_launch")(
        n, cap, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"select_floor_launch failed: cudaError {err}")


def scan_step(params, frames, rows=None):
    """The tick's frames, read at the address ``params[P_FRAME_AT]``
    (tick_select's), into the buffer ``frames`` (N, ...) u8: whole, or
    with ``rows`` (S,) i64 only those rows into the same rows (a slot
    outside [0, N) skipped).  One run into ``params[P_STEPS]``.
    CUDA only: the frames' address is a device word (the twin is
    scan_step_plain)."""
    if params.dtype != torch.int64 or params.shape != (PARAM_WORDS,) or \
            frames.dtype != torch.uint8 or frames.dim() < 1:
        raise ValueError(f"scan_step takes ({PARAM_WORDS},) int64 params and "
                         "u8 frames")
    tensors = (params, frames) if rows is None else (params, frames, rows)
    if not on_cuda(*tensors):
        raise ValueError("scan_step reads a device address: CUDA tensors "
                         "only (its twin is scan_step_plain)")
    n = frames.shape[0]
    if rows is None:
        nbytes, ptr, nrows = frames.numel(), 0, 0
    else:
        if rows.dtype != torch.int64 or rows.dim() != 1 or \
                not 1 <= rows.numel() <= 65535:
            raise ValueError("scan_step's rows are 1 to 65,535 i64 slots")
        nbytes, ptr, nrows = frames.numel() // n, rows.data_ptr(), \
            rows.numel()
    with torch.cuda.device(frames.device):
        launch("scan_step", "scan_step_launch", params.data_ptr(),
               frames.data_ptr(), nbytes, ptr, nrows, n)


class CommitTables(NamedTuple):
    """scan_commit's tables (csrc/schedule.cu Table, Seg, Merge, SlotMap),
    one a body: ``tables`` (T, 4) i64, table t's first entry, its entries
    and its 16-byte chunks; ``segs`` (S, 8) i64, an entry's source (0 for
    a rows entry), destination (0 for a pack row), bytes, pack slot (-1:
    none), pack row, first chunk in its table, source pitch (0:
    contiguous; a 1-D strided view's element stride in bytes) and element
    bytes; ``chunks``: the most chunks a table holds (the grid's size);
    ``keep``: the tensors the entries address; ``merges`` (S, 4) i64, an
    entry's sub rows, row bytes, sub pitch and merge kind (MERGE_NONE,
    MERGED, MERGE_ROWS, with the flag MERGE_HOLD); ``maps`` (T, 4) i64, a
    table's slot map: idx, keep, slots (0: none) and the leaves' rows
    N."""
    tables: torch.Tensor
    segs: torch.Tensor
    chunks: int
    keep: tuple
    merges: torch.Tensor = None
    maps: torch.Tensor = None


def _row_bytes(leaf):
    """A leaf's row bytes."""
    return leaf.nbytes // leaf.shape[0]


def _merge(leaf, sub, slots, kind):
    """An entry's merge word [sub, row bytes, sub pitch, kind] for the
    (N, ...) ``leaf`` it lands in, raising unless ``sub`` holds the slots'
    rows of the leaf's row shape and dtype."""
    s = slots.idx.numel()
    if sub.shape[0] != s or sub.shape[1:] != leaf.shape[1:] or \
            sub.dtype != leaf.dtype:
        raise ValueError(f"sub rows {tuple(sub.shape)} {sub.dtype} are not "
                         f"{s} rows of the leaf {tuple(leaf.shape)} "
                         f"{leaf.dtype}")
    return [sub.data_ptr(), _row_bytes(leaf), _pitch(sub), kind]


def _pack_row(sub, carry):
    """The shape of the pack row that a rows-alone output entry's ``sub``
    lands in (no tensor): N elements of its dtype, N the rows of the
    table's carried leaves."""
    if sub is None or not carry:
        raise ValueError("an output entry without a source needs sub rows "
                         "and carried leaves")
    return torch.empty((carry[0][1].shape[0],) + tuple(sub.shape[1:]),
                       dtype=sub.dtype, device="meta")


def segments(tables, device, held=()):
    """scan_commit's tables (``CommitTables``) on ``device``, one for each
    (carry, rows[, slots]) of ``tables``: each (src, dst) of carry copied
    whole; each (src, slot, row) of rows into row ``row * K + k`` of the
    output pack at ``params[P_OUT + slot]``, rows of src's bytes (a 1-D
    strided source gathered into them).  With ``slots`` (``Slots``, a
    bucket body's), an entry with a last element ``sub`` (S rows of the
    leaf's row shape) merges them: rows idx[j] (kept, not padding) come
    from sub's row j; an entry whose src is None writes those rows alone
    (a leaf the body passed through whole; an escape body's leaves and
    outputs, a pack row taking the table's carried leaves' N rows).  A
    carried entry with a source whose destination is one of ``held`` (by
    identity) is flagged MERGE_HOLD: a commit with held rows (``Hold``)
    leaves those rows of it as they are.  Each table's entries
    are one run of 16-byte chunks, an entry's bytes rounded up to a whole
    chunk (the kernel copies a partial or unaligned chunk byte by byte), a
    rows-alone entry's S rows each rounded up, so that the copy is
    balanced by bytes.  An empty source is left out; a source that
    overlaps a carry destination raises (``check_commit``), and so does a
    carried pair of two sizes."""
    heads, segs, merges, maps, keep = [], [], [], [], []
    for table in tables:
        carry, rows = table[:2]
        slots = table[2] if len(table) > 2 else None
        check_commit(carry, rows)
        first, chunk, n = len(segs), 0, 0
        entries = [(c[0], c[1], c[1].data_ptr(), -1, 0,
                    c[2] if len(c) > 2 else None) for c in carry]
        entries += [(r[0], r[0] if r[0] is not None else
                     _pack_row(r[3] if len(r) > 3 else None, carry),
                     0, r[1], r[2], r[3] if len(r) > 3 else None)
                    for r in rows]
        for src, leaf, dst, slot, row, sub in entries:
            if slot < 0 and src is not None and src.nbytes != leaf.nbytes:
                raise ValueError("a carried leaf changes its size")
            keep += [t for t in (src, leaf, sub)
                     if t is not None and not t.is_meta]
            m = [0, 0, 0, MERGE_NONE]
            hold = slot < 0 and src is not None and \
                any(leaf is h for h in held)
            nbytes = leaf.nbytes if src is None else src.nbytes
            span = -(-nbytes // COMMIT_CHUNK)
            if sub is not None:
                if slots is None:
                    raise ValueError("sub rows need the table's slots")
                if n and n != leaf.shape[0]:
                    raise ValueError("merged leaves of two batch sizes")
                n = leaf.shape[0]
                m = _merge(leaf, sub, slots,
                           MERGED if src is not None else MERGE_ROWS)
                if src is None:
                    nbytes = sub.nbytes
                    span = sub.shape[0] * -(-m[1] // COMMIT_CHUNK)
            elif src is None:
                raise ValueError("an entry without a source needs sub rows")
            if hold:
                m[1], m[3] = _row_bytes(leaf), m[3] | MERGE_HOLD
            if nbytes:
                ref = src if src is not None else sub
                segs.append([0 if src is None else src.data_ptr(), dst,
                             nbytes, slot, row, chunk,
                             0 if src is None else _pitch(src),
                             ref.element_size()])
                merges.append(m)
                chunk += span
        heads.append([first, len(segs) - first, chunk, 0])
        maps.append([slots.idx.data_ptr(), slots.keep.data_ptr(),
                     slots.idx.numel(), n] if slots is not None
                    else [0, 0, 0, 0])
        if slots is not None:
            keep += [slots.idx, slots.keep]
    merged = any(m[3] != MERGE_NONE for m in merges)
    return CommitTables(
        torch.tensor(heads, dtype=torch.int64, device=device),
        torch.tensor(segs or [[0] * 8], dtype=torch.int64, device=device),
        max(h[2] for h in heads), tuple(keep),
        torch.tensor(merges, dtype=torch.int64, device=device)
        if merged else None,
        torch.tensor(maps, dtype=torch.int64, device=device)
        if merged else None)


def commit_ctas(chunks, sms):
    """scan_commit's grid for tables of at most ``chunks`` chunks on a card
    of ``sms`` SMs: a CTA a COMMIT_THREADS chunks, at most one wave."""
    return max(1, min(-(-chunks // COMMIT_THREADS), COMMIT_CTAS_PER_SM * sms))


def commit_chunks(ct, t):
    """The chunks of table t of ``ct`` as the kernel takes them: (entry,
    byte offset, bytes) for chunk 0, 1, ... of the table, in order (a
    thread's first chunk found by bisection over the entries' first
    chunks, the next by walking on).  A rows entry's offset is into its
    sub rows (row j's bytes at j times the row bytes), each row's chunks
    starting a row."""
    first, count, chunks, _ = ct.tables[t].tolist()
    starts = ct.segs[first:first + count, 5].tolist()
    nbytes = ct.segs[first:first + count, 2].tolist()
    kinds = ([MERGE_NONE] * count if ct.merges is None else
             ct.merges[first:first + count].tolist())
    out, e = [], 0
    for c in range(chunks):
        while e + 1 < count and starts[e + 1] <= c:
            e += 1
        local = c - starts[e]
        if ct.merges is not None and kinds[e][3] & ~MERGE_HOLD == \
                MERGE_ROWS:
            rb = kinds[e][1]
            cpr = -(-rb // COMMIT_CHUNK)
            j, o = divmod(local, cpr)
            o *= COMMIT_CHUNK
            out.append((first + e, j * rb + o, min(COMMIT_CHUNK, rb - o)))
            continue
        off = local * COMMIT_CHUNK
        out.append((first + e, off, min(COMMIT_CHUNK, nbytes[e] - off)))
    return out


def scan_commit(params, ct, table=0, hold=None, chunk=0, ctas=None):
    """The copies of table ``table`` of ``ct`` (``segments``) for the tick
    params[P_K] - 1 (TABLE_TICK: params[P_BRANCH]'s, the tick body's;
    TABLE_PICK: the program's pick, params[P_BRANCH]'s when params[P_ESEL]
    is 0, else none (an escape body's tick, which its IF graph commits));
    one run into ``params[P_COMMITS]`` (a run that picks none counts
    none).  hold: None, or a (bodies,) i64 tensor of each tick body's
    escaped flags' address: the entries flagged MERGE_HOLD leave the rows
    of the streams flagged in params[P_BRANCH]'s.  chunk: CHUNK_NEXT
    advances ``params[P_CHUNK]`` and counts a run in
    ``params[P_CHUNK_RUNS]``, TAIL_NEXT ``params[P_TAIL]`` and
    ``params[P_TAIL_RUNS]`` (the many body's chunk loops; no handle is set
    here).  ctas: the grid (``commit_ctas`` of the tables' chunks by
    default).  CUDA only: the tables hold device addresses."""
    if not on_cuda(params, ct.tables, ct.segs,
                   *(() if hold is None else (hold,))):
        raise ValueError("scan_commit reads device addresses: CUDA tensors "
                         "only (its twin is scan_commit_plain)")
    if not TABLE_TICK <= table < ct.tables.shape[0]:
        raise ValueError(f"no table {table} of {ct.tables.shape[0]}")
    if ctas is None:
        from .launch import sm_count
        ctas = commit_ctas(ct.chunks, sm_count(params.device))
    with torch.cuda.device(params.device):
        launch("scan_commit", "scan_commit_launch", params.data_ptr(),
               ct.tables.data_ptr(), ct.segs.data_ptr(),
               0 if ct.merges is None else ct.merges.data_ptr(),
               0 if ct.maps is None else ct.maps.data_ptr(),
               0 if hold is None else hold.data_ptr(), table, int(chunk),
               ctas)


def _error(lib, rc, names):
    """A readable sched_program_* error."""
    if rc == -1:
        v = ctypes.c_int(0)
        lib.fn("sched_driver_version")(ctypes.addressof(v))
        return (f"the CUDA driver ({v.value}) is older than {MIN_DRIVER}: "
                f"conditional graph nodes need CUDA 12.4")
    if rc <= -1000:
        body, kind = divmod(-rc - 1000, 100)
        return (f"the tick body {names[body]!r} holds a "
                f"{NODE_TYPES.get(kind, kind)} node, which a conditional "
                f"node's body cannot hold")
    buf = ctypes.create_string_buffer(256)
    lib.fn("sched_error_string")(rc, ctypes.addressof(buf), 256)
    return f"cudaError {rc} ({buf.value.decode()})"


class Graph:
    """The serving program's CUDA graph (csrc/schedule.cu
    sched_program_build): a WHILE node over one tick (tick_select -> an IF
    node a body -> escape_select -> IF few, IF many -> scan_commit), each
    tick body's and the few body's IF node a child graph node of a
    PyTorch-captured body (``torch.cuda.CUDAGraph(keep_graph=True)``'s
    ``raw_cuda_graph()``), the few body's followed by the tick body's
    commit and its own; the many body's IF node the tick body's commit
    with the escaped streams' state rows held, then a WHILE node over its
    big chunks and one over its small ones (a chunk body's child graph
    node, then the chunk's commit).  No node copies a frame: every body
    reads tick k's frames in place.  ``bodies``: {name: raw graph} in
    branch order; ``few`` / ``many``: raw graphs or 0 (many: the big
    chunk's body); ``args``: the device addresses and sizes of BUILD_ARGS
    (``tables``/``segs``: the commit's ``CommitTables``, a table a tick
    body, then few and the many body's chunk, then its small chunk;
    ``esc_at``: a tick body's escaped flags' address each, on the device,
    or 0 without a band; ``elist``, ``chunk_rows``, ``list_len``,
    ``tail_rows``: escape_select's list for the many body, its big and
    small chunks; ``tail``: the small chunk's raw graph).  Building raises
    on a body node type a conditional body cannot hold, on CUDA older than
    12.4 and on any CUDA error; so does ``launch``."""

    def __init__(self, bodies, few, many, **args):
        from .build import load_library
        self._lib = load_library()
        args.update(few=few, many=many)
        words = (ctypes.c_longlong * len(BUILD_ARGS))(
            *[int(args[k]) for k in BUILD_ARGS])
        graphs = (ctypes.c_ulonglong * len(bodies))(*bodies.values())
        out = ctypes.c_void_p(0)
        rc = self._lib.fn("sched_program_build")(
            ctypes.addressof(words), len(BUILD_ARGS),
            ctypes.addressof(graphs), len(bodies), ctypes.addressof(out))
        if rc:
            raise RuntimeError("the serving program's graph did not build: "
                               + _error(self._lib, rc,
                                        list(bodies) + ["few", "many",
                                                        "tail"]))
        self._ptr = out.value

    def launch(self):
        """One launch on the current stream."""
        rc = self._lib.fn("sched_program_launch")(
            self._ptr, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError("the serving program's launch failed: "
                               + _error(self._lib, rc, []))

    def __del__(self):
        ptr, self._ptr = getattr(self, "_ptr", None), None
        if ptr:
            self._lib.fn("sched_program_destroy")(ptr)

