"""Batched multi-stream serving: N cameras on one GPU, or on a mesh of them.

The reference runs one Tracker per camera in one JS thread.  Here per-stream
state is a ``TrackerState`` of (N, ...) tensors.  Two schedulers, as in the
reference package (headtrackr_tpu/runtime/serving.py):

Host scheduler (``step``), from a host view of the mode vector that is
refreshed every ``sync_interval`` ticks (so up to that many ticks stale):
  every stream CS                  -> "track" (non-CS streams freeze);
  1 .. bucket streams non-CS       -> "track", then the full WB/VJ/CS
                                      machinery for those of them still
                                      non-CS after it;
  more                             -> the "full" step on the whole batch.
A stream that loses track between syncs is served at the next sync.

Device scheduler (``step_auto``, ``run_scan``), from the exact mode vector,
with the branch rule of the reference's ``auto_step``, kb = min(bucket, N)
and chunk_cap = max(kb, (min(N, 4 kb) // kb) kb):
  no stream pending (all CS)       -> "track";
  pending, none in VJ              -> "wbtrack" (whitebalance + camshift);
  1 .. chunk_cap pending           -> "track", then the full machinery for
                                      the pending streams (the reference's
                                      bucket and chunk ticks);
  more pending                     -> overload="full": the "full" step on
                                      the whole batch, whose trackers take
                                      FULL-FRAME camshift; overload="rotate":
                                      as above for the chunk_cap oldest
                                      pending streams (by ``pend_age``, ties
                                      to the lower index), while the others
                                      stay frozen and age by one tick.
Every branch but the rotation's leaves ``pend_age`` at 0.

On the card the device scheduler runs as the reference's does: one program
(``_Program``) for one tick or K, launched once, with one host read at the
end (the last tick's mode_after).  Each tick's branch, its served streams
and their pend_age are chosen on the card (kernels/schedule.py
tick_select, which sets the CUDA graph conditional handle of one IF node
a branch), and so is the band's escape fallback (escape_select: none, a
sub-batch of ``escape_bucket`` slots, or every escaped stream in chunks
of ``escape_chunk``, a WHILE node nested in the fallback's IF node); a
WHILE node runs the K ticks of ``run_scan`` (scan_commit).  The ticks'
frames stay where the caller staged them: tick_select writes where tick
k's lie, and every frame reader of every body reads them there
(histpdf_band, hist_mma, hist4096, backproject, frame_prep, handoff and
the escape bodies' slot_gather), so no body copies a frame
(``_Steps.copy_mode``).  Its select kernels are a grid of CTAs each,
whose last CTA merges the others' counts and candidates, so the program
serves any batch whose frames fit the card.  Each body keeps its own
results, and scan_commit copies those of the body that ran (a leaf it
passed through, none).
What bounds N on one card is its memory alone (one tick's frames, a
scan's staged ticks, the state and the results each body keeps: 10,240
streams of 320x240 stage 9.4 GB a scan of 4 ticks):
the wrappers of the kernels that put the stream on the grid's y axis
(65,535 a launch) split a larger batch into launches of at most that
many (kernels/histbins.py row_chunks).  Nothing clips N.  The branches'
bodies
are CUDA graphs captured from the steps: "track"; the bucket and chunk
ticks and the rotation (``_Steps.bucket_device``: "track", then the
"pending" step on the served slots padded with N, a masked scatter);
"wbtrack" and "full" in their select form (every mode's branch on every
stream, each taking its entry mode's result).  The detector in them is
three kernels with no host read (models/detector.py).

With a band (``band="auto"``: DEFAULT_BAND when it is smaller than the
frame) "track" and "wbtrack" take the band-local camshift.  Streams whose
window left the band are recomputed from the pre-step state by the
full-frame "track" step and merged back: up to ``escape_bucket`` of them
as a sub-batch, more as sub-batches of ``escape_chunk`` (where the
reference recomputes the whole batch and selects the escaped streams); a
stream's result does not depend on its batch, so it is the same either
way.

The per-tick path (``_Steps.begin`` / ``end``) is the program's plain
version, which the CPU runs: the branch chosen on the host from the mode
view, the served streams from a host ``np.nonzero``, every branch and the
escape recompute eager.

``make_batched_steps`` is the same tick in the reference's functional form:
five functions of (state, frames) that hold no stream state.  It and
``BatchedTracker`` run one implementation of the tick (``_Steps``); the
tracker adds the state and its host mode view.

With a mesh (``parallel.stream_mesh``) the streams split into equal shards,
one a mesh entry, each a tracker of its own on its entry's device: the
device scheduler runs on every shard's own slice (its own branch, bucket,
chunk cap and ``pend_age`` order, no cross-shard read), as the reference's
shard_map does; the host scheduler keeps the reference's global rule.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..cascade import frontalface
from ..config import TrackerConfig
from ..device import resolve_device
from ..kernels import launch, schedule
from ..models import camshift as cs_mod
from ..models import facetracker as ft
from ..models.detector import detector_tables
from ..ops.histogram import (backprojection_weights, histogram_full,
                             histogram_rects)
from ..parallel.mesh import gather_streams, shard_streams, split_streams

__all__ = ["BatchedTracker", "make_batched_steps", "plan_serving",
           "resolve_band", "wants_band_audit"]


def resolve_band(band, frame_shape):
    """Normalize a band knob: "auto" -> DEFAULT_BAND; a band covering the
    whole frame -> None (identical math on the full-frame path)."""
    if band == "auto":
        band = cs_mod.DEFAULT_BAND
    if band is not None and (band[0] >= frame_shape[0]
                             and band[1] >= frame_shape[1]):
        band = None
    return band


def wants_band_audit(config, band):
    """True iff steps built from this (config, resolved band) carry the
    bandHist handoff-audit flag: states fed to them must come from
    ``ft.init_state(..., band_audit=wants_band_audit(config, band))``."""
    return band is not None and config.bandHist and config.bandHistAudit


def plan_serving(n_streams, frame_shape=(240, 320), max_face_px=100,
                 simultaneous_losses=None, latency_sensitive=False,
                 model_bins=None):
    """Capacity planner: ``BatchedTracker`` kwargs (and a ``run_scan``
    length) sized to a deployment's workload, by the reference package's
    rules (headtrackr_tpu/runtime/serving.py ``plan_serving``), so that it
    returns the reference's dict on every input.

    Rules:

    - ``band``: camshift search windows run ~1.3x the tracked face, and an
      escape-free band needs BAND_SLACK px more per dimension
      (models/camshift.py ``band_for``).  Undersized is safe: escaped
      streams are recomputed over the full frame (correct, slower).
    - ``bucket``: 2x the expected simultaneous losses (default: 2% of the
      streams), at least 1 and at most the streams.  A redetect tick's
      detector cost grows with the bucket; more pending streams than it
      (up to 4x) are served in chunks.
    - ``overload``: "rotate" for latency-sensitive serving (a bounded tick
      under mass loss, oldest pending streams first), else "full" (every
      stream relocks in one slow tick).
    - ``scan_len``: 1 for latency-sensitive callers (drive ``step_auto``
      tick by tick), else 16.  On the card ``run_scan`` is one launch and
      one host read for its K ticks.
    - ``sparse_hist``: 64 when 1.3x ``model_bins`` (the distinct bins of
      the deployment's face models) fits in 64, else None.  It maps to the
      ``sparseHist`` config field, which this port accepts and ignores:
      its histograms are dense and give the same values.
    - ``bandHist``: True (band-local current histograms, PARITY deviation
      13), with the handoff audit flagging streams whose model carries
      bins outside the band (``TrackerConfig.bandHistAudit``).

    The bucket and scan rules have not been re-derived on the GPU yet; that
    waits for the port's own bench.

    Returns a dict: band / bucket / overload / bandHist are
    ``BatchedTracker`` kwargs, sparse_hist is its ``sparseHist``; scan_len
    is for ``warmup(scan_len=...)`` / ``run_scan``.

    >>> p = plan_serving(256, max_face_px=40)
    >>> bt = BatchedTracker(256, band=p["band"], bucket=p["bucket"],
    ...                     overload=p["overload"], bandHist=p["bandHist"],
    ...                     sparseHist=p["sparse_hist"])
    """
    win = int(np.ceil(1.3 * max_face_px))
    band = cs_mod.band_for((win, win), frame_shape)
    if simultaneous_losses is None:
        simultaneous_losses = max(1, round(0.02 * n_streams))
    bucket = max(1, min(2 * int(simultaneous_losses), n_streams))
    sparse = None
    if model_bins is not None:
        sparse = 64 if 1.3 * int(model_bins) <= 64 else None
    return {
        "band": band,
        "bucket": bucket,
        "overload": "rotate" if latency_sensitive else "full",
        "scan_len": 1 if latency_sensitive else 16,
        "sparse_hist": sparse,
        "bandHist": True,
    }


# the many escape body's chunks of escaped streams: big and small ones
# (``_Steps.chunk_rows`` rounds the small to a multiple of escape_bucket,
# the big to one of the small)
ESCAPE_CHUNK, ESCAPE_TAIL = 256, 32


def _leaves(tree):
    """The tensors of a NamedTuple tree in field order (None leaves
    skipped)."""
    if isinstance(tree, tuple):
        return [t for v in tree for t in _leaves(v)]
    return [] if tree is None else [tree]


def _clone(tree):
    if isinstance(tree, tuple):
        return type(tree)(*(_clone(v) for v in tree))
    return None if tree is None else tree.clone()


def _merged_config(n_streams, params, kw):
    """TrackerConfig fields: ``params`` updated by ``kw``, with the
    reference package's batched capacity defaults, carried so the two
    configurations compare equal (this detector has none of these caps:
    it keeps a fixed 256 candidate slots a stream)."""
    merged = dict(params or {})
    merged.update(kw)
    if n_streams >= 32:
        merged.setdefault("survivorsStage2", 4096)
        merged.setdefault("survivorsDeep", 128)
        merged.setdefault("maxCandidates", 64)
    return merged


class _Merge(NamedTuple):
    """A body's sub-batch, whose rows scan_commit merges: a bucket body's
    into its track pass's results (``_Program._commit_pairs``), an escape
    body's (the few body's, a chunk of the many body's) over the tick
    body's committed results (``_Program._few_pairs``).  The slots ``idx``
    (S,) i64 padded with N, ``keep`` (S,) bool (slot_gather's: not padding
    and, for a bucket, not in CS after the track pass), the rows ``sub``
    it gathered (from the track pass's state; an escape body's from the
    pre-step state), and its step's ``state`` and ``out`` on them.  A leaf
    of ``state`` that is ``sub``'s own tensor the step passed through: its
    rows need no write."""
    idx: torch.Tensor
    keep: torch.Tensor
    sub: ft.TrackerState
    state: ft.TrackerState
    out: ft.StepOutput


def _host(modes):
    """A mode vector (device tensor or host array) as a host array."""
    return modes.cpu().numpy() if torch.is_tensor(modes) else np.array(modes)


class _Buffers:
    """A batch size's static tick buffers, which its tick bodies share.
    In: ``frames``; ``state_in``, the state every body reads (the tracker's
    state after a launch of the program, whose scan_commit writes it);
    ``idx``, the bucket's served slots (chunk_cap of them,
    padded with N; the bucket body over s slots reads the first s);
    ``eidx``, the few escape body's slots (escape_bucket of them);
    ``elist``, the many escape body's list (every escaped stream, padded
    with N to whole big chunks of ``m`` slots); ``chunk`` the word holding
    the big chunk that runs and ``cidx`` its ``m`` slots (its slot_gather
    writes them), ``tail`` and ``tidx`` the same for the small chunks of
    ``ms`` slots;
    ``age``, pend_age after the tick (the program's tick_select writes
    it).  No body writes any other of them: each keeps its own results
    (``_TickGraph``), which the program commits.  The output packs' layout
    (``lay_out``): rows of one packed (fields, N) tensor a dtype.  All of
    a batch size's bodies capture into one memory pool (``pool``), in
    which the results each keeps stay allocated for the graph's lifetime,
    so that no later capture reuses them.  On the card ``params`` is the
    serving program's parameter block (``chunk`` and ``tail`` its words
    P_CHUNK and P_TAIL), whose word ``frame_at`` holds where the tick's
    frames lie (tick_select writes it): every frame reader of every body
    reads them there (``frames``)."""

    def __init__(self, state, frames_shape, device, cap, escape_bucket, m,
                 ms):
        n = frames_shape[0]
        self.device = device
        self.frames_shape = tuple(frames_shape)
        self._frames = None
        self.state_in = _clone(state)
        self.idx = torch.full((cap,), n, dtype=torch.int64, device=device)
        self.eidx = torch.full((escape_bucket,), n, dtype=torch.int64,
                               device=device)
        self.m, self.ms = m, ms
        self.elist = torch.full((-(-n // m) * m,), n, dtype=torch.int64,
                                device=device)
        self.cidx = torch.full((m,), n, dtype=torch.int64, device=device)
        self.tidx = torch.full((ms,), n, dtype=torch.int64, device=device)
        self.age = torch.zeros((n,), dtype=torch.int32, device=device)
        self.rows = None
        self.pool = self.params = self.frame_at = None
        self.chunk = torch.zeros((1,), dtype=torch.int64, device=device)
        self.tail = torch.zeros((1,), dtype=torch.int64, device=device)
        if device.type == "cuda":
            with torch.cuda.device(device):
                self.pool = torch.cuda.graph_pool_handle()
                self.params = torch.zeros((schedule.PARAM_WORDS,),
                                          dtype=torch.int64, device=device)
            self.frame_at = self.params[schedule.P_FRAME_AT:
                                        schedule.P_FRAME_AT + 1]
            self.chunk = self.params[schedule.P_CHUNK:schedule.P_CHUNK + 1]
            self.tail = self.params[schedule.P_TAIL:schedule.P_TAIL + 1]

    @property
    def frames(self):
        """The (N, H, W, 3) u8 frames the bodies take, which none of their
        kernels reads: under ``launch.frames_at`` each reads the tick's
        frames where they lie instead (on the card at ``frame_at``, on the
        CPU tick k's, which the twins read).  Only a body's warm-up before
        its capture reads these (zeros).  On the card they are held while
        bodies are captured and freed after (``release``): a captured
        launch keeps their address, which it never dereferences.  On the
        CPU they stay, the tensor the twins' redirect names."""
        if self._frames is None:
            self._frames = torch.zeros(self.frames_shape, dtype=torch.uint8,
                                       device=self.device)
        return self._frames

    def release(self):
        """Free the card's ``frames`` once the bodies are captured (a later
        capture allocates them again)."""
        if self.device.type == "cuda":
            self._frames = None

    def lay_out(self, out):
        """The output packs' layout from a body's outputs, once: ``rows``,
        each leaf's (dtype, row) in a (fields, N) pack a dtype, and
        ``packs``, each dtype's (fields, N) shape."""
        if self.rows is None:
            groups = {}
            self.rows = []
            for v in out:
                self.rows.append((v.dtype, len(groups.setdefault(v.dtype,
                                                                 []))))
                groups[v.dtype].append(v)
            self.packs = {dt: (len(g),) + tuple(g[0].shape)
                          for dt, g in groups.items()}


class _TickGraph:
    """A tick body of the serving program, ``tick(state, frames, *extra)
    -> (state', StepOutput[, _Merge])``, or a ``_Merge`` alone (an escape
    body: its sub-batch, no results of the whole batch), on a batch
    size's ``_Buffers`` (from their ``state_in``; its frames read where
    the tick's lie).  It writes no shared buffer.  On the card it is
    captured in a CUDA graph (keep_graph, for the program's conditional
    nodes; in the buffers' pool; a capture failure raises; ``launches``
    tallies the kernel launches one run makes), and ``state`` and ``out``
    (and ``merge``) keep the tensors its capture returned, as
    ``torch.cuda.make_graphed_callables`` keeps its static outputs: each
    replay's results, at addresses fixed for the graph's lifetime, which
    the program commits (a leaf the body passes through is ``state_in``'s
    own tensor).  On the CPU ``run`` calls the tick and returns its
    results.

    The body reads its frames in place: it is captured, and run on the
    CPU, under ``launch.frames_at`` (on the card the buffers' ``frame_at``
    word, on the CPU tick k's frames), so every frame reader in it reads
    the tick's frames where they lie and none reads the buffers'
    ``frames``."""

    def __init__(self, tick, bufs, extra):
        self.bufs, self.extra = bufs, extra
        self.device = bufs.device
        self.graph = self.state = self.out = self.merge = None
        self.launches = dict.fromkeys(launch.launches, 0)
        self.tick = tick  # called at each run on the CPU
        if self.device.type != "cuda":
            return
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):  # warm up off the capture stream
                self.run()
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)
            with launch.capturing() as self.launches, \
                    torch.cuda.graph(self.graph, pool=bufs.pool):
                res = self.run(bufs.frame_at)
            if isinstance(res, _Merge):
                self.merge = res
            else:
                self.state, self.out = res[:2]
                self.merge = res[2] if len(res) > 2 else None
        # not kept on the card: a graph holding its _Steps' bound method
        # makes a reference cycle, which the cyclic collector may free while
        # another graph captures, destroying CUDA objects mid-capture
        del self.tick

    def run(self, source=None):
        """Run the body once (its warm-up, which reads the buffers' frames,
        and its capture on the card; the program's twin on the CPU) and
        return its results; ``source``: where the tick's frames lie
        (``launch.frames_at``)."""
        frames = self.bufs.frames
        with launch.frames_at(frames, source):
            return self.tick(self.bufs.state_in, frames, *self.extra)


class _Program:
    """The device-scheduled tick at a batch size, K ticks a launch: the
    reference's ``auto_step`` with its ``_escape_checked`` fallback, in
    ``scan_steps``' loop.  Each tick, as kernels/schedule.py's kernels
    choose: the branch, the served slots, the new pend_age and where the
    tick's frames lie (tick_select) and the branch's body; with a band,
    the escape fallback's body (escape_select, on the tick body's own
    escaped flags): none, ``few`` (the full-frame "track" step from the
    pre-step state on escape_bucket slots) or ``many`` (the same step on
    every escaped stream, in chunks).  scan_commit then writes the
    tick body's results (``_commit_pairs`` of the results it keeps): its
    outputs into row k of the scan's output packs and its new state,
    pend_age from tick_select, over ``state_in``.  The few body gathers
    its slots' rows from ``state_in`` before anything commits, and keeps
    its sub-batch alone: on its tick scan_commit writes the tick body's
    table, then the few body's (``_few_pairs``: the kept rows of each leaf
    its step changed and of its outputs).  On a many tick scan_commit
    writes the tick body's table with the escaped streams' rows of every
    state leaf but pend_age held (``held``), so that they stay the
    pre-step state's; then a loop over the big chunks of escape_select's
    list and one over the small (``schedule.chunk_plan``: whole big
    chunks, one more where the rest exceeds two small ones): a chunk body
    (``many``: ``m`` slots, ``tail``: ``ms``) gathers its chunk's slots'
    rows from ``state_in`` and the tick's frames, runs the step on them,
    and scan_commit writes its kept rows alone (``_few_pairs`` again).
    No tick stages a leaf or copies one whole for an escape.  ``escaped``
    is the tick body's flags, stamped after the merge.  No body copies a
    frame: each reads the tick's frames where they lie.

    Each body keeps one state and one output set of its own, so a batch
    size holds one a body on top of the shared buffers (the leaves it
    passes through excepted): at 256 streams of 320x240, 4.26 MB a body
    that changes the 16 KB model histograms of every stream (the full
    body) and 0.04-0.06 MB one that passes them through (the all-CS and
    wbtrack bodies); a bucket body keeps its track pass's results and its
    sub-batch's rows (0.18 MB at 8 slots), an escape body its sub-batch
    alone (its slots' rows of the state and of the frames and its step's
    planes: 2 MB at 8 slots of 320x240, the many body's chunks of 256
    and 32 slots ~110 MB, whatever the batch); 170 MB and 1.8-2.4 MB at
    10,240 streams; ~1.2 GB and ~12 MB at 70,000.

    On the card it is one CUDA graph (``schedule.Graph``: a WHILE node, an
    IF node a body, the many body's chunks a WHILE node in its IF node),
    launched once for the K ticks, with one host read at the end: the last
    tick's mode_after and the parameter block, in which each of the
    program's kernels counts its own runs (``runs``: tick_select's by the
    body it chose, escape_select's at 8 + its selection; ``chunks``: the
    many body's chunks, big and small).  The launch counters take those
    counts, and a launch whose kernels ran other than K ticks raises.  On the CPU the
    same bodies run uncaptured, each picked by the select kernels' twins
    in a Python ``if``, and their results go to scan_commit's twin as they
    are.  The select kernels' scratch buffers (``schedule.scratch``) are
    allocated here, once a batch size."""

    def __init__(self, steps, state):
        n = state.mode.shape[0]
        self.device = steps.device
        self.bufs = bufs = steps.buffers(state)
        # the many body's chunks run by the last launch, and the big ones
        # among them
        self.chunks = self.big_chunks = 0
        self.kb, self.cap = min(steps.bucket, n), steps.chunk_cap(n)
        self.rotate = steps.overload == "rotate"
        self.eb = steps.escape_bucket
        keys = steps.body_keys(n)
        self.bodies = [steps.captured(state, k) for k in keys]
        band = steps.band is not None
        # the outputs' layout from a body's outputs (on the CPU a warm-up
        # run's)
        bufs.lay_out(self.bodies[0].out if self.bodies[0].out is not None
                     else self.bodies[0].run()[1])
        self.few = (steps.captured(state, "few")
                    if band and self.eb < n else None)
        self.many = steps.captured(state, "many") if band else None
        self.tail = steps.captured(state, "tail") if band else None
        self._age_leaf = next(i for i, v in enumerate(_leaves(bufs.state_in))
                              if v is bufs.state_in.pend_age)
        # the state leaves whose escaped rows a many tick's commit holds
        self.held = tuple(v for i, v in enumerate(_leaves(bufs.state_in))
                          if i != self._age_leaf)
        self.dtypes = list(bufs.packs)
        self.layout = [(self.dtypes.index(dt), i) for dt, i in bufs.rows]
        self._mode_row = self.layout[ft.StepOutput._fields.index(
            "mode_after")]
        self.graph = None
        self.launches = 0  # launches made (a K-tick scan is one)
        if self.device.type != "cuda":
            return
        self._params = bufs.params
        sms = launch.sm_count(self.device)
        with torch.cuda.device(self.device):
            # a table a body: the tick bodies, then few and the many body's
            # big and small chunks
            self._commit = schedule.segments(
                [self._commit_pairs(b.state, b.out, b.merge)
                 for b in self.bodies]
                + [self._few_pairs(b.merge) if b else ([], [])
                   for b in (self.few, self.many, self.tail)], self.device,
                self.held)
            esc_at = None
            if band:
                esc_at = torch.tensor([b.out.escaped.data_ptr()
                                       for b in self.bodies],
                                      dtype=torch.int64, device=self.device)
            self._esc_at = esc_at
            self._scratch = [torch.zeros(schedule.scratch_bytes(n, c),
                                         dtype=torch.uint8,
                                         device=self.device)
                             for c in (self.cap, self.eb)]
            self.graph = schedule.Graph(
                {str(k): b.graph.raw_cuda_graph()
                 for k, b in zip(keys, self.bodies)},
                self.few.graph.raw_cuda_graph() if self.few else 0,
                self.many.graph.raw_cuda_graph() if self.many else 0,
                mode=bufs.state_in.mode.data_ptr(),
                age=bufs.state_in.pend_age.data_ptr(),
                idx=bufs.idx.data_ptr(), age_out=bufs.age.data_ptr(),
                params=self._params.data_ptr(), n=n, kb=self.kb,
                cap=self.cap, rotate=int(self.rotate),
                esc_at=esc_at.data_ptr() if band else 0,
                eidx=bufs.eidx.data_ptr(), eb=self.eb,
                frame_bytes=int(np.prod(bufs.frames_shape)),
                tables=self._commit.tables.data_ptr(),
                segs=self._commit.segs.data_ptr(),
                commit_ctas=schedule.commit_ctas(self._commit.chunks, sms),
                merges=_addr(self._commit.merges),
                maps=_addr(self._commit.maps),
                elist=bufs.elist.data_ptr(), chunk_rows=bufs.m,
                list_len=bufs.elist.numel(),
                tail=self.tail.graph.raw_cuda_graph() if band else 0,
                tail_rows=bufs.ms,
                sel_scratch=self._scratch[0].data_ptr(),
                sel_bytes=self._scratch[0].numel(),
                esc_scratch=self._scratch[1].data_ptr(),
                esc_bytes=self._scratch[1].numel())
            self._done = torch.cuda.Event()
        bufs.release()
        # the parameter block's host side, written and read through NumPy
        # views (a torch op a word would cost the launch more host time)
        self._host = torch.zeros((schedule.PARAM_WORDS,), dtype=torch.int64,
                                 pin_memory=True)
        self._back = torch.zeros_like(self._host).pin_memory()
        self._host_np, self._back_np = self._host.numpy(), self._back.numpy()
        self._mode_host = torch.empty((n,), dtype=torch.int32,
                                      pin_memory=True)

    @staticmethod
    def _subs(state, out, merge):
        """The sub rows of each state and output leaf of a body's results:
        the leaves that its sub-batch's step (a bucket body's "pending"
        step, the few body's "track" step) changed (None where it passed
        the gathered rows through) and its outputs; all None without a
        ``merge``."""
        if merge is None:
            return [None] * len(_leaves(state)), [None] * len(out)
        return ([new if new.data_ptr() != was.data_ptr() else None
                 for new, was in zip(_leaves(merge.state),
                                     _leaves(merge.sub))],
                list(merge.out))

    def _commit_pairs(self, state, out, merge=None):
        """scan_commit's copies of one body's results (state, out), as
        (carry, rows): each state leaf over ``state_in``'s, pend_age from
        tick_select's ``age``, none for a leaf that is ``state_in``'s own
        tensor (passed through: nothing to copy); each output leaf as
        (leaf, pack slot, pack row).  A bucket body's ``merge``: each leaf
        its "pending" step changed also takes its sub rows (the entry's
        last element; a leaf the track pass passed through, src None: its
        served rows alone), and the table its slots (a third element,
        ``schedule.Slots``), as the reference's masked scatter: rows kept
        and not padding."""
        bufs = self.bufs
        state_subs, out_subs = self._subs(state, out, merge)
        carry = []
        for i, (src, dst) in enumerate(zip(_leaves(state),
                                           _leaves(bufs.state_in))):
            sub = None if i == self._age_leaf else state_subs[i]
            src = bufs.age if i == self._age_leaf else src
            passed = src.data_ptr() == dst.data_ptr() and \
                src.nbytes == dst.nbytes
            if not passed or sub is not None:
                carry.append((None if passed else src, dst)
                             + (() if sub is None else (sub,)))
        rows = [(v, slot, row) + (() if sv is None else (sv,))
                for v, sv, (slot, row) in zip(out, out_subs, self.layout)]
        if merge is None:
            return carry, rows
        return carry, rows, schedule.Slots(merge.idx, merge.keep)

    def _few_pairs(self, merge):
        """scan_commit's table of an escape body's sub-batch (``merge``:
        the few body's, a chunk of the many body's), written after the
        tick body's table: rows alone (src None), the kept rows
        ``merge.idx`` of each state leaf the "track" step changed and of
        each output, but pend_age (tick_select's) and ``escaped`` (the tick
        body's flags, stamped after the merge), and the table's slots.  A
        leaf the step passed through keeps the tick body's rows after the
        few body (the escaped streams entered in CS, and no tick body that
        can escape a stream changes those leaves' rows of a stream in CS:
        the wbtrack body's whitebalance ring only a WB stream's) and the
        pre-step state's, the step's own, after the many body (``held``)."""
        state_subs, out_subs = self._subs(None, None, merge)
        carry = [(None, dst, sub) for i, (dst, sub) in enumerate(
            zip(_leaves(self.bufs.state_in), state_subs))
            if sub is not None and i != self._age_leaf]
        rows = [(None, slot, row, sv) for name, sv, (slot, row) in zip(
            ft.StepOutput._fields, out_subs, self.layout)
            if name != "escaped"]
        if any(r[3].dtype != self.dtypes[r[1]] for r in rows):
            raise ValueError("an escape body's outputs differ in dtype "
                             "from the output packs")
        return carry, rows, schedule.Slots(merge.idx, merge.keep)

    def launch(self, state, seq, force=0, served=None, squeeze=False):
        """Enqueue len(seq) ticks from ``state`` (copied into ``state_in``
        unless it is it) on ``seq`` (K, N, H, W, 3) u8 on the device.
        force = 1 + slots: one tick of the bucket over that many slots on
        ``served`` (host ints), pend_age kept (``step_bucket``).  Returns
        the tick for ``finish`` (``squeeze``: a single tick's (N,)
        outputs); on the CPU the ticks have run."""
        bufs = self.bufs
        K, n = seq.shape[0], seq.shape[1]
        self.launches += 1
        if state is not bufs.state_in:
            torch._foreach_copy_(_leaves(bufs.state_in), _leaves(state))
        packs = [torch.empty((bufs.packs[dt][0], K, n), dtype=dt,
                             device=self.device) for dt in self.dtypes]
        if force:
            idx = np.full((force - 1,), n, dtype=np.int64)
            idx[:served.size] = served
            host = torch.from_numpy(idx)
            if self.device.type == "cuda":
                host = host.pin_memory()
            bufs.idx[:force - 1].copy_(host, non_blocking=True)
        if self.graph is None:
            self.runs = self._run_plain(seq, force, packs)
            return self, (packs, K, seq, squeeze)
        p = self._host_np
        p[:] = 0
        p[schedule.P_TICKS] = K
        p[schedule.P_FORCE] = force
        p[schedule.P_FRAMES] = seq.data_ptr()
        for j, pack in enumerate(packs):
            p[schedule.P_OUT + j] = pack.data_ptr()
        slot, row = self._mode_row
        with torch.cuda.device(self.device):
            self._params.copy_(self._host, non_blocking=True)
            self.graph.launch()
            self._mode_host.copy_(packs[slot][row, K - 1], non_blocking=True)
            self._back.copy_(self._params, non_blocking=True)
            self._done.record()
        return self, (packs, K, seq, squeeze)

    def _commit_plain(self, k, packs, table, hold=None):
        """scan_commit's twin of one (carry, rows[, slots]) table for tick
        k into ``packs``."""
        carry, rows, *slots = table
        schedule.scan_commit_plain(
            k, carry, [(r[0], packs[r[1]], r[2]) + tuple(r[3:])
                       for r in rows], *(slots or [None]), hold=hold)

    def _run_plain(self, seq, force, packs):
        """The program on the CPU: the kernels' twins, their selections in
        Python ``if``s, the bodies run uncaptured, reading tick k's frames
        in place as on the card, their results committed as they are, in
        the card's order (the few body run before the tick body's commit,
        its rows committed after it; on a many tick the tick body's commit
        with the escaped rows held, then each chunk's gather, step and
        rows).  Returns the runs."""
        bufs = self.bufs
        runs = [0] * schedule.RUN_WORDS
        self.chunks = self.big_chunks = 0
        for k in range(seq.shape[0]):
            branch, idx, age = schedule.tick_select_plain(
                bufs.state_in.mode, bufs.state_in.pend_age, self.kb,
                self.cap, self.rotate, force, bufs.idx)
            bufs.idx.copy_(idx)
            bufs.age.copy_(age)
            state, out, *merge = self.bodies[branch].run(seq[k])
            merge = merge[0] if merge else None
            runs[branch] += 1
            tick = self._commit_pairs(state, out, merge)
            sel = 0
            if self.many is not None:
                sel, eidx = schedule.escape_select_plain(out.escaped,
                                                         self.eb)
                bufs.eidx.copy_(eidx)
                runs[schedule.ESCAPE_RUNS + sel] += 1
            if sel == 1:
                few = self.few.run(seq[k])
                self._commit_plain(k, packs, tick)
                self._commit_plain(k, packs, self._few_pairs(few))
            elif sel == 2:
                elist, (big, tail0, tails) = schedule.escape_list_plain(
                    out.escaped, bufs.ms, bufs.m)
                bufs.elist.copy_(elist)
                self._commit_plain(k, packs, tick,
                                   schedule.Hold(out.escaped, self.held))
                for word, body, chunks in ((bufs.chunk, self.many,
                                            range(big)),
                                           (bufs.tail, self.tail,
                                            range(tail0, tails))):
                    for c in chunks:
                        word[0] = c
                        self._commit_plain(k, packs,
                                           self._few_pairs(body.run(seq[k])))
                self.chunks += big + tails - tail0
                self.big_chunks += big
            else:
                self._commit_plain(k, packs, tick)
        return runs

    def wait(self):
        """Wait for the launch's one host read (nothing on the CPU)."""
        if self.graph is not None:
            self._done.synchronize()

    def finish(self, tick, donate=True):
        """Finish a launch: (state, StepOutput of (K, N) leaves, or (N,)
        when squeezed, host mode view: the last tick's mode_after).
        donate: as ``_Steps.end``'s."""
        packs, K, _, squeeze = tick
        self.wait()
        if self.graph is not None:
            back = self._back_np
            self.runs = back[schedule.P_RUNS:schedule.P_RUNS
                             + schedule.RUN_WORDS].tolist()
            big, small = (int(back[schedule.P_CHUNK_RUNS]),
                          int(back[schedule.P_TAIL_RUNS]))
            self.chunks, self.big_chunks = big + small, big
            ticks = sum(self.runs[:schedule.ESCAPE_RUNS])
            if back[schedule.P_K] != K or ticks != K:
                raise RuntimeError(f"the serving program ran "
                                   f"{back[schedule.P_K]} ({ticks} "
                                   f"selected) of {K} ticks")
            ran = [(b, self.runs[i]) for i, b in enumerate(self.bodies)]
            ran += [(self.few, self.runs[schedule.ESCAPE_RUNS + 1]),
                    (self.many, big), (self.tail, small)]
            for body, times in ran:
                for _ in range(times if body is not None else 0):
                    launch.replayed(body.launches)
            # each kernel's own count of its runs, read back with the modes
            launch.launches["tick_select"] += ticks
            launch.launches["escape_select"] += sum(
                self.runs[schedule.ESCAPE_RUNS:])
            launch.launches["scan_commit"] += int(back[schedule.P_COMMITS])
            view = self._mode_host.numpy().copy()
        else:
            view = self.bufs.state_in.mode.numpy().copy()
        rows = [(p[:, 0] if squeeze else p).unbind(0) for p in packs]
        out = ft.StepOutput(*(rows[slot][row] for slot, row in self.layout))
        state = self.bufs.state_in
        return (state if donate else _clone(state)), out, view


def _addr(t):
    """A tensor's device address, 0 for None."""
    return 0 if t is None else t.data_ptr()


def _check_frames(frames, want):
    """Raise unless ``frames`` is a u8 tensor of shape ``want``."""
    if tuple(frames.shape) != tuple(want) or frames.dtype != torch.uint8:
        raise ValueError(f"frames must be {tuple(want)} uint8, got "
                         f"{tuple(frames.shape)} {frames.dtype}")
    return frames


def _staged(frames, want, device):
    """``frames`` (a tensor or an array) as a contiguous u8 tensor of shape
    ``want`` on ``device``; another shape or dtype raises."""
    return _check_frames(torch.as_tensor(frames).to(device), want) \
        .contiguous()


class _Steps:
    """The serving tick on one device, as functions of (state, frames) that
    hold no stream state: the steps of one (cascade, config, frame shape,
    band, bucket, overload, escape bucket), the device scheduler's branch
    rule, the bucket merge and the band's escape fallback.
    ``BatchedTracker`` (which adds the state and its host mode view) and
    ``make_batched_steps`` (the reference's functional form) are both
    built on it.

    Two forms of the device-scheduled tick.  ``scheduled`` (the card's):
    ``_Program``, the ticks chosen on the device.  Else the per-tick path,
    the program's plain version (the CPU's): the branch chosen on the host
    from the mode view and run eagerly, the escape recompute too.  The
    batch size is read from each call's frames, so the bucket and the
    chunk cap follow N, as the reference's batch-polymorphic steps do;
    bodies and programs are built once a batch size."""

    def __init__(self, cascade, config, frame_shape, device, band, bucket,
                 overload, escape_bucket):
        if overload not in ("full", "rotate"):
            raise ValueError(f"overload must be 'full' or 'rotate', got "
                             f"{overload!r}")
        self.device = device
        self.frame_shape = tuple(frame_shape)
        self.band = band
        self.bucket = max(1, int(bucket))
        self.overload = overload
        self.escape_bucket = max(1, int(escape_bucket))
        # the many escape body's big and small chunks (``chunk_rows``)
        self.escape_chunk, self.escape_tail = ESCAPE_CHUNK, ESCAPE_TAIL
        H, W = self.frame_shape
        tables = detector_tables(W, H, cascade, config.detectorInterval,
                                 device)
        audit = band if wants_band_audit(config, band) else None

        def mk(variant, band=None):
            return ft.make_step(cascade, config, self.frame_shape, variant,
                                band=band, audit_band=audit, device=device,
                                tables=tables)

        # the banded steps return the escaped streams, which the full-frame
        # "track" step recomputes
        self.full = mk("full")  # (state, frames, modes=None): on the batch
        self._track_plain = mk("track")
        self._track = mk("track", band) if band else self._track_plain
        self._wbtrack = mk("wbtrack", band)
        self._pending = mk("pending")  # the bucket's full step, no host read
        # the card schedules its ticks on the device; the CPU runs the
        # per-tick path, and the program's twin when a caller (a test)
        # sets this
        self.scheduled = self.device.type == "cuda"
        self._bufs = {}  # batch size -> its _Buffers
        # (batch size, body key: 0 the all-CS tick, s > 0 the bucket over s
        # slots, "wbtrack", "full", "few", "many" and "tail" (the many
        # body's big and small chunks)) -> its _TickGraph
        self._graphs = {}
        self._programs = {}  # batch size -> its _Program

    def chunk_rows(self, n):
        """The many escape body's chunks at batch size n, (big, small):
        ``escape_tail`` rounded down to a multiple of escape_bucket (at
        least one), at most n rounded up to one; ``escape_chunk`` rounded
        down to a multiple of that (at least one), at most n rounded up to
        one."""
        eb = self.escape_bucket
        s = min(max(eb, self.escape_tail // eb * eb), -(-n // eb) * eb)
        return min(max(s, self.escape_chunk // s * s), -(-n // s) * s), s

    def chunk_cap(self, n):
        """The most pending streams one tick serves at batch size n."""
        kb = min(self.bucket, n)
        return max(kb, (min(n, 4 * kb) // kb) * kb)

    def branch(self, modes):
        """The device scheduler's branch for a host mode vector: "track",
        "wbtrack", "bucket" (bucket and chunk ticks, and the rotation) or
        "full"."""
        npend = int((modes != ft.MODE_CS).sum())
        if npend == 0:
            return "track"
        if not (modes == ft.MODE_VJ).any():
            return "wbtrack"
        if npend <= self.chunk_cap(len(modes)) or self.overload == "rotate":
            return "bucket"
        return "full"

    def body_keys(self, n):
        """The program's tick bodies at batch size n in branch order
        (kernels/schedule.py): the all-CS tick, the bucket at each slot
        count kb .. chunk_cap, "wbtrack", and "full" under overload
        "full"."""
        kb = min(self.bucket, n)
        keys = [0] + list(range(kb, self.chunk_cap(n) + 1, kb)) + ["wbtrack"]
        return keys + (["full"] if self.overload == "full" else [])

    @staticmethod
    def copy_mode(key):
        """What the program copies of a tick's frames before the body
        ``key`` (``_graphs``' keys): "none", for every body in every
        configuration.  Every frame reader of the bodies (the camshift
        step's ``histpdf_band``, ``hist_mma`` or ``hist4096`` and
        ``backproject``; ``frame_prep`` and ``handoff`` of the WB and VJ
        branches; the escape bodies' ``slot_gather``) reads the tick's
        frames in place, and ``pyramid`` reads ``frame_prep``'s gray
        plane."""
        return "none"

    def track(self, state, frames):
        """The "track" step with the band's escape recompute."""
        return self._checked(self._track, state, frames)

    def bucket_tick(self, state, frames, idx):
        """"track" on the batch, then the full machinery for the streams
        ``idx`` (host array) still non-CS after it."""
        state1, out = self.track(state, frames)
        return self._apply_bucket(state1, out, frames, idx)

    def bucket_step(self, state, frames, served, donate=True):
        """``bucket_tick`` as the functional ``step_bucket`` runs it, with
        the caller's ``pend_age`` kept: ``scheduled``, one launch of the
        program forced to the bucket over ``served`` (its escape fallback
        on the card) and one host read; else ``bucket_tick``.  donate as
        ``end``'s."""
        if not self.scheduled:
            return self.bucket_tick(state, frames, served)
        kb = min(self.bucket, frames.shape[0])
        prog = self.program(state)
        new, out, _ = prog.finish(prog.launch(
            state, frames[None], 1 + -(-served.size // kb) * kb, served,
            squeeze=True)[1], donate)
        return new, out

    def _recompute(self, state, frames, new, out, esc, esc_host):
        """Recompute a banded step's escaped streams from the pre-step
        ``state`` with the full-frame "track" step; ``esc`` stays the
        output's telemetry."""
        idx = np.nonzero(esc_host)[0]
        if idx.size:
            launch.host_paths["recompute"] += 1
            idx = torch.as_tensor(idx, device=self.device)
            sub_state, sub_out = self._track_plain(
                ft.tree_index(state, idx), frames.index_select(0, idx))
            new = ft.tree_scatter(new, idx, sub_state)
            out = ft.tree_scatter(out, idx, sub_out)
        return new, out._replace(escaped=esc)

    def _checked(self, step, state, frames, modes=None):
        """A "track" or "wbtrack" step with the band's escape fallback (one
        host read of the escaped streams)."""
        if self.band is None:
            return step(state, frames, modes)
        new, out, esc = step(state, frames, modes)
        return self._recompute(state, frames, new, out, esc,
                               esc.cpu().numpy())

    def _apply_bucket(self, state1, out, frames, idx):
        """The full WB/VJ/CS machinery for the streams ``idx`` (host array)
        that are still non-CS after the track pass that gave ``state1``,
        merged into its results (the reference's ``_apply_bucket``).  No
        host read when ``idx`` is empty (the all-CS host tick)."""
        if idx.size == 0:
            return state1, out
        modes1 = state1.mode.cpu().numpy()
        idx = idx[modes1[idx] != ft.MODE_CS]
        if idx.size == 0:
            return state1, out
        t = torch.as_tensor(idx, device=self.device)
        sub_state, sub_out = self.full(ft.tree_index(state1, t),
                                       frames.index_select(0, t), modes1[idx])
        return ft.tree_scatter(state1, t, sub_state), \
            ft.tree_scatter(out, t, sub_out)

    def _banded(self, step, state, frames):
        """A "track" or "wbtrack" step (the select form) before the escape
        fallback: escaped in the output.  No host read.  pend_age passes
        through (the program commits tick_select's)."""
        kw = {} if step is self._track else {"select": True}
        if self.band is None:
            return step(state, frames, **kw)
        new, out, esc = step(state, frames, **kw)
        return new, out._replace(escaped=esc)

    def _auto_track(self, state, frames):
        """The all-CS tick's body: "track" before the escape fallback."""
        return self._banded(self._track, state, frames)

    def _auto_wbtrack(self, state, frames):
        """The wbtrack tick's body: "wbtrack" in its select form before
        the escape fallback."""
        return self._banded(self._wbtrack, state, frames)

    def _auto_full(self, state, frames):
        """The full tick's body: the "full" step in its select form on the
        batch.  No host read."""
        return self.full(state, frames, select=True)

    def bucket_device(self, state, frames, idx):
        """The device scheduler's bucket or chunk tick before the escape
        fallback, with no host read (the graph captures it): "track" on the
        batch, then the reference's ``_apply_bucket`` on the slots ``idx``
        ((slots,) i64 on the device, padded with N): one ``slot_gather``
        launch takes every state leaf's rows min(idx, N - 1) and the kept
        flags (idx < N and not in CS after the track pass), and the
        "pending" step runs on them, reading its frames through the slots.
        Returns (state', out, ``_Merge``): the track pass's results and
        the sub-batch's, which scan_commit merges (rows kept and not
        padding written; no leaf copied whole), so the body itself
        scatters nothing.  A chunk tick's chunks serve disjoint streams and
        a stream's result does not depend on its batch, so one step over
        all its slots equals the reference's chunks in turn.  pend_age
        passes through (the program commits tick_select's).  Where the
        track pass escaped a stream, the escape fallback recomputes it from
        the pre-step state; a served stream enters outside CS, so the track
        pass freezes it and never reports it escaped."""
        state1, out = self._auto_track(state, frames)
        sub, keep = schedule.slot_gather(state1, idx)
        new, new_out = self._pending(sub, frames, slots=idx)
        return state1, out, _Merge(idx, keep, sub, new, new_out)

    def _escape_few(self, state, frames, eidx):
        """The escape fallback's ``few`` body, with no host read: the
        full-frame "track" step from the pre-step ``state`` on the escaped
        streams' slots ``eidx`` ((eb,) i64 on the device, padded with N).
        One ``slot_gather`` launch takes every state leaf's rows and the
        frames' rows min(eidx, N - 1) (the tick's frames read in place) and
        the kept flags under the escape's rule, eidx < N (every escaped
        stream entered in CS, which the bucket's rule would drop).  Returns
        the ``_Merge`` alone: the program commits the tick body's results,
        then the kept rows of what the step changed
        (``_Program._few_pairs``), so the body scatters nothing."""
        sub, keep, rows = schedule.slot_gather(state, eidx, escape=True,
                                               extra=(frames,))
        new, out = self._track_plain(sub, rows)
        return _Merge(eidx, keep, sub, new, out)

    def _escape_many(self, state, frames, elist, at, into):
        """A chunk of the escape fallback's ``many`` body, with no host
        read: the few body's step on the chunk that the word ``at`` names
        of escape_select's list ``elist`` (every escaped stream, padded
        with N), in chunks of len(into) (the buffers' big chunk ``cidx``
        at ``chunk``, or their small one ``tidx`` at ``tail``): one
        ``slot_gather`` launch takes its slots into ``into``, every state
        leaf's rows (the pre-step state's: the tick body's commit held
        them) and the frames' rows (read in place) and the kept flags.
        Returns the ``_Merge`` alone, whose kept rows the program commits
        after the chunk; so the many body computes the escaped streams
        alone."""
        sub, keep, rows = schedule.slot_gather(
            state, elist, escape=True, extra=(frames,), at=at, into=into)
        new, out = self._track_plain(sub, rows)
        return _Merge(into, keep, sub, new, out)

    def buffers(self, state):
        """The ``_Buffers`` of ``state``'s batch size."""
        n = state.mode.shape[0]
        if n not in self._bufs:
            self._bufs[n] = _Buffers(state, (n,) + self.frame_shape + (3,),
                                     self.device, self.chunk_cap(n),
                                     self.escape_bucket,
                                     *self.chunk_rows(n))
        return self._bufs[n]

    def captured(self, state, key=0):
        """The body ``key`` (see ``_graphs``) at ``state``'s batch size,
        built (captured on the card) on first use."""
        n = state.mode.shape[0]
        bufs = self.buffers(state)
        if (n, key) not in self._graphs:
            if key == 0:
                tick, extra = self._auto_track, ()
            elif key == "few":
                tick, extra = self._escape_few, (bufs.eidx,)
            elif key == "many":
                tick, extra = self._escape_many, (bufs.elist, bufs.chunk,
                                                  bufs.cidx)
            elif key == "tail":
                tick, extra = self._escape_many, (bufs.elist, bufs.tail,
                                                  bufs.tidx)
            elif isinstance(key, str):
                tick, extra = {"wbtrack": self._auto_wbtrack,
                               "full": self._auto_full}[key], ()
            else:  # the served streams' slots, padded with N
                tick, extra = self.bucket_device, (bufs.idx[:key],)
            self._graphs[(n, key)] = _TickGraph(tick, bufs, extra)
        return self._graphs[(n, key)]

    def program(self, state):
        """The ``_Program`` at ``state``'s batch size, built on first
        use."""
        n = state.mode.shape[0]
        if n not in self._programs:
            self._programs[n] = _Program(self, state)
        return self._programs[n]

    def begin(self, state, frames, modes=None):
        """Start one device-scheduled tick from ``state``.  ``scheduled``:
        one launch of the program, left in flight.  Else the per-tick path
        from the host mode vector ``modes`` (read from the device when
        None), run to its end.  Returns the tick for ``end``."""
        if self.scheduled:
            return self.program(state).launch(state, frames[None],
                                              squeeze=True)
        if modes is None:
            modes = state.mode.cpu().numpy()
        branch = self.branch(modes)
        n = len(modes)
        launch.host_paths["eager_branch"] += 1
        age = torch.zeros_like(state.pend_age)
        if branch == "track":
            new, out = self.track(state, frames)
        elif branch == "wbtrack":
            new, out = self._checked(self._wbtrack, state, frames, modes)
        elif branch == "full":
            new, out = self.full(state, frames, modes)
        else:
            non_cs = modes != ft.MODE_CS
            served = np.nonzero(non_cs)[0]
            if served.size > self.chunk_cap(n):  # rotate: the oldest
                old = state.pend_age.cpu().numpy()
                key = np.where(non_cs, 1 + old, 0)
                served = np.sort(np.argsort(-key, kind="stable")
                                 [:self.chunk_cap(n)])
                non_cs[served] = False  # now: pending and not served
                age = torch.as_tensor(np.where(non_cs, old + 1, 0)
                                      .astype(np.int32), device=self.device)
            new, out = self.bucket_tick(state, frames, served)
        return None, (new._replace(pend_age=age), out)

    def begin_scan(self, state, seq):
        """Start K = len(seq) device-scheduled ticks in one launch of the
        program (``scheduled`` only); ``end`` finishes them."""
        return self.program(state).launch(state, seq)

    def end(self, tick, donate=True):
        """Finish a tick (or a scan) of ``begin``: (state, StepOutput, mode
        view), the view a host array (the last tick's mode_after) or
        ``out.mode_after``.  A program launch makes its one host read here;
        donate=True returns its state buffers as the state (the next launch
        overwrites them, as the reference's donated state is reused), False
        a copy."""
        g, res = tick
        if g is not None:
            return g.finish(res, donate)
        state, out = res
        return state, out, out.mode_after


def _tick_all(begins, ends):
    """One device-scheduled tick (or scan) on every shard: every shard's
    launch enqueued first (``begins``, thunks), then one wait a device for
    its last launch's sync word (a lone shard's read is that wait), then
    each shard's tick finished (``ends``, applied to its tick).  Returns
    the ends' results in shard order."""
    ticks = [b() for b in begins]
    if len(ticks) > 1:
        for g in {g.device: g for g, _ in ticks if g is not None}.values():
            g.wait()
    return [e(t) for e, t in zip(ends, ticks)]


def _joined_ticks(parts, device):
    """Shards' StepOutputs of (K, N / shards) leaves joined along the
    stream axis on ``device``; one shard's as it is."""
    if len(parts) == 1:
        return parts[0]
    return ft.StepOutput(*(torch.cat([p.to(device) for p in leaves], 1)
                           for leaves in zip(*parts)))


def make_batched_steps(cascade, config, frame_shape, mesh=None, donate=True,
                       bucket=32, band="auto", overload="full",
                       escape_bucket=8, device=None):
    """The serving tick in the reference's functional form: returns
    (step_full, step_track, step_bucket, step_auto, step_scan), each
    ``(state, frames, ...) -> (state', StepOutput)`` on a ``TrackerState``
    of (N, ...) tensors and (N, H, W, 3) u8 frames (a tensor or an array),
    holding no stream state.  ``BatchedTracker`` runs the same tick code.

      step_full(state, frames): the "full" WB/VJ/CS step on the batch.
      step_track(state, frames): the camshift fast path (non-CS streams
        freeze); with a band, escaped streams are recomputed over the full
        frame and ``out.escaped`` marks them.
      step_bucket(state, frames, idx): "track" on the batch, then the full
        machinery for the streams named by ``idx`` ((bucket,) i32, padded
        with N) that are still non-CS after it, ``pend_age`` kept (on the
        card one launch of the serving program forced to its bucket body).
      step_auto(state, frames): one device-scheduled tick (the module
        docstring's branch rule and ``pend_age``, the bucket and chunk cap
        from N = the state's batch).
      step_scan(state, frames_seq): K step_auto ticks over (K, N, H, W, 3)
        frames; the StepOutput's leaves are (K, N).  On the card step_auto
        and step_scan are one launch of the serving program (its K ticks
        scheduled on the card, ``_Program``) and one host read.

    config: a ``TrackerConfig``.  States come from ``ft.init_state(...,
    band_audit=wants_band_audit(config, resolve_band(band, frame_shape)))``.
    donate=True lets a step reuse or overwrite the caller's state tensors
    (the reference donates its state): after an all-CS tick on the card the
    returned state is the CUDA graph's input buffers, which the next such
    tick overwrites.  donate=False leaves the caller's state untouched and
    returns tensors the caller owns.  escape_bucket: with a band, at most
    that many escaped streams are recomputed as a sub-batch (the program's
    ``few`` body); more recompute the batch and take the escaped streams'
    results (``many``), as the reference's; a stream's result is the same
    either way.

    mesh: a ``parallel.stream_mesh``.  State and frames split into its
    equal shards, each stepped on its device by its own copy of the steps
    (step_auto and step_scan schedule each shard from its own slice, as the
    reference's shard_map does: every shard's tick is enqueued before one
    wait a device), and the results are joined in stream order on the first
    shard's device.  A stream's results do not depend on its batch, so they
    equal the meshless steps' bit for bit wherever the shards take the
    meshless branches (a shard's bucket and chunk cap follow its own
    streams, as in the reference).  device: where the steps run
    without a mesh (None: the card; with no card it raises); a mesh names
    its devices, so mesh with device raises."""
    if mesh is not None and device is not None:
        raise ValueError("pass mesh or device, not both: the mesh names its "
                         "shards' devices")
    frame_shape = tuple(frame_shape)
    devices = (list(mesh.devices.flat) if mesh is not None
               else [resolve_device(device)])
    band = resolve_band(band, frame_shape)
    cores = [_Steps(cascade, config, frame_shape, d, band, bucket, overload,
                    escape_bucket) for d in devices]
    k = len(cores)
    own = mesh is not None  # the shards' states are copies, ours to donate

    def split(state, frames, lead=()):
        """Each shard's (state, frames) on its device: without a mesh the
        caller's state itself, on a mesh copies of its slices."""
        want = lead + (state.mode.shape[0],) + frame_shape + (3,)
        if mesh is None:
            return [state], [_staged(frames, want, devices[0])]
        frames = _check_frames(torch.as_tensor(frames), want)
        parts = split_streams(frames, k, len(lead))
        return (shard_streams(state, mesh, mesh.axis_names[0]),
                [_staged(p, p.shape, d) for p, d in zip(parts, devices)])

    def joined(parts):
        """The shards' trees as one, a copy on a mesh (never a graph's
        buffers)."""
        return parts[0] if mesh is None else gather_streams(parts,
                                                            devices[0])

    def run(method, state, frames):
        states, parts = split(state, frames)
        res = [getattr(c, method)(s, f)
               for c, s, f in zip(cores, states, parts)]
        return joined([r[0] for r in res]), joined([r[1] for r in res])

    def auto(states, parts, mine):
        """One tick on every shard; ``mine``: the states are this function's
        own copies (a shard's may be donated whatever ``donate`` says)."""
        res = _tick_all(
            [lambda c=c, s=s, f=f: c.begin(s, f)
             for c, s, f in zip(cores, states, parts)],
            [lambda t, c=c: c.end(t, donate or mine) for c in cores])
        return [r[0] for r in res], [r[1] for r in res]

    def step_full(state, frames):
        return run("full", state, frames)

    def step_track(state, frames):
        return run("track", state, frames)

    def step_bucket(state, frames, idx):
        idx = np.asarray(idx.cpu() if torch.is_tensor(idx) else idx)
        n = state.mode.shape[0]
        idx = idx[(idx >= 0) & (idx < n)].astype(np.int64)
        per = n // k
        states, parts = split(state, frames)
        res = [c.bucket_step(s, f, idx[idx // per == j] % per,
                             donate or own)
               for j, (c, s, f) in enumerate(zip(cores, states, parts))]
        return joined([r[0] for r in res]), joined([r[1] for r in res])

    def step_auto(state, frames):
        states, parts = split(state, frames)
        states, outs = auto(states, parts, own)
        return joined(states), joined(outs)

    def step_scan(state, frames_seq):
        seq = torch.as_tensor(frames_seq)
        if seq.dim() == 0 or seq.shape[0] == 0:
            raise ValueError("step_scan needs at least one tick "
                             "(frames_seq has leading length 0)")
        states, parts = split(state, seq, lead=(seq.shape[0],))
        if cores[0].scheduled:
            res = _tick_all(
                [lambda c=c, s=s, p=p: c.begin_scan(s, p)
                 for c, s, p in zip(cores, states, parts)],
                [lambda t, c=c: c.end(t, donate or own) for c in cores])
            return (joined([r[0] for r in res]),
                    _joined_ticks([r[1] for r in res], devices[0]))
        outs = []
        for t in range(seq.shape[0]):
            states, o = auto(states, [p[t] for p in parts], own or t > 0)
            outs.append(joined(o))
        if not (donate or own) and seq.shape[0] > 1:
            states = [_clone(states[0])]  # not the graph's input buffers
        return joined(states), ft.StepOutput(*(torch.stack(v)
                                               for v in zip(*outs)))

    return step_full, step_track, step_bucket, step_auto, step_scan


class BatchedTracker:
    """Serve N independent streams: ``step`` (host-scheduled), ``step_auto``
    (device-scheduled) or ``run_scan`` (K device-scheduled ticks).  With a
    ``mesh`` the instance is a ``_MeshTracker``, which splits the streams
    over the mesh's shards."""

    def __new__(cls, n_streams=None, frame_shape=None, params=None,
                cascade=None, mesh=None, *args, **kw):
        if mesh is not None and cls is BatchedTracker:
            cls = _MeshTracker
        return super().__new__(cls)

    def __init__(self, n_streams, frame_shape=(240, 320), params=None,
                 cascade=None, mesh=None, sync_interval=8, bucket=32,
                 band="auto", overload="full", escape_bucket=8, device=None,
                 **kw):
        """params / kw: TrackerConfig fields.  mesh: a
        ``parallel.stream_mesh`` to split the streams over (see
        ``_MeshTracker``); None serves them all on ``device``.  device: where
        state and compute live (default: the current CUDA device; with no
        card, pass device="cpu" to run the kernels' plain twins on the CPU).

        sync_interval: ticks between the host scheduler's reads of the mode
        vector (``step``).  bucket: the redetect bucket of both schedulers
        (see the module docstring).  band: "auto", None (full frame) or
        (bh, bw).  overload: the device scheduler's policy when more than
        chunk_cap streams pend, "full" or "rotate".  escape_bucket: with a
        band, the most escaped streams a tick recomputes as a sub-batch
        (more recompute the batch, as the reference's); a stream's result
        is the same either way."""
        self.config = TrackerConfig(**_merged_config(n_streams, params, kw))
        self.mesh = None
        self.n = n_streams
        self.frame_shape = tuple(frame_shape)
        self.cascade = cascade if cascade is not None else frontalface()
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # full-f32 matmuls and convolutions: the parity contract with
            # the reference has no room for TF32 rounding
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.band = resolve_band(band, self.frame_shape)
        self._band_audit = wants_band_audit(self.config, self.band)
        self.overload = overload
        self.sync_interval = max(1, int(sync_interval))
        self.bucket = max(1, min(int(bucket), n_streams))
        self._steps = _Steps(self.cascade, self.config, self.frame_shape,
                             self.device, self.band, self.bucket, overload,
                             escape_bucket)
        # the host scheduler's tick count; reset() keeps it, as the
        # reference's does, so the sync ticks stay on its schedule
        self._tick = 0
        self.reset()

    @property
    def _graph(self):
        """The serving program's all-CS body (its CUDA graph on the card),
        or None before the program is built."""
        return self._steps._graphs.get((self.n, 0))

    def _init_state(self, n):
        return ft.init_state(n, self.config.whitebalancing,
                             band_audit=self._band_audit, device=self.device)

    def reset(self):
        """Re-initialize every stream (fresh cold start)."""
        self.state = self._init_state(self.n)
        self._modes = self.state.mode.cpu().numpy()
        self._pending_modes = None  # the last tick's mode_after, unread

    def set_state(self, state, modes=None):
        """Replace every stream's state (e.g. a checkpoint's): ``state`` a
        TrackerState of this tracker's schema on its device, ``modes`` its
        host mode view (read from ``state.mode`` when None).  The serving
        program copies the new state into its state buffers at its next
        launch."""
        self.state = state
        self._modes = (state.mode.cpu().numpy() if modes is None
                       else np.array(modes, dtype=np.int32))
        self._pending_modes = None

    def reset_stream(self, i):
        """Re-initialize one stream (a new camera connects)."""
        self._drain()  # before overwriting the view
        s1 = self._init_state(1)
        idx = torch.tensor([int(i)], device=self.device)
        self.state = ft.tree_scatter(self.state, idx, s1)
        self._modes[int(i)] = int(s1.mode[0])

    @property
    def modes(self):
        """Host copy of the (N,) mode vector as of the last tick (the last
        sync's view after ``step(sync=False)`` ticks that are not due)."""
        return self._drain().copy()

    def _drain(self):
        """Bring the last tick's mode_after into the host view."""
        if self._pending_modes is not None:
            self._modes = _host(self._pending_modes)
            self._pending_modes = None
        return self._modes

    def branch(self, modes):
        """The device scheduler's branch for a host mode vector: "track",
        "wbtrack", "bucket" (bucket and chunk ticks, and the rotation) or
        "full"."""
        return self._steps.branch(modes)

    def _frames(self, frames, lead=()):
        return _staged(frames, lead + (self.n,) + self.frame_shape + (3,),
                       self.device)

    def step(self, frames, sync=False):
        """The host scheduler's tick.  frames: (N, H, W, 3) u8 (tensor or
        array).  Returns the StepOutput batch of (N,) tensors on the device.

        The mode view is refreshed from the previous tick's ``mode_after``
        every ``sync_interval`` ticks; sync=True refreshes it now and reads
        this tick's modes after it.  Stale views are safe: "track" freezes
        non-CS streams until a bucket or full tick serves them."""
        frames = self._frames(frames)
        self._tick += 1
        if sync or self._tick % self.sync_interval == 0:
            self._drain()
        non_cs = np.nonzero(self._modes != ft.MODE_CS)[0]
        return self._host_tick(frames, non_cs, non_cs.size > self.bucket,
                               sync)

    def _host_tick(self, frames, non_cs, full, sync):
        """The host scheduler's tick once its branch is picked: "full" on
        the batch, or "track" and then the full machinery for the streams
        ``non_cs`` (host array) still non-CS after it."""
        if full:
            state, out = self._steps.full(self.state, frames)
        else:
            state, out = self._steps.bucket_tick(self.state, frames, non_cs)
        self.state = state
        if sync:
            self._modes = state.mode.cpu().numpy()
            self._pending_modes = None
        else:
            self._pending_modes = out.mode_after
        return out

    def step_auto(self, frames):
        """One device-scheduled tick (the module docstring's branch rule,
        from the exact mode vector).  frames: (N, H, W, 3) u8.  Returns the
        StepOutput batch.  Per stream it equals ``step(sync=True)`` at
        sync_interval=1 under overload="full".  On the card: one launch of
        the serving program and one host read; ``self.state`` then holds
        the program's state buffers, which the next tick overwrites (the
        reference donates its state too)."""
        return self._auto_end(self._auto_begin(self._frames(frames)))

    def run_scan(self, frames_seq):
        """K device-scheduled ticks: frames_seq (K, N, H, W, 3) u8 (a host
        sequence is staged on the device in one copy; a device tensor is
        used in place).  Returns a StepOutput batch with (K, N) leaves, tick
        for tick those of K ``step_auto`` calls.  On the card the K ticks
        are one launch of the serving program and one host read (the last
        tick's mode_after), as the reference's ``scan_steps`` is one
        dispatch; the CPU runs the per-tick path."""
        seq = torch.as_tensor(frames_seq)
        if seq.dim() == 0 or seq.shape[0] == 0:
            raise ValueError("run_scan needs at least one tick "
                             "(frames_seq has leading length 0)")
        seq = self._frames(seq, lead=(seq.shape[0],))
        if self._steps.scheduled:
            return self._auto_end(self._scan_begin(seq))
        outs = [self._auto_end(self._auto_begin(seq[k]))
                for k in range(seq.shape[0])]
        return ft.StepOutput(*(torch.stack(v) for v in zip(*outs)))

    def warmup(self, scan_len=None, host_sched=True, device_sched=True):
        """Pay the first ticks' one-time costs up front: device_sched builds
        the kernels and, on the card, the serving program (every tick body
        captured, the program's CUDA graph built and instantiated);
        host_sched runs the eager steps once ("track", "full" on the batch,
        and the detector at the bucket's size).  The steps are functional,
        so ``self.state`` and the mode view are untouched.  scan_len: the
        reference compiles a program a K; here one graph serves every K
        (its WHILE node reads K at each launch), which device_sched builds,
        so scan_len is only checked."""
        if scan_len is not None and int(scan_len) < 1:
            raise ValueError(f"scan_len must be >= 1, got {scan_len}")
        frames = torch.zeros((self.n,) + self.frame_shape + (3,),
                             dtype=torch.uint8, device=self.device)
        if device_sched and self._steps.scheduled:
            self._steps.program(self.state)
        if host_sched:
            self._steps.track(self.state, frames)
            self._steps.full(self.state, frames)
            kb = self.bucket
            sub = ft.tree_index(self.state,
                                torch.arange(kb, device=self.device))
            sub = sub._replace(mode=torch.full_like(sub.mode, ft.MODE_VJ))
            self._steps.full(sub, frames[:kb], np.full((kb,), ft.MODE_VJ))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def _auto_begin(self, frames):
        """Start one device-scheduled tick from the state and the exact mode
        view (``_Steps.begin``)."""
        self._tick += 1
        return self._steps.begin(self.state, frames, self._drain())

    def _scan_begin(self, seq):
        """Start len(seq) device-scheduled ticks in one launch
        (``_Steps.begin_scan``)."""
        self._tick += seq.shape[0]
        return self._steps.begin_scan(self.state, seq)

    def _auto_end(self, tick):
        self.state, out, self._pending_modes = self._steps.end(tick)
        return out

    def stream_info(self, stream):
        """Per-stream snapshot (host reads; not for the per-tick path):
        mode "wb" | "vj" | "cs" (the scheduler's mode view), the search
        window [x, y, w, h], the model's distinct nonzero bins, and the
        bandHist audit flag (None when the audit is off)."""
        s = int(stream)
        mode = {ft.MODE_WB: "wb", ft.MODE_VJ: "vj",
                ft.MODE_CS: "cs"}[int(self.modes[s])]
        dirty = self.state.cs.band_dirty
        return {
            "stream": s,
            "mode": mode,
            "window": self.state.cs.window[s].tolist(),
            "model_bins": int((self.state.cs.model_hist[s] != 0).sum()),
            "band_dirty": bool(dirty[s]) if dirty is not None else None,
        }

    def band_hist_divergence(self, frames, stream=0):
        """bandHist cross-check for one stream: its current histogram full
        frame (reference-exact) and over its band (the serving
        approximation) at its current window, and the weight divergence
        the band pdf would see.  Returns max_inflation (largest band minus
        full weight over bins present in the band; 0.0 = exact tick),
        contaminated_bins (model bins the band undercounts), model_bins and
        band_dirty."""
        if self.band is None or not self.config.bandHist:
            raise ValueError("band_hist_divergence needs an active band "
                             "path with bandHist=True")
        s = int(stream)
        frame = torch.as_tensor(frames).to(self.device)[s:s + 1].contiguous()
        model = self.state.cs.model_hist[s:s + 1]
        rect = cs_mod.band_rects(*cs_mod.band_rect(
            self.state.cs.window[s:s + 1], self.band, self.frame_shape))
        # the reference always counts this one with histogram_scan, whatever
        # histKernel says: here its kernel, hist_mma
        cur_full = histogram_full(frame, None)
        cur_band = histogram_rects(frame, rect)
        w_full = backprojection_weights(model, cur_full)
        w_band = backprojection_weights(model, cur_band)
        present = cur_band > 0  # bins the band pdf can read
        infl = torch.where(present, w_band - w_full, 0.0).max()
        contaminated = (model > 0) & (cur_band < cur_full) & present
        dirty = self.state.cs.band_dirty
        return {
            "max_inflation": float(infl),
            "contaminated_bins": int(contaminated.sum()),
            "model_bins": int((model > 0).sum()),
            "band_dirty": bool(dirty[s]) if dirty is not None else None,
            "stream": s,
        }


class _MeshTracker(BatchedTracker):
    """``BatchedTracker(mesh=...)``: the N streams split into equal shards,
    one a mesh entry, each served by a meshless tracker of N / shards
    streams on its entry's device, with its own state slice, mode view and
    CUDA graph.  The bucket is clamped to a shard's streams, as in the
    reference (the device scheduler's bucket is per shard).

    Device scheduler (``step_auto``, ``run_scan``): each shard picks its own
    branch and bucket (under overload="rotate" also its own chunk cap and
    ``pend_age`` order) from its own slice, as the reference's shard_map
    does.  Every shard's tick is enqueued before the first host read; then
    one wait a device, then each shard's sync word is read.  Host scheduler
    (``step``): the reference's global rule, one mode view over all N: the
    count of non-CS streams against the clamped bucket picks "full" on every
    shard, or "track" with the bucket's indices split by shard (a shard with
    none runs "track" alone).

    Frames are cut on the host (or on the frames' device) and each slice is
    copied to its shard's device.  Outputs and ``state`` read in stream
    order on the first shard's device; ``set_state`` splits a state over the
    shards.  Stream i lives in shard i // per as its stream i % per.  A
    kernel that fails on any shard raises; no shard falls back."""

    def __init__(self, n_streams, frame_shape=(240, 320), params=None,
                 cascade=None, mesh=None, sync_interval=8, bucket=32,
                 band="auto", overload="full", escape_bucket=8, device=None,
                 **kw):
        if device is not None:
            raise ValueError("pass mesh or device, not both: the mesh names "
                             "its shards' devices")
        k = mesh.devices.size
        if n_streams % k:
            raise ValueError(f"n_streams={n_streams} not divisible by mesh "
                             f"size {k}")
        self.mesh = mesh
        self.n = n_streams
        self.per = n_streams // k
        self.cascade = cascade if cascade is not None else frontalface()
        # the batch's capacity defaults follow all N streams, as in the
        # reference; the shards take the merged fields as they are
        merged = _merged_config(n_streams, params, kw)
        bucket = min(max(1, min(int(bucket), n_streams)), self.per)
        self._shards = [
            BatchedTracker(self.per, frame_shape, merged, self.cascade,
                           sync_interval=sync_interval, bucket=bucket,
                           band=band, overload=overload,
                           escape_bucket=escape_bucket, device=d)
            for d in mesh.devices.flat]
        s0 = self._shards[0]
        self.config, self.frame_shape = s0.config, s0.frame_shape
        self.device = s0.device
        self.band = s0.band
        self.overload = overload
        self.sync_interval, self.bucket = s0.sync_interval, s0.bucket
        self._tick = 0

    @property
    def state(self):
        """Every stream's state as one tree over N on the first shard's
        device, assembled on each read (write it with ``set_state``)."""
        return self._joined([s.state for s in self._shards])

    def _joined(self, parts):
        """The shards' trees (states or outputs) as one in stream order on
        the first shard's device; one shard's tree as it is."""
        return parts[0] if len(parts) == 1 else gather_streams(parts,
                                                               self.device)

    def set_state(self, state, modes=None):
        """Split ``state`` (a TrackerState over N, on any device) and its
        host mode view (read from the state when None) over the shards."""
        parts = shard_streams(state, self.mesh, self.mesh.axis_names[0])
        views = ([None] * len(parts) if modes is None else
                 split_streams(np.array(modes, dtype=np.int32), len(parts)))
        for s, p, m in zip(self._shards, parts, views):
            s.set_state(p, m)

    def reset(self):
        for s in self._shards:
            s.reset()

    def reset_stream(self, i):
        j, local = divmod(int(i), self.per)
        self._shards[j].reset_stream(local)

    @property
    def modes(self):
        return np.concatenate([s.modes for s in self._shards])

    def branch(self, modes):
        """Each shard's device-scheduler branch for a host mode vector over
        N, as a list in shard order."""
        return [s.branch(m) for s, m in zip(
            self._shards, split_streams(np.asarray(modes), len(self._shards)))]

    def _split(self, frames, lead=()):
        """Each shard's slice of a frame batch (the stream axis after
        ``lead``) on its device, one copy a shard."""
        if len(self._shards) == 1:
            return [self._shards[0]._frames(frames, lead)]
        frames = _check_frames(torch.as_tensor(frames),
                               lead + (self.n,) + self.frame_shape + (3,))
        parts = split_streams(frames, len(self._shards), len(lead))
        return [s._frames(p, lead) for s, p in zip(self._shards, parts)]

    def step(self, frames, sync=False):
        parts = self._split(frames)
        self._tick += 1
        if sync or self._tick % self.sync_interval == 0:
            for s in self._shards:
                s._drain()
        view = np.concatenate([s._modes for s in self._shards])
        non_cs = np.nonzero(view != ft.MODE_CS)[0]
        full = non_cs.size > self.bucket
        outs = [s._host_tick(f, non_cs[non_cs // self.per == j] % self.per,
                             full, sync)
                for j, (s, f) in enumerate(zip(self._shards, parts))]
        return self._joined(outs)

    def step_auto(self, frames):
        return self._auto_all(self._split(frames))

    def run_scan(self, frames_seq):
        seq = torch.as_tensor(frames_seq)
        if seq.dim() == 0 or seq.shape[0] == 0:
            raise ValueError("run_scan needs at least one tick "
                             "(frames_seq has leading length 0)")
        parts = self._split(seq, lead=(seq.shape[0],))
        if self._shards[0]._steps.scheduled:
            self._tick += seq.shape[0]
            return _joined_ticks(_tick_all(
                [lambda s=s, p=p: s._scan_begin(p)
                 for s, p in zip(self._shards, parts)],
                [s._auto_end for s in self._shards]), self.device)
        outs = [self._auto_all([p[k] for p in parts])
                for k in range(seq.shape[0])]
        return ft.StepOutput(*(torch.stack(v) for v in zip(*outs)))

    def _auto_all(self, parts):
        """One device-scheduled tick on every shard (``_tick_all``)."""
        self._tick += 1
        return self._joined(_tick_all(
            [lambda s=s, f=f: s._auto_begin(f)
             for s, f in zip(self._shards, parts)],
            [s._auto_end for s in self._shards]))

    def warmup(self, scan_len=None, host_sched=True, device_sched=True):
        for s in self._shards:
            s.warmup(scan_len, host_sched, device_sched)
        return self

    def stream_info(self, stream):
        j, local = divmod(int(stream), self.per)
        return dict(self._shards[j].stream_info(local), stream=int(stream))

    def band_hist_divergence(self, frames, stream=0):
        s = int(stream)
        j, local = divmod(s, self.per)
        one = torch.as_tensor(frames)[s:s + 1]
        return dict(self._shards[j].band_hist_divergence(one, 0), stream=s)
