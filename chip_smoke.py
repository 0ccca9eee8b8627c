#!/usr/bin/env python3
"""Drive the PyTorch port's serving paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits nonzero:
  1. device: the card's name and power limit (nvidia-smi); no card -> exit 1;
  2. build: nvcc builds the CUDA kernels from headtrackr_tpu_torch/csrc/,
     one process per source, all started together;
  3. kernels: hist4096, backproject (frame and band), backproject_ratio
     (frame and band: the same kernels forming min(model / cur, 1) as they
     stage their tables, at N=256, 8 and 1, on the bench pools' counts and
     on tables with zero counts, clamped and equal bins and model bins
     absent from the frame), histpdf_band (pdf and
     hist-only) on the card at N=256 x 240x320 must be bit-equal to their
     plain PyTorch twins on the same inputs (tolerance 0): the bench pools
     (face_noise 0 and 20) and uniform random frames, with full-frame
     rects, random detection boxes and 96x128 bands, plus histpdf_band on
     the TPU experiments' own workload (the full frame, random bins, a model
     of integers 1..199).  The band kernels (backproject_rect,
     histpdf_band's pdf mode) take search windows and place each band
     themselves: they are held against the rects form (the twin at
     models/camshift.py band_rect's rects) and against their placed twins
     on the CPU, and backproject_rect also on windows at every clip of the
     placement (below 0, past the right and bottom edges, negative and odd
     sizes), windows of the band's size on the 8-pixel grid, odd band
     widths, a band equal to the frame or as wide as it and a 57x99 frame
     (and timed on windows from -20 up and on the grid), histpdf_band
     likewise at N=256, 1 and 3;
     hist4096 and histpdf_band's hist-only mode (one cluster kernel) also
     on bench, uniform random, uniform random-bin and one-bin frames of
     240x320, 241x320, 57x99 and 8x8 at N=256, 1, 2 and 3, with full
     rects, boxes partly outside the frame and empty rects, and on frames
     one byte off the 16-byte boundary; hist4096 is timed also on uniform
     random bins.  take_along likewise on X8's own workload (an
     (8, 128) lane gather) and on prefix-sum planes of 256 streams (the
     96x128 band and the 240x320 frame, one mean-shift iteration's row and
     column selections: the serving path's use of it before meanshift).
     meanshift (the whole mean shift a launch) must be bit-equal to its
     twin run on the card and to its twin run on the CPU on the serving
     path's inputs from the bench pools (face boxes as windows, the pdf of
     a tracking batch and of the loss batch through histpdf_band at the
     96x128 band and at 128x192, each band placed from the window walked,
     and through backproject over the frame (the kernel places the band
     from the window; its twin on the card takes band_rect's origins, its
     twin on the CPU places them); 128 of those frame pdfs upsampled 2x by
     nearest neighbour to 480x640, the 640x480 cell's frames), on
     escaping, off-frame and empty windows and at N=1, each through the
     kernel kernels/meanshift.py route picks (logged: one CTA a stream, a
     cluster of C CTAs a stream, or the global scratch).  Each is timed (CUDA events over 20 calls, and
     over 20 calls replayed from a CUDA graph) beside its twin, its
     byte/operation bound and the nearest single PyTorch call (given
     precomputed bins for the histogram kernels; torch.gather for
     take_along; none computes meanshift's function), the library call by
     events and, where a graph can capture it (torch.gather; not
     torch.bincount, which reads its max on the host), by graph replay.  hist_mma (the int8 tensor-core histogram)
     likewise on the bench pools, uniform random frames, one-bin frames and
     random boxes at N=256, 1, 2 and 3, on 241x320, 48x80 and 57x99 frames
     (pixel counts off its 1,024-pixel stage, with and without its bulk
     copies) and on X6's own workload (the full frame, uniform random
     bins), timed beside its twin, hist4096's bound (the histogram's bytes),
     the dense int8 one-hot product's tensor-core time and torch.bincount;
     hist4096 is also timed at N=1, the session's shape.  hist_bins (the
     bins-in histogram) must be bit-equal to its twin and to hist4096 of
     the full frame of the same pixels on X5's own workload (uniform random
     ids of shape (256, 8, 9600)), the bench pools' bins, uniform random
     frames' bins, one-bin rows, rows of 76,799 ids (a tail) with -1, -64
     and >= 4096 ids among them (and a view of them off the 16-byte
     boundary), N=1 and 65,537 rows of 16 ids (past a launch's 65,535
     rows: two launches, hist4096 compared chunk by chunk); one device
     operation a call (torch.profiler: no memset, no cast); timed (events
     and graph replay) beside its twin, its byte bound and torch.bincount
     on X5's workload, the bench bins and at N=1, with its cluster size C.
     The detector's kernels: pyramid (the frames into the packed plane
     buffer), cascade (every window through the stages, the survivors in
     window order, capacity C) and group (grouping and the pick) must be
     bit-equal to their twins run on the card (and, at <= 8 streams, run
     on the CPU), candidates slot for slot and overflow equal: the bench
     pools and uniform random frames at N=256, 8 and 1 with the real
     cascade, the toy cascade on a bench batch and on random frames (more
     survivors than C: overflow), C=1 on the bench, 480x640 frames, and
     frames tiled with faces at N=8 and 256 (deep survivors in every warp
     that holds a face); group also with min_neighbors 0, and on
     tools/torch_group_cases.py's adversarial slot sets (the longest
     component, 256 singletons, every slot valid, k = 1, 32, 33 and 256,
     equal confidences, a non-prefix mask, a contained cluster) at
     min_neighbors 0, 1 and 3.  It logs group's k (the last valid slot + 1:
     at most 32, warp 0 groups alone) over the bench pool, face_noise 20,
     the faces pool, the relock bucket (the loss streams' frames after the
     blue one) and random toy frames, and checks that a group call is one
     device operation: the CUDA graph that captures it holds one node, a
     kernel (libcuda's cuGraphGetNodes).  On the bench
     pool at N=8 and 256 it logs, from the plain code, the deep survivors
     and the deep weak classifiers the busiest warp of 32 windows held
     under the old division (each warp walked its own survivors' chains).
     Each is timed at N=256, 8 and 1 (pyramid and cascade also at
     480x640) by events and graph replay beside its twin, its bound and
     (pyramid) one F.interpolate resize, the nearest library call; group
     also beside an empty kernel at its grid (the floor of one device
     operation), and on its worst case (random toy frames: every slot
     valid) and the adversarial chain, shuffled chain, singletons and
     dense slots.  tick_epilogue (K8: camshift's finish, the "track"
     step's freeze and the supervision, one launch) must be bit-equal
     (NaN-equal) to its twin run on the card: tools/torch_epilogue_cases.py
     at N=256 (every form, each of the 64 configurations of the flag grid,
     every branch reached, one launch a call), and the bench pools' own
     mean-shift outputs and states (face boxes handed off on batch 0, the
     banded "track" step over batches 1 to the loss batch) through the
     fused form, the finish alone and the supervision of the "full" and
     "wbtrack" variants, under the headline's configuration and under
     calcAngles with the "escape" audit action; timed (events, graph
     replay) on batch 1's inputs beside its twin, an empty kernel at its
     grid and its byte bound (no PyTorch call computes its function), and
     on those inputs tiled to 10,240 streams (bit-equal there too; events,
     graph replay, the empty kernel at that grid).  After phase 5, each
     body of the headline's serving program (all-CS, the bucket at each
     slot count, wbtrack, full, few, many) must launch tick_epilogue (its
     tally), with its graph's nodes counted (phase 5's relock profile
     reports them by body); the all-CS body must hold at most
     ALLCS_BODY_NODES graph nodes (histpdf_band, meanshift, tick_epilogue:
     the band kernels place the band, so no PyTorch operation of it is
     left);
 3b. bucket: the relock tick's bucket kernels, frame_prep (K9), handoff
     (K7) and slot_gather (S5), bit-equal to their twins run on the card
     (tools/torch_bucket_cases.py at 1, 8 and 256 streams, every branch;
     slot_gather at every slot count to the chunk cap and at
     escape_bucket under both keep rules; then the relock tick's own
     shapes on the bench pool: 8 slots over 256 streams, the 4 loss
     streams served and padding, face boxes as the detections, the 96x128
     band's audit; and slot_gather on the few escape body's 8 slots, 3
     escaped, with the frames a leaf), each timed (events, graph replay)
     beside its twin, an empty kernel at its grid, the bytes this run's
     data needs and a library call (a channel sum, torch.bincount of the
     rects' bins, index_select of the model histograms' rows or of the
     frames' rows); frame_prep and handoff reading tick 2 of a scan in
     place (through a device word, as the serving program's bodies read
     them) bit-equal to their direct reads at 8 and 256 streams, 320x240
     and 57x99 frames, the scan on a 16-byte boundary and 4 and 1 bytes
     past one (check_in_place), and on the relock tick's and the cold
     start's calls timed in place beside direct (graph replay, in turns);
  4. serving: BatchedTracker(256, (240, 320)) with the real cascade and the
     bench protocol in three configurations: the full-frame arm
     (histKernel="pallas": hist4096), a 96x128 band with full-frame
     histograms (the default histKernel: hist_mma), and the headline (96x128
     band, bandHist, bucket 8).  Each, after warmup() and with the launch counts
     at 0: 16 lock ticks and 32 ticks of step_auto over a 16-batch pool
     with 4 loss streams, then run_scan over the pool (K = 16, as bench.py
     runs it).  Checks: >= 99% locked, loss streams relock, every kernel of
     its path launched in its run (the headline's also through
     band_hist_divergence, the bandHist cross-check, whose band histogram
     is histpdf_band's hist-only mode), no NaN outside the zero-mass
     angle; and
     a second tracker driven by step(sync=True) at sync_interval 1 over the
     same 64 frame batches agrees on every tick (integers exact, floats
     within rtol 1e-5 / atol 1e-4; the largest float difference printed).
     ms/tick of step_auto, run_scan and step;
  5. steady-tick profile: on each configuration's locked tracker of phase 4,
     PROFILE_TICKS all-tracking ticks (pool batches before the loss frame)
     of step_auto (one launch of the serving program a tick) and of step
     (the eager
     host-scheduled tick), configurations in turns, two passes: host
     ms/tick unprofiled, then under torch.profiler the device ms per tick,
     the device busy share (device ms over profiled wall time), the device
     operations per tick and the host's launch calls per tick.  Then the
     headline's relock tick: the loss streams turn blue and redetect on
     the next batch (a bucket tick), one launch of the serving program and
     the same tick eager on the per-tick path, in turns: host ms, device
     ms, device operations, host launch calls and host reads a relock
     tick.  The headline's steady step_auto tick must take at most
     STEADY_OPS device operations (9: no PyTorch operation of the band is
     left in it); no tick of any configuration runs scan_step (phase 4's
     cold start, relocks and steady ticks, the relock tick, the profiled
     steady ticks: every body reads the tick's frames in place), and the
     band and
     full-frame all-CS bodies hold no graph node but hand-written kernels
     (``foreign_nodes``: ALLCS_NODES of them, the ratio weights formed in
     the backprojection kernel, no rect made on the card);
  6. card vs CPU: 2 streams x 24 ticks through the port on the card and on
     the CPU (plain twins), full-frame and headline configurations, agree:
     integer outputs exactly, floats within rtol 1e-5 / atol 1e-4;
  7. session: a Tracker(debug=True) with the real cascade over a 320x240
     ClipSource of 256 frames of one bench-pool stream (its 15 loss frames
     included) passes whitebalance -> detecting -> found, emits finite
     facetrackingEvents and headtrackingEvents, relocks after each loss,
     shows a (240, 320, 3) u8 backprojection on CS frames, and launches
     hist_mma and backproject_ratio; ms per step_once (mean, p50, p99) over all
     frames and by the mode each frame ran in (WB, VJ, CS);
  8. fanout and checkpoint: a BatchedSession of 256 pull-mode ClipSources
     (the bench pool, headline configuration) over 32 ticks plus flush()
     emits, per stream, the events a StreamFanout emits from a second
     tracker's step(sync=True) outputs on the same frames (time excluded);
     then save_tracker mid-track, load_tracker into a fresh tracker, whose
     next 8 ticks equal the uninterrupted tracker's (integers exact, floats
     rtol 1e-5 / atol 1e-4); file size, save and load ms;
  9. facades: the reference-parity namespace on the card over the session's
     clip (one bench-pool stream, 256 frames, 15 loss frames), real
     cascade: facetrackr.Tracker goes WB x 15 -> VJ -> CS, its CS boxes are
     finite and the first loss frame collapses the box for good (the
     orchestrator never leaves CS, as in the reference); the first 24
     frames again with device="cpu" agree (integers exact, floats rtol 1e-5
     / atol 1e-4); headposition.Tracker from the first CS result, fed each
     live CS box, with a controllers.RealisticAbsoluteCameraControl on the
     bus: one finite pose per headtrackingEvent; Smoother over the boxes;
     camshift.Histogram of each frame equals hist4096 of the full frame;
     hist_bins, hist_mma, backproject_ratio, handoff and meanshift
     each launched; ms per track() by mode (p50/p99), per
     ccv.detect_objects at 320x240 and per Histogram;
 10. plan and examples: plan_serving's kwargs for 256 streams of 320x240
     (24 px faces, 4 losses) build a BatchedTracker on the card that locks
     >= 99% of the bench pool in 16 ticks and runs a K=4 scan with finite
     outputs; examples/torch_batched_serving.py (every stream tracks, head
     events on each) and examples/torch_facetracking.py --toy (ends
     tracking, head events printed) run on the card; with the launch
     counts at 0 before, the headline configuration's kernels launched;
 11. mesh: the headline configuration at 256 streams on the bench pool
     (16 lock ticks, 32 ticks of step_auto with the 4 loss streams, then
     run_scan with K = 16) meshless, on (a) stream_mesh() (the card's
     devices, one shard) and (b) stream_mesh([card] * 4) (four shards of
     64 on the one card): every output leaf of every tick and the final
     state of (a) and (b) equal the meshless tracker's (integers exact,
     floats bit-equal); histpdf_band and meanshift launched on every
     step_auto tick, once a shard (4x a tick in (b)); a checkpoint saved
     from (b) loads into a meshless tracker whose next 8 ticks equal (b)'s,
     bit for bit; ms/tick of step_auto (host clock over ticks ending in a
     synchronize) over the 32 ticks and over 32 all-CS ticks, trackers in
     turns (four each); phase 5's profile of (a) and (b) (step_auto, and
     step: the host scheduler on the mesh);
 12. gate: tools/torch_verify_gpu.py (loaded by path) on the card with 60
     tracked frames, every clip kind (realistic and degenerate clips, the
     relock gate with bandHist on and off, the lighting and occlusion
     clips, the clutter crowd) at 320x240 and 640x480: the port's full
     step and serving path (bandHist on and off) against the port's copy
     of the f64 oracle; a failed gate raises.

 13. bench: ``python3 bench_torch.py`` as a subprocess on the card, three
     runs of 64 timed ticks: the headline with the exact arm, --h2d and 20
     latency ticks; --face-noise 20; 640x480 at 128 streams (meanshift's
     scratch kernel).  Each must exit 0 with its JSON line holding every
     key, >= 99% locked, relocks, and the headline path's kernels launched
     in its run; each line is printed here.
 14. surface: the reference's public names on the card with every device
     argument left at None, the launch counts at 0 before: kernels.
     hist_pallas and pdf_pallas (the hist_bins and pdf_bins kernels) on
     the bench pool's bins at N=256 and N=1, on one (H, W) frame and on ids
     outside [0, 4096) (counted nowhere, looked up as 0);
     models.camshift.mean_shift on pdf_pallas's pdf; handoff_band_audit on
     bins (stream 1 with a pixel of its face's color far from it: dirty);
     detect_best(gray, cascade) with the real cascade at N=8;
     init_state and cascade_to_torch.  Each is bit-equal to its kernel's
     twin and to the path it aliases (hist4096 and backproject of the same
     frames, the kernel wrapper's mean shift and its twin, init_tracker's
     frames audit, detect_best on the tables), and every kernel of
     SURFACE_PATH launched, and take_along not (pdf_pallas is one
     pdf_bins launch: the CUDA graph that captures a call at N=256 and at
     N=1 holds one node, a kernel).  The two entry points are timed at
     N=256 and N=1 (events and graph replay) beside their twins, byte
     bounds, torch.bincount and torch.gather, and the card's name and power
     limit; hist_bins' and pdf_bins' kernel entries carry these under
     "surface" (pdf_bins' launches, times and error are this phase's).
 15. schedule (run after phase 6): the serving program's kernels
     (csrc/schedule.cu) bit-equal to their twins (tick_select and
     escape_select on random vectors with ties at 256, 4,096, 10,240 and
     65,536 streams, both overloads; scan_step, whole and in rows mode on
     a bucket tick's 8 slots, into a buffer poisoned with 255, and
     scan_commit on the headline program's own tables: the all-CS body's,
     whose model histograms pass through, and the bucket body's, which
     changes them) and timed
     (events and graph replay) beside their twins, byte bounds and one
     PyTorch call (torch.topk, copy_, index_copy_, _foreach_copy_);
     histpdf_band reading tick k's frames in place (through the parameter
     block's address word) bit-equal to its direct read and timed beside
     it in turns; the selects also at each of those sizes on a bucket
     tick and an all-CS tick, beside an empty kernel at their grid and
     torch.topk; then the headline configuration at 256 streams
     from init_state under overload "full" and "rotate", two run_scan
     calls of 16 ticks each, the bodies' frame buffer freed after their
     capture, from a poisoned many-body list and chunk slots (elist,
     cidx; the cold start's
     wbtrack and full ticks or its rotation burst, bucket and chunk ticks
     after losses, band escapes within escape_bucket and beyond it): every
     StepOutput leaf and the final state bit-equal to the per-tick path
     run eagerly on the card, every branch's body run (the program's own
     counts), scan_step run on no tick (every body reads the tick's
     frames in place), scan_commit once a tick,
     once more a few body's run and once a many body's chunk, the
     per-tick path's host code never reached (kernels/launch.py
     host_paths); an all-CS scan of 16 ticks runs no scan_step; a
     profiled scan of 16 ticks is one program launch, one host read and
     no kernel launched from the host; many escape ticks (SCHED_MANY: the
     windows of E streams, the first and the last among them, made taller
     than the band) bit-equal to the per-tick path, each in its chunk
     plan's big and small chunks, their device ms and operations
     profiled; the same on a tracker whose many body runs big chunks of
     64 and small ones of 16 (SCHED_CHUNKED_MANY: E = 150 runs two of
     each, every stream four big ones).  Then
     the headline at 10,240 streams (the pool tiled 40 times on the card)
     from init_state under both overloads, run_scan calls of 4 ticks, the
     frame buffer freed: every leaf and the final state
     bit-equal to the per-tick path, one program launch a call, each
     schedule kernel's runs as above (the card's counts); under "full"
     every stream s bit-equal to stream s mod 256 of a 256-stream program
     run on the same ticks; its cold start and an all-CS scan timed (host
     ms and device span a tick) and one all-CS scan profiled (one launch,
     one host read, no kernel launched from the host), scan_commit on
     its tables timed as at 256 streams, and many escape ticks
     (SCHED_BIG_MANY: E = 300 runs a big chunk and two small ones, 1,000
     four big ones) as at 256 streams.
 16. F32 (run after phase 15): every kernel whose grid's y dimension is
     the stream (hist4096, histpdf_band hist-only and pdf mode, directly
     and through the address word from a buffer poisoned with 255,
     backproject over the frame and the band, hist_mma, pyramid, cascade)
     at 70,000 streams of 160x120 (tools/torch_f32_cases.py: the bench
     pool's streams tiled, each stamped with its index), one launch a
     chunk of 65,535 streams, bit-equal to its twin run on the card in
     slices; each launcher refuses 65,536 streams; then, with the launch
     counts at 0, BatchedTracker(70000, (120, 160)) from init_state over
     20 ticks (15 wbtrack, the full tick, all-CS ticks, the last two one
     run_scan): the serving program bit-equal to the per-tick path run
     eagerly on the card, every leaf of every tick and the final state,
     one launch a call, every kernel of its path launched; and frame_prep,
     handoff and slot_gather at 70,000 streams bit-equal to their twins
     (tools/torch_bucket_cases.py).

The last four lines: the steady-tick and relock profiles, session, fanout, checkpoint,
facade, plan, mesh, gate, bench, surface, schedule and F32 numbers as JSON
(phases 5, 7-16), the kernels' JSON, the nvidia-smi name/power line, and {"ok": true,
"device": {...}}.  Imports nothing of JAX or headtrackr_tpu.
"""

import json
import os
import subprocess
import sys
import time

H, W = 240, 320
N_STREAMS = 256
POOL = 16
LOCK_TICKS = 16
LOSS_STREAMS = 4
LOSS_AT = POOL // 2  # the pool batch where the loss streams turn blue
PROFILE_TICKS = 8
# the headline's steady tick now that the band kernels place their bands
# (PERF.md section 6): step_auto's device operations a tick (the frames'
# address in, tick_select, histpdf_band, meanshift, tick_epilogue,
# escape_select, scan_commit, the host read's two copies) and the all-CS
# body's graph nodes (histpdf_band, meanshift, tick_epilogue; at most 5)
STEADY_OPS = 9
ALLCS_BODY_NODES = 5
# the band and full-frame configurations' all-CS body: its graph's nodes,
# each a hand-written kernel (band: hist_mma and its reduction,
# backproject_rect_ratio, meanshift, tick_epilogue; full frame: hist4096,
# backproject_ratio, meanshift, tick_epilogue)
ALLCS_NODES = {"band": 5, "full-frame": 4}
BAND = (96, 128)
RTOL, ATOL = 1e-5, 1e-4
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
INT8_OPS_PER_S = 1979e12    # H100 SXM dense int8 tensor cores
HISTPDF_SRC = "headtrackr_tpu_torch/csrc/histpdf.cu"
GATHER_SRC = "headtrackr_tpu_torch/csrc/gather.cu"
HISTMMA_SRC = "headtrackr_tpu_torch/csrc/histmma.cu"
HISTBINS_SRC = "headtrackr_tpu_torch/csrc/histbins.cu"
PDFBINS_SRC = "headtrackr_tpu_torch/csrc/pdfbins.cu"
MEANSHIFT_SRC = "headtrackr_tpu_torch/csrc/meanshift.cu"
PYRAMID_SRC = "headtrackr_tpu_torch/csrc/pyramid.cu"
CASCADE_SRC = "headtrackr_tpu_torch/csrc/cascade.cu"
GROUP_SRC = "headtrackr_tpu_torch/csrc/group.cu"
EPILOGUE_SRC = "headtrackr_tpu_torch/csrc/epilogue.cu"
FRAMEPREP_SRC = "headtrackr_tpu_torch/csrc/frameprep.cu"
HANDOFF_SRC = "headtrackr_tpu_torch/csrc/handoff.cu"
SCHEDULE_SRC = "headtrackr_tpu_torch/csrc/schedule.cu"
# the relock tick's bucket body (phase 3b): its slots (the headline's
# bucket, LOSS_STREAMS of them served) and the kernels of its pending step
BUCKET = ("frame_prep", "handoff", "slot_gather")
BUCKET_SLOTS = 8
BUCKET_NS = (1, 8, 256)  # phase 3b's checks against the twins
# f32 operations a stream takes through tick_epilogue's fused form at most
# (csrc/epilogue.cu, counting a square root or a transcendental as one: the
# finish's 28, the supervision's 37, the FOV estimate's 11, track_head's 58)
EPILOGUE_OPS = 134
DETECT = ("pyramid", "cascade", "group")  # the detector's kernels
DETECT_NS = (256, 8, 1)  # phase 3's timed stream counts (8: a bucket)
DETECT_BIG = 16  # streams of the 480x640 case
WORST_GROUP = "random toy N=256 (overflow)"  # every slot valid: group's k^2
RELOCK_TICKS = 6  # phase 5: profiled relock ticks an arm
SESSION_FRAMES = 16 * POOL  # 15 losses: the CS frames' p99 is not their max
FANOUT_TICKS = 2 * POOL
RESUME_TICKS = 8
# the host's launch calls as the profiler names them (kernels and graphs)
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")

# serving configurations: name -> (BatchedTracker kwargs, kernels of its path)
CONFIGS = {
    "full-frame": (dict(band=None, bandHist=False, bucket=8,
                        histKernel="pallas"),
                   ("hist4096", "backproject_ratio", "meanshift",
                    "tick_epilogue") + DETECT + BUCKET),
    "band": (dict(band=BAND, bandHist=False, bucket=8),
             ("hist_mma", "backproject_rect_ratio", "meanshift",
              "tick_epilogue") + DETECT + BUCKET),
    "headline": (dict(band=BAND, bandHist=True, bucket=8),
                 ("histpdf_band", "meanshift", "tick_epilogue") + DETECT
                 + BUCKET),
}
# kernel -> (the TPU kernel it replaces, the configuration whose run its
# launch count reports, its source)
KERNELS = {
    "hist4096": ("headtrackr_tpu/kernels/histpdf.py:109", "full-frame",
                 HISTPDF_SRC),
    "backproject": ("headtrackr_tpu/kernels/histpdf.py:123", "full-frame",
                    HISTPDF_SRC),
    "backproject_rect": ("headtrackr_tpu/kernels/histpdf.py:123", "band",
                         HISTPDF_SRC),
    # K2's kernels forming the ratio weights (an XLA path, no Pallas
    # kernel of its own) as they stage their tables
    "backproject_ratio": ("headtrackr_tpu/ops/histogram.py:141",
                          "full-frame", HISTPDF_SRC),
    "backproject_rect_ratio": ("headtrackr_tpu/ops/histogram.py:141",
                               "band", HISTPDF_SRC),
    "histpdf_band": ("tools/kernel_experiments.py:148", "headline",
                     HISTPDF_SRC),
    "histpdf_band_hist": ("tools/kernel_experiments.py:84", "headline",
                          HISTPDF_SRC),
    "take_along": ("tools/kernel_experiments.py:396", "headline", GATHER_SRC),
    "meanshift": ("tools/kernel_experiments.py:397", "headline",
                  MEANSHIFT_SRC),
    "hist_mma": ("tools/kernel_experiments.py:257", "band", HISTMMA_SRC),
    "hist_bins": ("tools/kernel_experiments.py:257", "facade", HISTBINS_SRC),
    "pdf_bins": ("headtrackr_tpu/kernels/histpdf.py:123", "surface",
                 PDFBINS_SRC),
    "pyramid": ("headtrackr_tpu/ops/imageproc.py:141", "headline",
                PYRAMID_SRC),
    "cascade": ("headtrackr_tpu/models/detector.py:595", "headline",
                CASCADE_SRC),
    "group": ("headtrackr_tpu/models/detector.py:517", "headline", GROUP_SRC),
    # XLA's chain after the branches, no Pallas kernel: camshift's finish
    # and the supervision
    "tick_epilogue": ("headtrackr_tpu/models/camshift.py:364", "headline",
                      EPILOGUE_SRC),
    # the relock tick's bucket body: XLA paths, no Pallas kernel
    "frame_prep": ("headtrackr_tpu/ops/imageproc.py:35", "headline",
                   FRAMEPREP_SRC),
    "handoff": ("headtrackr_tpu/models/camshift.py:133", "headline",
                HANDOFF_SRC),
    "slot_gather": ("headtrackr_tpu/runtime/serving.py:299", "headline",
                    SCHEDULE_SRC),
    # the serving program's kernels: XLA's control flow, no Pallas kernel
    "tick_select": ("headtrackr_tpu/runtime/serving.py:326", "schedule",
                    "headtrackr_tpu_torch/csrc/schedule.cu"),
    "escape_select": ("headtrackr_tpu/runtime/serving.py:225", "schedule",
                      "headtrackr_tpu_torch/csrc/schedule.cu"),
    "scan_step": ("headtrackr_tpu/runtime/serving.py:426", "schedule",
                  "headtrackr_tpu_torch/csrc/schedule.cu"),
    "scan_commit": ("headtrackr_tpu/runtime/serving.py:426", "schedule",
                    "headtrackr_tpu_torch/csrc/schedule.cu"),
}
# the kernels that phase 14's calls of the reference's surface launch
SURFACE_PATH = ("hist_bins", "pdf_bins", "meanshift") + DETECT
SURFACE_NS = (N_STREAMS, 1)  # hist_pallas / pdf_pallas: 256 streams and one
SURFACE_DETECT = 8  # detect_best(gray, cascade): a relock bucket's streams
# the kernels the facade phase's path launches
FACADE_PATH = ("hist_bins", "hist_mma", "backproject_ratio", "handoff",
               "meanshift")
FACADE_CPU_FRAMES = 24
ALSO_REPLACES = {"histpdf_band": "tools/kernel_experiments.py:351",
                 "backproject_ratio": "headtrackr_tpu/kernels/histpdf.py:123"
                 " (with headtrackr_tpu/models/camshift.py:425)",
                 "backproject_rect_ratio":
                     "headtrackr_tpu/kernels/histpdf.py:123 (with "
                     "headtrackr_tpu/models/camshift.py:574, :577)",
                 "meanshift": "headtrackr_tpu/models/camshift.py:265",
                 "pyramid": "headtrackr_tpu/ops/imageproc.py:49",
                 "cascade": "headtrackr_tpu/models/detector.py:261, :441",
                 "group": "headtrackr_tpu/models/detector.py:788",
                 "tick_epilogue": "headtrackr_tpu/models/facetracker.py:244",
                 "slot_gather": "headtrackr_tpu/runtime/serving.py:249"}
X4 = "histpdf_band x4 workload"  # its timing entry on X4/X7's own workload
# backproject_rect's timing entry at band x origins on the 8-pixel grid, as
# the serving path places them (its main entry: origins from -20 up)
BPR_GRID = "backproject_rect grid"
# phase_kernels' entries whose library call is torch.bincount
K1_RANDOM = "hist4096 random"  # hist4096 on uniform random bins
BINCOUNT = ("hist4096", K1_RANDOM, "histpdf_band_hist")
# take_along's extra timing entries: the full-frame planes, X8's workload
TA_EXTRA = {"frame": "take_along frame", "x8_workload": "take_along x8"}
# meanshift's timing entries: the headline's 96x128 band (its main entry),
# the 240x320 frame, DEFAULT_BAND, the frame at N=1 and 128 streams of
# 480x640 frames
MS_ENTRIES = ("meanshift", "meanshift frame", "meanshift default_band",
              "meanshift n1", "meanshift 480x640")
MS_BIG = 128  # streams of the 480x640 case
MESH_SHARDS = 4  # phase 11 (b): shards on the one card
MESH_STEADY_TICKS = 32  # phase 11: all-CS ticks a timed turn
GATE_FRAMES = 60  # phase 12: tracked frames a clip
GATE_SIZES = ((240, 320), (480, 640))
# phase 13: bench_torch.py's arms, each a run of its own on the card
BENCH_TICKS = 64
BENCH_ARMS = {
    "headline": ["--h2d", "--latency-ticks", "20"],
    "face-noise-20": ["--face-noise", "20", "--no-exact-arm"],
    "640x480": ["--size", "640x480", "--streams", "128", "--no-exact-arm"],
}
BENCH_KEYS = ("metric", "value", "unit", "exact_value", "cold_start_value",
              "cold_start_unit", "latency_p50_ms", "latency_p99_ms",
              "h2d_value", "locked", "relocks", "redetects", "escapes",
              "device", "vs_limit", "launches")

SCHED_K = 16  # phase 15: ticks a run_scan
SCHED_LOSSES = (4, 20)  # streams lost before a bucket tick, a chunk tick
SCHED_ESCAPES = (12, 3)  # streams whose face outgrows the band: many, few
# the select kernels' random vectors and timings: one CTA, the 4,096
# streams one CTA once took, the headline past it, the grid's widest
SCHED_NS = (N_STREAMS, 4096, 10240, 65536)
# the headline run past 4,096 streams: the pool's 256 streams tiled 40
# times on the card, run_scan calls of SCHED_BIG_K ticks, SCHED_BIG_TICKS
# from init_state (the cold start's 16, then pool batches 4.. with the
# loss batch at tick 20); under "full" SCHED_BIG_LOSS streams of 256 lose
# track at tick 20 (past chunk_cap at 256 streams too, so that both sizes
# take the full tick)
SCHED_BIG = 10240
SCHED_BIG_K = 4
SCHED_BIG_TICKS = 28
SCHED_BIG_LOSS = 36
SCHED_EB = 8  # escape_bucket (the default)
# many escape ticks (the windows of E streams made TALL rows high, taller
# than the band) at 256 streams (E = 12 and every stream: one chunk each)
# and at SCHED_BIG (E = 12, 100: one chunk; 300: a big chunk and two small
# ones; 1,000: four big chunks)
SCHED_MANY = (12, N_STREAMS)
SCHED_BIG_MANY = (12, 100, 300, 1000)
# and at 256 streams with big chunks of 64 and small ones of 16: E = 150
# runs two of each, every stream four big ones
SCHED_CHUNKS = (64, 16)
SCHED_CHUNKED_MANY = (150, N_STREAMS)
TALL = 120
SCHED_KERNELS = ("tick_select", "escape_select", "scan_step", "scan_commit")
# phase 16 (F32): the kernels and the serving program past the 65,535
# streams a launch's grid takes (tools/torch_f32_cases.py), 160x120 frames
F32_N = 70000
F32_TICKS = 20  # from init_state: 15 wbtrack, the full tick, all-CS ticks
F32_K = 2  # the last ticks as one run_scan
F32_SPLIT = ("hist4096", "histpdf_band_hist", "histpdf_band", "backproject",
             "backproject_rect", "backproject_ratio", "backproject_rect_ratio",
             "hist_mma", "pyramid", "cascade")
# the program's path at 160x120 (no band; hist_mma the default histogram)
F32_PATH = ("hist_mma", "backproject_ratio", "meanshift", "pyramid", "cascade",
            "group", "tick_epilogue", "tick_select", "scan_commit",
            "frame_prep", "handoff")

def log(msg):
    print(msg, flush=True)


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20):
    import torch
    for _ in range(3):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def launches_of(key, fn):
    """The launches of kernel ``key`` one eager call of fn makes: the
    wrappers' count (kernels/launch.py), read before and after it."""
    import torch
    from headtrackr_tpu_torch.kernels import launch as L
    before = L.launches[key]
    fn()
    torch.cuda.synchronize()
    return L.launches[key] - before


def graph_ms(fn, reps=20):
    """Device time of one call of fn: ``reps`` calls captured in a CUDA
    graph and replayed, timed with events.  Replay has no host enqueue
    time, which back-to-back event timing of a ~30 us kernel also
    measures.  fn must not synchronize (the kernels' wrappers do not)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def library_times(lib, capturable):
    """{library_ms: events, library_graph_ms: graph replay} of a library
    call, the graph time None where the call reads the card from the host
    (torch.bincount sizes its output by its max), which a graph cannot
    capture."""
    return {"library_ms": cuda_ms(lib),
            "library_graph_ms": graph_ms(lib) if capturable else None}


def fmt_ms(x):
    return "not capturable" if x is None else f"{x:.4f} ms"


def interleaved_ms(kernel, plain):
    """plain, kernel, kernel, plain on one card: (kernel ms, plain ms)."""
    p1 = cuda_ms(plain)
    k1 = cuda_ms(kernel)
    k2 = cuda_ms(kernel)
    p2 = cuda_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(nbytes, ops):
    """The least time for the work: (ms, "bytes" | "operations")."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = ops / F32_OPS_PER_S
    return (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations")


def given_bins(frames, rects):
    """The per-stream-offset bins (bin + 4096 n) of each [x, y, w, h] rect's
    pixels: what a single torch.bincount needs to count the rects."""
    import torch
    from headtrackr_tpu_torch.ops.histogram import rgb_bins
    N, dev = frames.shape[0], frames.device
    rows = torch.arange(H, device=dev).view(1, H, 1)
    cols = torch.arange(W, device=dev).view(1, 1, W)
    r = rects.to(torch.int64).view(N, 4, 1, 1)
    inside = ((rows >= r[:, 1]) & (rows < r[:, 1] + r[:, 3]) &
              (cols >= r[:, 0]) & (cols < r[:, 0] + r[:, 2]))
    flat = rgb_bins(frames).long() + 4096 * torch.arange(
        N, device=dev).view(N, 1, 1)
    return flat[inside]


def bin_frames(bins):
    """(..., H, W) bins -> u8 RGB whose bins they are."""
    import torch
    b = bins.to(torch.int32)
    rgb = torch.stack([(b >> 8) << 4, ((b >> 4) & 15) << 4, (b & 15) << 4], -1)
    return rgb.to(torch.uint8)


def cluster_rects(n, shape, g, dev):
    """Full-frame rects; boxes partly outside the frame; rects of zero
    width or height, or wholly off the frame."""
    import torch
    from headtrackr_tpu_torch.ops.histogram import full_rects
    sh, sw = shape
    boxes = torch.cat([torch.randint(-sw // 2, sw, (n, 1), generator=g),
                       torch.randint(-sh // 2, sh, (n, 1), generator=g),
                       torch.randint(1, sw + 1, (n, 1), generator=g),
                       torch.randint(1, sh + 1, (n, 1), generator=g)],
                      1).to(torch.int32)
    empty = boxes.clone()
    empty[0::3, 2] = 0
    empty[1::3, 3] = 0
    empty[2::3, 0] = sw + 3
    return full_rects(n, shape, dev), boxes.to(dev), empty.to(dev)


def placed(windows, band, shape):
    """The band rects (N, 4) i32 that models/camshift.py band_rect places
    around search windows: the rects form the band kernels took before
    they placed their bands themselves, which their twins read."""
    from headtrackr_tpu_torch.models import camshift as cs
    return cs.band_rects(*cs.band_rect(windows, band, shape))


def clip_windows(n, shape, g, dev):
    """n search windows (N, 4) i32 over an (h, w) frame that hit every clip
    of the band placement: x or y below 0, past the right or bottom edge,
    negative and odd sizes (floor_div2), the whole frame and beyond."""
    import torch
    sh, sw = shape
    w = torch.cat([torch.randint(-60, sw + 60, (n, 1), generator=g),
                   torch.randint(-60, sh + 60, (n, 1), generator=g),
                   torch.randint(-41, 200, (n, 2), generator=g)], 1)
    fixed = torch.tensor([[-30, -25, 7, 9], [sw + 9, sh + 11, -3, -5],
                          [sw - 3, 4, 41, 17], [5, sh - 2, -7, 33],
                          [-1, -1, -1, -1], [0, 0, sw, sh], [sw, sh, 0, 0],
                          [-sw, -sh, 2 * sw + 1, 2 * sh + 1]])
    k = min(n, len(fixed))
    w[:k] = fixed[:k]
    return w.to(torch.int32).to(dev)


def ratio_tables(n, g, dev):
    """(model, cur) (n, 4096) f32 on ``dev`` hitting every case of the
    ratio weight min(model / cur, 1): cur == 0 with a model bin absent
    from the frame (model > 0) and without, model > cur (clamped to 1),
    model == cur, model 0, fractional counts."""
    import torch
    cur = torch.randint(0, 6, (n, 4096), generator=g).float()
    model = torch.randint(0, 12, (n, 4096), generator=g).float()
    cur[:, 0::7] = 0
    model[:, 1::11] = cur[:, 1::11]
    model[:, 3::17] = 0.75
    cur[:, 3::17] = 3.0
    return model.to(dev), cur.to(dev)


def phase_kernels(pools, dev):
    import torch
    from headtrackr_tpu_torch.kernels import histpdf as K
    from headtrackr_tpu_torch.ops import histogram as hg

    N, (bh, bw) = N_STREAMS, BAND
    g = torch.Generator().manual_seed(7)
    inputs = {f"face_noise={k}": torch.as_tensor(p[1]).to(dev)
              for k, p in pools.items()}
    inputs["random"] = torch.randint(0, 256, (N, H, W, 3), generator=g,
                                     dtype=torch.uint8).to(dev)
    full = hg.full_rects(N, (H, W), dev)
    boxes = torch.cat([torch.randint(-20, 300, (N, 2), generator=g),
                       torch.randint(0, 120, (N, 2), generator=g)],
                      1).to(torch.int32).to(dev)
    bands = torch.cat([torch.randint(-20, W - bw + 20, (N, 1), generator=g),
                       torch.randint(-20, H - bh + 20, (N, 1), generator=g),
                       torch.full((N, 1), bw), torch.full((N, 1), bh)],
                      1).to(torch.int32).to(dev)
    err = dict.fromkeys(KERNELS, 0.0)

    def check(name, got, want):
        torch.cuda.synchronize()
        e = float((got - want).abs().max()) if got.numel() else 0.0
        err[name] = max(err[name], e)

    for fr in inputs.values():
        for rects in (full, boxes):
            check("hist4096", K.hist4096(fr, rects),
                  hg.hist4096_plain(fr, rects).float())
            check("histpdf_band_hist", K.histpdf_band(fr, rects),
                  hg.histpdf_band_plain(fr, rects))
        model = K.histpdf_band(fr, boxes)
        # the band kernels take the windows ``bands`` and place each band;
        # held against the rects form (the twin at band_rect's rects)
        rects = placed(bands, BAND, (H, W))
        for w in (hg.backprojection_weights(model, K.hist4096(fr, full)),
                  torch.rand((N, 4096), generator=g).to(dev)):
            check("backproject", K.backproject(fr, w),
                  hg.backproject_plain(fr, w))
            check("backproject_rect", K.backproject(fr, w, bands, BAND),
                  hg.backproject_plain(fr, w, rects, BAND))
        for m in (model, torch.randint(1, 200, (N, 4096), generator=g)
                  .float().to(dev)):
            got = K.histpdf_band(fr, bands, m, BAND)
            want = hg.histpdf_band_plain(fr, rects, m, BAND)
            for a, b in zip(got, want):
                check("histpdf_band", a, b)
        # the ratio forms against their twins run on the card: the model
        # of a detection box against the frame's counts, and tables with
        # zero counts, clamped, equal and absent bins; N = 256, 8 and 1
        for m, c in ((model, K.hist4096(fr)), ratio_tables(N, g, dev)):
            for n in (N, 8, 1):
                check("backproject_ratio",
                      K.backproject_ratio(fr[:n], m[:n], c[:n]),
                      hg.backproject_ratio_plain(fr[:n], m[:n], c[:n]))
                check("backproject_rect_ratio",
                      K.backproject_ratio(fr[:n], m[:n], c[:n], bands[:n],
                                          BAND),
                      hg.backproject_ratio_plain(fr[:n], m[:n], c[:n],
                                                 rects[:n], BAND))
    # and against the placed twins, the wrappers' own CPU path (band_rect
    # on the CPU), on the bench faces
    fr, cpu = inputs["face_noise=0"], torch.device("cpu")
    w = torch.rand((N, 4096), generator=g)
    m = torch.randint(1, 200, (N, 4096), generator=g).float()
    check("backproject_rect", K.backproject(fr, w.to(dev), bands, BAND).cpu(),
          K.backproject(fr.to(cpu), w, bands.to(cpu), BAND))
    m, c = (t.cpu() for t in ratio_tables(N, g, dev))
    check("backproject_ratio",
          K.backproject_ratio(fr, m.to(dev), c.to(dev)).cpu(),
          K.backproject_ratio(fr.to(cpu), m, c))
    check("backproject_rect_ratio",
          K.backproject_ratio(fr, m.to(dev), c.to(dev), bands, BAND).cpu(),
          K.backproject_ratio(fr.to(cpu), m, c, bands.to(cpu), BAND))
    for a, b in zip(K.histpdf_band(fr, bands, m.to(dev), BAND),
                    K.histpdf_band(fr.to(cpu), bands.to(cpu), m, BAND)):
        check("histpdf_band", a.cpu(), b)
    # the TPU experiments' own workload: every pixel of the frame, random
    # bins, a model of integers 1..199 (tools/kernel_experiments.py:44-46)
    x4_frames = bin_frames(torch.randint(0, 4096, (N, H, W), generator=g)).to(dev)
    x4_model = torch.randint(1, 200, (N, 4096), generator=g).float().to(dev)
    got = K.histpdf_band(x4_frames, full, x4_model, (H, W))
    want = hg.histpdf_band_plain(x4_frames, full, x4_model, (H, W))
    for a, b in zip(got, want):
        check("histpdf_band", a, b)
    # backproject_rect's and histpdf_band's placement at every clip: windows
    # below 0, past the right and bottom edges, negative and odd sizes;
    # windows of the band's size on the 8-pixel grid (the serving path's
    # 4-pixel loop); odd band widths (origins clipped off the grid), the
    # whole frame, a band as wide as the frame, and a 57x99 frame;
    # histpdf_band also at N = 1 and 3
    on_grid = bands.clone()
    on_grid[:, 0] = bands[:, 0].clamp(0, W - bw) // 8 * 8
    w = torch.rand((N, 4096), generator=g).to(dev)
    m = torch.randint(0, 200, (N, 4096), generator=g).float().to(dev)
    wins = {(H, W): clip_windows(N, (H, W), g, dev),
            (57, 99): clip_windows(N, (57, 99), g, dev)}
    for fr in (inputs["random"], inputs["face_noise=0"], inputs["face_noise=20"]):
        for shape, windows, band in (
                ((H, W), wins[H, W], BAND), ((H, W), on_grid, BAND),
                ((H, W), wins[H, W], (bh - 1, bw - 1)),
                ((H, W), wins[H, W], (bh, bw + 3)),
                ((H, W), wins[H, W], (H, W)), ((H, W), wins[H, W], (bh, W)),
                ((57, 99), wins[57, 99], (40, 64)),
                ((57, 99), wins[57, 99], (33, 99))):
            f = fr[:, :shape[0], :shape[1]].contiguous()
            rects = placed(windows, band, shape)
            check("backproject_rect", K.backproject(f, w, windows, band),
                  hg.backproject_plain(f, w, rects, band))
            for n in (N, 1, 3):
                got = K.histpdf_band(f[:n], windows[:n], m[:n], band)
                want = hg.histpdf_band_plain(f[:n], rects[:n], m[:n], band)
                for a, b in zip(got, want):
                    check("histpdf_band", a, b)
    # the cluster histogram's edges (hist4096 and histpdf_band's hist-only
    # mode): the bench pool, uniform random bytes, uniform random bins and
    # one bin, over 240x320, 241x320 (a row more than the split), 57x99
    # and 8x8 frames (rows off the 16-byte grid, fewer pixels than a CTA);
    # N = 256, 1, 2 and 3; full rects, boxes partly outside, rects of zero
    # size; and frames one byte off the 16-byte boundary
    kinds = {"bench": inputs["face_noise=20"], "random": inputs["random"],
             "random_bins": x4_frames,
             "one_bin": torch.tensor([120, 100, 90], dtype=torch.uint8).to(
                 dev).expand(N, H, W, 3).contiguous()}
    for shape in ((H, W), (H + 1, W), (57, 99), (8, 8)):
        sh, sw = shape
        for kind, fr in kinds.items():
            fr = (torch.cat([fr, fr[:, -1:]], 1) if sh > H
                  else fr[:, :sh, :sw].contiguous())
            for rects in cluster_rects(N, shape, g, dev):
                for n in (N, 1, 2, 3):
                    want = hg.hist4096_plain(fr[:n], rects[:n]).float()
                    check("hist4096", K.hist4096(fr[:n], rects[:n]), want)
                    check("histpdf_band_hist",
                          K.histpdf_band(fr[:n], rects[:n]), want)
                off = torch.empty(3 * sh * sw * 3 + 1, dtype=torch.uint8,
                                  device=dev)[1:].view(3, sh, sw, 3)
                off.copy_(fr[:3])
                check("hist4096", K.hist4096(off, rects[:3]),
                      hg.hist4096_plain(fr[:3], rects[:3]).float())
    for name, e in err.items():
        if e != 0.0:
            raise AssertionError(f"{name} differs from its plain twin: "
                                 f"max abs err {e}")
    log(f"kernels: bit-equal to their plain twins (backproject_ratio over "
        f"the frame and the band also at N=8 and 1, and on tables with "
        f"zero counts, clamped, equal and absent bins), backproject_rect and "
        f"histpdf_band (each placing its bands from the windows) to the "
        f"rects form at band_rect's rects and to their CPU twins, also on "
        f"windows at every clip of the placement, on the 8-pixel grid, odd "
        f"band widths, the whole frame, a band as wide as the frame and a "
        f"57x99 frame (histpdf_band at N=256, 1 and 3), "
        f"hist4096 and histpdf_band_hist also on bench, random, random-bin "
        f"and one-bin frames of 240x320, 241x320, 57x99 and 8x8 at N=256, "
        f"1, 2 and 3, full rects, boxes and empty rects, and frames off the "
        f"16-byte boundary (max abs err {err})")

    # times at the main path's shapes, face_noise=0 frames
    fr = inputs["face_noise=0"]
    model = K.histpdf_band(fr, boxes)
    cur_full = K.hist4096(fr, full)
    w = hg.backprojection_weights(model, cur_full)
    bins_full = hg.rgb_bins(fr).view(N, -1).long()
    rects, rects_grid = placed(bands, BAND, (H, W)), placed(on_grid, BAND,
                                                              (H, W))
    bins_band = hg.band_bins(fr, rects, BAND).view(N, -1)
    bins_grid = hg.band_bins(fr, rects_grid, BAND).view(N, -1)
    given_full, given_box = given_bins(fr, full), given_bins(fr, boxes)
    npx_band, npx_full = N * bh * bw, N * H * W
    npx_box = given_box.numel()
    x4_bins = hg.rgb_bins(x4_frames).view(N, -1).long()
    x4_w = hg.backprojection_weights(x4_model, K.hist4096(x4_frames, full))
    # name -> (kernel call, plain twin call, library call given bins,
    #          bytes moved, operations); the gathers replay from a graph,
    #          bincount does not (library_times)
    given_x4 = given_bins(x4_frames, full)
    calls = {
        "hist4096": (
            lambda: K.hist4096(fr, full), lambda: hg.hist4096_plain(fr, full),
            lambda: torch.bincount(given_full, minlength=N * 4096),
            3 * npx_full + 16 * N + 4 * 4096 * N, 6 * npx_full),
        K1_RANDOM: (
            lambda: K.hist4096(x4_frames, full),
            lambda: hg.hist4096_plain(x4_frames, full),
            lambda: torch.bincount(given_x4, minlength=N * 4096),
            3 * npx_full + 16 * N + 4 * 4096 * N, 6 * npx_full),
        "backproject": (
            lambda: K.backproject(fr, w), lambda: hg.backproject_plain(fr, w),
            lambda: torch.gather(w, 1, bins_full),
            7 * npx_full + 4 * 4096 * N, 6 * npx_full),
        "backproject_rect": (
            lambda: K.backproject(fr, w, bands, BAND),
            lambda: hg.backproject_plain(fr, w, rects, BAND),
            lambda: torch.gather(w, 1, bins_band),
            7 * npx_band + 16 * N + 4 * 4096 * N, 6 * npx_band),
        "backproject_ratio": (
            lambda: K.backproject_ratio(fr, model, cur_full),
            lambda: hg.backproject_ratio_plain(fr, model, cur_full),
            lambda: torch.gather(w, 1, bins_full),
            7 * npx_full + 8 * 4096 * N, 6 * npx_full + 3 * 4096 * N),
        "backproject_rect_ratio": (
            lambda: K.backproject_ratio(fr, model, cur_full, bands, BAND),
            lambda: hg.backproject_ratio_plain(fr, model, cur_full, rects,
                                               BAND),
            lambda: torch.gather(w, 1, bins_band),
            7 * npx_band + 16 * N + 8 * 4096 * N,
            6 * npx_band + 3 * 4096 * N),
        BPR_GRID: (
            lambda: K.backproject(fr, w, on_grid, BAND),
            lambda: hg.backproject_plain(fr, w, rects_grid, BAND),
            lambda: torch.gather(w, 1, bins_grid),
            7 * npx_band + 16 * N + 4 * 4096 * N, 6 * npx_band),
        "histpdf_band": (
            lambda: K.histpdf_band(fr, bands, model, BAND),
            lambda: hg.histpdf_band_plain(fr, rects, model, BAND),
            lambda: torch.gather(w, 1, bins_band),
            7 * npx_band + 16 * N + 8 * 4096 * N, 7 * npx_band + 3 * 4096 * N),
        "histpdf_band_hist": (
            lambda: K.histpdf_band(fr, boxes),
            lambda: hg.histpdf_band_plain(fr, boxes),
            lambda: torch.bincount(given_box, minlength=N * 4096),
            3 * npx_box + 16 * N + 4 * 4096 * N, 6 * npx_box),
        X4: (
            lambda: K.histpdf_band(x4_frames, full, x4_model, (H, W)),
            lambda: hg.histpdf_band_plain(x4_frames, full, x4_model, (H, W)),
            lambda: torch.gather(x4_w, 1, x4_bins),
            7 * npx_full + 16 * N + 8 * 4096 * N, 7 * npx_full + 3 * 4096 * N),
    }
    t = {}
    for name, (kern, plain, lib, nbytes, ops) in calls.items():
        ms, plain_ms = interleaved_ms(kern, plain)
        b, by = bound(nbytes, ops)
        t[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                       graph_ms=graph_ms(kern),
                       **library_times(lib, name not in BINCOUNT))
        log(f"kernels: {name} {ms:.4f} ms, graph replay "
            f"{t[name]['graph_ms']:.4f} ms (plain {plain_ms:.4f} ms, bound "
            f"{b:.4f} ms, given-bins library call {t[name]['library_ms']:.4f} "
            f"ms, graph replay {fmt_ms(t[name]['library_graph_ms'])})")
    return err, t


def phase_gather(dev):
    """take_along against its twin, bit-equal, on X8's own workload and on
    mean shift's prefix-sum planes; then its times.  Returns (max abs err,
    timing entries)."""
    import torch
    import torch.nn.functional as F
    from headtrackr_tpu_torch.kernels.gather import take_along
    from headtrackr_tpu_torch.ops.gather import take_along_plain

    N = N_STREAMS
    g = torch.Generator().manual_seed(11)

    def planes(h, w):
        """One mean-shift iteration's two selections: rows [y0, y1] of the
        column prefix sums, columns [x0, x1] of the row prefix sums."""
        pdf = torch.rand((N, h, w), generator=g)
        col = F.pad(torch.cumsum(pdf, 1), (0, 0, 1, 0))
        row = F.pad(torch.cumsum(pdf, 2), (1, 0))
        ys = torch.randint(0, h + 1, (N, 2), generator=g).sort(1).values
        xs = torch.randint(0, w + 1, (N, 2), generator=g).sort(1).values
        return [(col.to(dev), ys.int().view(N, 2, 1).to(dev), 1),
                (row.to(dev), xs.int().view(N, 1, 2).to(dev), 2)]

    x8 = [(torch.rand((1, 8, 128), generator=g).to(dev),
           torch.randint(0, 128, (1, 8, 128), generator=g,
                         dtype=torch.int32).to(dev), 2)]
    cases = {"take_along": planes(*BAND), TA_EXTRA["frame"]: planes(H, W),
             TA_EXTRA["x8_workload"]: x8}
    err = 0.0
    for calls in cases.values():
        for src, idx, dim in calls:
            got, want = take_along(src, idx, dim), take_along_plain(src, idx,
                                                                    dim)
            torch.cuda.synchronize()
            err = max(err, float((got - want).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(f"take_along differs from its twin: "
                                     f"{tuple(src.shape)} dim {dim}")
    log(f"kernels: take_along bit-equal to its twin on X8's workload and "
        f"the band and frame planes (max abs err {err})")
    t = {}
    for name, calls in cases.items():
        shapes = [take_along_plain(*c).shape for c in calls]
        lib_idx = [idx.long().expand(sh) for (_, idx, _), sh
                   in zip(calls, shapes)]
        # each output written once, its source element and index read once
        nbytes = sum(8 * sh.numel() + 4 * idx.numel()
                     for (_, idx, _), sh in zip(calls, shapes))

        def kern(calls=calls):
            return [take_along(*c) for c in calls]

        def plain(calls=calls):
            return [take_along_plain(*c) for c in calls]

        def lib(calls=calls, lib_idx=lib_idx):
            return [torch.gather(src, dim, li)
                    for (src, _, dim), li in zip(calls, lib_idx)]

        ms, plain_ms = interleaved_ms(kern, plain)
        b, by = bound(nbytes, 0)
        t[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                       graph_ms=graph_ms(kern), launches_per_call=len(calls),
                       **library_times(lib, True))
        log(f"kernels: {name} ({len(calls)} launches) {ms:.4f} ms, graph "
            f"replay {t[name]['graph_ms']:.4f} ms (plain {plain_ms:.4f} ms, "
            f"bound {b:.6f} ms, torch.gather {t[name]['library_ms']:.4f} ms, "
            f"graph replay {fmt_ms(t[name]['library_graph_ms'])})")
    return err, t


def face_boxes(frames):
    """(N, 4) i32 [x, y, w, h]: the box of each stream's pixels that are not
    the bench pool's background, in (N, H, W, 3) u8 frames (a pool batch
    before the loss frame: each stream's face, a detection box)."""
    import numpy as np
    from bench import _BG
    fg = (frames != np.array(_BG, np.uint8)).any(-1)
    rows, cols = fg.any(2), fg.any(1)
    y0, y1 = rows.argmax(1), H - rows[:, ::-1].argmax(1)
    x0, x1 = cols.argmax(1), W - cols[:, ::-1].argmax(1)
    return np.stack([x0, y0, x1 - x0, y1 - y0], 1).astype(np.int32)


def meanshift_ops(pdf, win, ry, rx, frame):
    """The f32 operations this run's data needs, iteration by iteration
    from the twin's windows (one more iteration each run): 5 a pixel of a
    stream's window in each iteration it runs (m00, m10, m01), and 9 a
    pixel of its stopping window (m11, m20, m02).  frame: (H, W)."""
    import torch
    from headtrackr_tpu_torch.ops import meanshift as om
    n, bh, bw = pdf.shape
    H, W = frame
    zero = torch.zeros((n,), dtype=torch.int32, device=pdf.device)
    oy, ox = (zero, zero) if ry is None else (ry, rx)

    def area(w):
        x0, y0 = w[:, 0].clamp(min=0), w[:, 1].clamp(min=0)
        x1, y1 = (x0 + w[:, 2]).clamp(max=W), (y0 + w[:, 3]).clamp(max=H)
        dx = (x1 - ox).clamp(0, bw) - (x0 - ox).clamp(0, bw)
        dy = (y1 - oy).clamp(0, bh) - (y0 - oy).clamp(0, bh)
        return dx.clamp(min=0).long() * dy.clamp(min=0).long()

    iters, ops = om.MEANSHIFT_ITERS, 0
    prev, done = win, torch.zeros((n,), dtype=torch.bool, device=pdf.device)
    try:
        for k in range(1, iters + 1):
            om.MEANSHIFT_ITERS = k
            cur = om.mean_shift_plain(pdf, win, ry, rx, frame)[0]
            a = area(prev)
            moved = (cur[:, :2] != prev[:, :2]).any(1)
            stop = ~done & (~moved | (k == iters))
            ops += int((5 * a)[~done].sum()) + int((9 * a)[stop].sum())
            done |= ~moved
            prev = cur
    finally:
        om.MEANSHIFT_ITERS = iters
    return ops


def phase_meanshift(pools, dev):
    """meanshift against its twin run on the card and its twin run on the
    CPU, bit-equal (tolerance 0).  Inputs as the serving path makes them
    from the bench pools (face_noise 0 and 20): each stream's face box as
    its window, its model histogram from the pool's first batch, then the
    pdf of batch 1 (tracking) and of the loss batch (zero mass on the loss
    streams) through histpdf_band at the 96x128 band and at DEFAULT_BAND
    (128x192), each band placed around the window it is walked from, and
    through backproject over the 240x320 frame, and 128 of those frame
    pdfs upsampled 2x to 480x640 (windows doubled); plus windows that
    escape the band (larger than it), moved, lie partly off the frame, or
    are empty, and N=1.  The kernel places each band from the window
    itself: it is held against the twin's origins form on the card (the
    origins band_rect gives) and against the wrapper's placed twin on the
    CPU.  Then its times beside its twin's and its bound, and the kernel
    route picked; no PyTorch call computes its function.  Returns (max abs
    err, timing entries)."""
    import torch
    from headtrackr_tpu_torch.kernels import histpdf as K
    from headtrackr_tpu_torch.kernels import meanshift as kms
    from headtrackr_tpu_torch.kernels.meanshift import mean_shift
    from headtrackr_tpu_torch.models import camshift as cs
    from headtrackr_tpu_torch.ops import histogram as hg
    from headtrackr_tpu_torch.ops import meanshift as om

    N = N_STREAMS
    cpu = torch.device("cpu")
    full = hg.full_rects(N, (H, W), dev)
    cases = {}  # name -> (pdf, window, ry, rx) on the card

    def band_pdf(fr, win, model, band):  # the pdf and its origins
        ry, rx, _, _ = cs.band_rect(win, band, (H, W))
        _, pdf = K.histpdf_band(fr, win, model, band)
        return pdf, ry, rx

    for k, pool in pools.items():
        boxes = torch.as_tensor(face_boxes(pool[0])).to(dev)
        model = K.histpdf_band(torch.as_tensor(pool[0]).to(dev), boxes)
        for t in (1, LOSS_AT):
            fr = torch.as_tensor(pool[t]).to(dev)
            for band in (BAND, cs.DEFAULT_BAND):
                pdf, ry, rx = band_pdf(fr, boxes, model, band)
                cases[f"face_noise={k} t={t} {band[0]}x{band[1]}"] = (
                    pdf, boxes, ry, rx)
            w = hg.backprojection_weights(model, K.hist4096(fr, full))
            cases[f"face_noise={k} t={t} frame"] = (K.backproject(fr, w),
                                                   boxes, None, None)
    boxes = cases[f"face_noise=0 t=1 {BAND[0]}x{BAND[1]}"][1]
    q = N // 4
    model = K.histpdf_band(torch.as_tensor(pools[0][0]).to(dev), boxes)
    fr1 = torch.as_tensor(pools[0][1]).to(dev)
    odd = boxes.clone()
    odd[:q, 2:] = torch.tensor([150, 110], dtype=torch.int32)  # > the band
    odd[q:2 * q, 0] += 80  # moved off the face
    odd[2 * q:3 * q, 2] = 0  # empty
    pdf, ry, rx = band_pdf(fr1, odd, model, BAND)
    cases["escaping and empty windows"] = (pdf, odd, ry, rx)
    edge = boxes.clone()
    edge[:q, :2] = torch.tensor([-20, -12], dtype=torch.int32)
    edge[q:2 * q, 0] = W - 20
    edge[2 * q:3 * q, 1] = H - 10
    pdf, ry, rx = band_pdf(fr1, edge, model, BAND)
    cases["windows partly off the frame"] = (pdf, edge, ry, rx)
    headline, frame = f"face_noise=0 t=1 {BAND[0]}x{BAND[1]}", \
        "face_noise=0 t=1 frame"
    cases["N=1 frame"] = tuple(None if v is None else v[:1]
                               for v in cases[frame])
    cases["N=1 band"] = tuple(v[:1] for v in cases[headline])
    big = "face_noise=0 t=1 480x640"
    pdf, boxes = cases[frame][:2]
    cases[big] = (pdf[:MS_BIG].repeat_interleave(2, 1).repeat_interleave(
        2, 2).contiguous(), 2 * boxes[:MS_BIG], None, None)

    def frame_of(pdf, ry):  # a band's frame, or the full-frame pdf's own
        return (H, W) if ry is not None else tuple(pdf.shape[1:])

    def bits(t):
        return torch.where(torch.isnan(t), 0, t.view(torch.int32))

    err, escaped, zero = 0.0, 0, 0
    card = kms.card(dev)
    for name, (pdf, win, ry, rx) in cases.items():
        got = mean_shift(pdf, win, frame_of(pdf, ry))
        torch.cuda.synchronize()
        escaped += int(got[3].sum())
        zero += int(got[2].sum())
        for where, want in (
                ("the card, origins form", om.mean_shift_plain(
                    pdf, win, ry, rx, frame_of(pdf, ry))),
                ("the CPU, placed", mean_shift(pdf.to(cpu), win.to(cpu),
                                               frame_of(pdf, ry)))):
            for label, a, b in (("window", got[0], want[0]),
                                ("zero_mass", got[2], want[2]),
                                ("escaped", got[3], want[3])):
                if not torch.equal(a.cpu(), b.cpu()):
                    raise AssertionError(f"meanshift differs from its twin "
                                         f"on {where}: {name}, {label}")
            for m in om.MOMENTS:
                a, b = got[1][m].cpu(), want[1][m].cpu()
                fin = torch.isfinite(a) & torch.isfinite(b)
                if fin.any():
                    err = max(err, float((a - b)[fin].abs().max()))
                if not (torch.equal(torch.isnan(a), torch.isnan(b))
                        and torch.equal(bits(a), bits(b))):
                    raise AssertionError(f"meanshift differs from its twin "
                                         f"on {where}: {name}, {m}")
    log(f"kernels: meanshift bit-equal to its twin run on the card and to "
        f"its twin run on the CPU on {len(cases)} inputs ({', '.join(cases)};"
        f" {escaped} escaped and {zero} zero-mass streams in all; max abs "
        f"err {err})")

    t = {}
    for name, key in zip(MS_ENTRIES, (headline, frame,
                                      "face_noise=0 t=1 128x192",
                                      "N=1 frame", big)):
        pdf, win, ry, rx = cases[key]
        n, bh, bw = pdf.shape
        fs = frame_of(pdf, ry)
        c = kms.route(n, bh, bw, card)
        kernel = {kms.ONE_CTA: "one CTA", kms.SCRATCH: "scratch"}.get(
            c, f"cluster of {c}")
        # the pdf and windows read once (the kernel places the band from
        # the window); windows, moments, flags written once
        nbytes = (4 * pdf.numel() + 16 * n
                  + (16 + 4 * len(om.MOMENTS) + 2) * n)
        b, by = bound(nbytes, meanshift_ops(pdf, win, ry, rx, fs))
        ms, plain_ms = interleaved_ms(
            lambda: mean_shift(pdf, win, fs),
            lambda: om.mean_shift_plain(pdf, win, ry, rx, fs))
        t[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                       graph_ms=graph_ms(lambda: mean_shift(pdf, win, fs)),
                       library_ms=None, library_graph_ms=None,
                       shape=list(pdf.shape), kernel=c)
        log(f"kernels: {name} {tuple(pdf.shape)} ({kernel}) {ms:.4f} ms, "
            f"graph replay {t[name]['graph_ms']:.4f} ms (plain "
            f"{plain_ms:.4f} ms, bound {b:.6f} ms by {by}; no PyTorch call "
            f"computes its function)")
    return err, t


def phase_histmma(pools, dev):
    """hist_mma against its twin, bit-equal (tolerance 0), at N=256 and
    N=1 on the bench pools, uniform random frames, one-bin frames and X6's
    own workload (every pixel of the frame, uniform random bins), with
    full-frame rects and random boxes; then its times.  Returns (max abs
    err, timing entries)."""
    import torch
    from headtrackr_tpu_torch.kernels.histmma import hist_mma
    from headtrackr_tpu_torch.kernels.histpdf import hist4096
    from headtrackr_tpu_torch.ops import histogram as hg

    N = N_STREAMS
    g = torch.Generator().manual_seed(13)
    inputs = {f"face_noise={k}": torch.as_tensor(p[1]).to(dev)
              for k, p in pools.items()}
    inputs["random"] = torch.randint(0, 256, (N, H, W, 3), generator=g,
                                     dtype=torch.uint8).to(dev)
    inputs["one_bin"] = torch.tensor([120, 100, 90], dtype=torch.uint8).to(
        dev).expand(N, H, W, 3).contiguous()
    # tools/kernel_experiments.py:44-46: uniform random bins over the frame
    inputs["x6_workload"] = bin_frames(torch.randint(
        0, 4096, (N, H, W), generator=g)).to(dev)
    full = hg.full_rects(N, (H, W), dev)
    boxes = torch.cat([torch.randint(-20, 300, (N, 2), generator=g),
                       torch.randint(0, 240, (N, 2), generator=g)],
                      1).to(torch.int32).to(dev)
    err = 0.0

    def check(name, fr, rects):
        nonlocal err
        got = hist_mma(fr, rects)
        want = hg.hist_mma_plain(fr, rects)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        err = max(err, e)
        if e != 0.0 or not torch.equal(got, hist4096(fr, rects)):
            raise AssertionError(f"hist_mma differs from its twin or "
                                 f"hist4096 on {name} at N={fr.shape[0]}: "
                                 f"max abs err {e}")

    for name, fr in inputs.items():
        for rects in (full, boxes):
            for n in (N, 1, 2, 3):
                check(name, fr[:n], rects[:n])
    # pixel counts off the 1,024-pixel stage and the 128-pixel tile: with
    # the bulk copies (241 x 320, 48 x 80) and without (57 x 99, and a
    # view one stream in)
    for shape in ((241, 320), (48, 80), (57, 99)):
        fr = torch.randint(0, 256, (4,) + shape + (3,), generator=g,
                           dtype=torch.uint8).to(dev)
        rects = torch.cat([hg.full_rects(1, shape, dev),
                           boxes[:3] % torch.tensor(
                               [shape[1], shape[0], 80, 80], device=dev,
                               dtype=torch.int32)])
        for n in (1, 2, 3):
            check(f"{shape}", fr[:n], rects[:n])
        check(f"{shape} view", fr[1:], rects[1:])
    log(f"kernels: hist_mma bit-equal to its twin (and to hist4096) on the "
        f"bench pools, random, one-bin and X6 frames, full frames and "
        f"boxes, N={N}, 1, 2 and 3, and on 241x320, 48x80 and 57x99 frames "
        f"(max abs err {err})")

    def entry(kern, plain, lib, n):
        """Times beside the histogram's bound, hist4096's: the bytes (frames
        and rects read, counts written) against the binning's f32 work (6
        a pixel).  Beside it, onehot_ms: the int8 tensor-core time of the
        dense one-hot product (2 x 4096 operations a pixel), which is
        hist_mma's formulation and not the function's least work."""
        npx = n * H * W
        b, by = bound(3 * npx + 16 * n + 4 * 4096 * n, 6 * npx)
        ms, plain_ms = interleaved_ms(kern, plain)
        return dict(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                    onehot_ms=1e3 * 2 * 4096 * npx / INT8_OPS_PER_S,
                    graph_ms=graph_ms(kern), **library_times(lib, False))

    t = {}
    for name, fr in (("hist_mma", inputs["face_noise=0"]),
                     ("hist_mma x6", inputs["x6_workload"])):
        given = given_bins(fr, full)
        t[name] = entry(lambda fr=fr: hist_mma(fr, full),
                        lambda fr=fr: hg.hist_mma_plain(fr, full),
                        lambda given=given: torch.bincount(
                            given, minlength=N * 4096), N)
    fr1, full1 = inputs["face_noise=0"][:1], full[:1]
    given1 = given_bins(fr1, full1)
    t["hist_mma n1"] = entry(lambda: hist_mma(fr1, full1),
                             lambda: hg.hist_mma_plain(fr1, full1),
                             lambda: torch.bincount(given1, minlength=4096),
                             1)
    t["hist4096 n1"] = entry(lambda: hist4096(fr1, full1),
                             lambda: hg.hist4096_plain(fr1, full1),
                             lambda: torch.bincount(given1, minlength=4096),
                             1)
    for name, e in t.items():
        log(f"kernels: {name} {e['ms']:.4f} ms, graph replay "
            f"{e['graph_ms']:.4f} ms (plain {e['plain_ms']:.4f} ms, bound "
            f"{e['bound_ms']:.6f} ms by {e['bound_by']}; the dense int8 "
            f"one-hot product {e['onehot_ms']:.4f} ms; torch.bincount "
            f"{e['library_ms']:.4f} ms, graph replay "
            f"{fmt_ms(e['library_graph_ms'])})")
    return err, t


def device_ops(fn):
    """The names of the device operations (kernels, memsets, copies) of one
    call of fn, as torch.profiler sees them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def phase_histbins(pools, dev):
    """hist_bins against its twin and against hist4096 of the full frame of
    the same pixels, bit-equal (tolerance 0), on X5's own workload and the
    others of the module docstring; one device operation a launch; then its
    times.  Returns (max abs err, timing entries)."""
    import numpy as np
    import torch
    from headtrackr_tpu_torch.kernels import launch as L
    from headtrackr_tpu_torch.kernels.histbins import (MAX_ROWS, hist_bins,
                                                       split_bins)
    from headtrackr_tpu_torch.kernels.histpdf import hist4096
    from headtrackr_tpu_torch.ops import histogram as hg

    N = N_STREAMS
    g = torch.Generator().manual_seed(23)
    # name -> (ids (n, P) i32, frames (n, fh, fw, 3) whose pixels' bins are
    # the valid ids)
    work = {}
    # tools/kernel_experiments.py:212: uniform random ids, (N, C, CH)
    x5 = torch.as_tensor(np.random.default_rng(0).integers(
        0, 4096, (N, 8, 9600)).astype(np.int32)).to(dev)
    work["x5_workload"] = (x5.view(N, -1), bin_frames(x5.view(N, H, W)))
    for k, p in pools.items():
        fr = torch.as_tensor(p[1]).to(dev)
        work[f"face_noise={k}"] = (hg.rgb_bins(fr).view(N, -1), fr)
    rnd = torch.randint(0, 256, (N, H, W, 3), generator=g,
                        dtype=torch.uint8).to(dev)
    work["random"] = (hg.rgb_bins(rnd).view(N, -1), rnd)
    one = torch.full((N, H * W), 1234, dtype=torch.int32, device=dev)
    work["one_bin"] = (one, bin_frames(one.view(N, H, W)))
    # 76,799 ids a row (P % 4 == 3), 64 of them out of range
    P, K = H * W - 1, 64
    pos = torch.randperm(P, generator=g)[:K].to(dev)
    bad = torch.tensor([-1, -64, 4096, 4097, 5000, 65535, 2 ** 31 - 1,
                        -2 ** 31], dtype=torch.int32).repeat(K // 8).to(dev)
    pfr = torch.randint(0, 256, (N, 1, P - K, 3), generator=g,
                        dtype=torch.uint8).to(dev)
    keep = torch.ones(P, dtype=torch.bool, device=dev)
    keep[pos] = False
    pads = torch.empty((N, P), dtype=torch.int32, device=dev)
    pads[:, keep] = hg.rgb_bins(pfr).view(N, -1)
    pads[:, ~keep] = bad
    work["pads_tail"] = (pads, pfr)
    work["pads_tail_view"] = (pads[1:], pfr[1:])  # rows off the 16 B boundary
    work["n1"] = (work["face_noise=0"][0][:1], work["face_noise=0"][1][:1])
    # more rows than a launch's grid takes: 65,537 rows of 16 ids
    big = torch.randint(0, 4096, (MAX_ROWS + 2, 16), generator=g,
                        dtype=torch.int32).to(dev)
    work["rows_65537"] = (big, bin_frames(big.view(-1, 4, 4)))
    err = 0.0
    for name, (ids, fr) in work.items():
        n, fh, fw = fr.shape[:3]
        before = L.launches["hist_bins"]
        got = hist_bins(ids)
        torch.cuda.synchronize()
        chunks = -(-n // MAX_ROWS)
        if L.launches["hist_bins"] != before + chunks:
            raise AssertionError(f"hist_bins on {name}: "
                                 f"{L.launches['hist_bins'] - before} "
                                 f"launches, not {chunks}")
        twin = hg.hist_bins_plain(ids)
        full = hg.full_rects(n, (fh, fw), dev)
        ref = torch.cat([hist4096(fr[r0:r0 + MAX_ROWS].contiguous(),
                                  full[r0:r0 + MAX_ROWS])
                         for r0 in range(0, n, MAX_ROWS)])
        torch.cuda.synchronize()
        e = max(float((got - twin).abs().max()), float((got - ref).abs().max()))
        err = max(err, e)
        if not (torch.equal(got, twin) and torch.equal(got, ref)):
            raise AssertionError(f"hist_bins differs from its twin or "
                                 f"hist4096 on {name}: max abs err {e}")
    log(f"kernels: hist_bins bit-equal to its twin and to hist4096 of the "
        f"same pixels on {', '.join(work)} (max abs err {err}), one launch "
        f"per {MAX_ROWS} rows")
    for key in ("x5_workload", "n1"):
        ops = device_ops(lambda ids=work[key][0]: hist_bins(ids))
        if len(ops) != 1 or "hist_bins_kernel" not in ops[0]:
            raise AssertionError(f"hist_bins on {key}: device operations "
                                 f"{ops}, not one kernel")
    log(f"kernels: hist_bins is one device operation a call (X5's workload "
        f"and N=1: {ops}; no memset, no cast)")

    t = {}
    for name, key in (("hist_bins", "x5_workload"),
                      ("hist_bins bench", "face_noise=0"),
                      ("hist_bins n1", "n1")):
        ids = work[key][0]
        n, p = ids.shape
        given = (ids.long() + 4096 * torch.arange(n, device=dev).view(n, 1)
                 ).view(-1)
        ms, plain_ms = interleaved_ms(lambda ids=ids: hist_bins(ids),
                                      lambda ids=ids: hg.hist_bins_plain(ids))
        # the ids read once, the f32 counts written once
        b, by = bound(4 * n * p + 4 * 4096 * n, 0)
        c = split_bins(n, p, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        t[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                       graph_ms=graph_ms(lambda ids=ids: hist_bins(ids)),
                       cluster=c,
                       **library_times(lambda given=given, n=n: torch.bincount(
                           given, minlength=n * 4096), False))
        log(f"kernels: {name} ({n} x {p} ids, C={c}) {ms:.4f} ms, graph "
            f"replay "
            f"{t[name]['graph_ms']:.4f} ms (plain {plain_ms:.4f} ms, bound "
            f"{b:.6f} ms by {by}, torch.bincount {t[name]['library_ms']:.4f} "
            f"ms, graph replay {fmt_ms(t[name]['library_graph_ms'])})")
    return err, t


def cascade_weak(buf, tables):
    """Weak classifiers the cascade evaluates on ``buf`` (this run's data:
    every window through the stages until it dies), by the twin's loop."""
    import torch
    from headtrackr_tpu_torch.ops import detect as od
    M = tables.M
    alive = torch.arange(buf.shape[0] * M, device=buf.device)
    weak = 0
    for stage in tables.stages:
        if alive.numel() == 0:
            break
        weak += alive.numel() * stage.alpha0.numel()
        sums = torch.cat([od._stage_sums(buf, tables, stage, a // M, a % M)
                          for a in torch.split(alive, 1 << 20)])
        alive = alive[sums >= stage.thresh]
    return weak


def face_tiles(n, dev):
    """n gray 240x320 frames tiled with the synthetic 24x24 face every 26
    px: the windows around each face pass the deep stages."""
    import numpy as np
    import torch
    from headtrackr_tpu_torch.cascade import DATA_DIR
    from headtrackr_tpu_torch.ops.imageproc import grayscale
    face = np.load(os.path.join(DATA_DIR, "synthface.npz"))["rgb"]
    rgb = np.full((H, W, 3), (120, 100, 90), np.uint8)
    for y in range(1, H - 24, 26):
        for x in range(1, W - 24, 26):
            rgb[y:y + 24, x:x + 24] = face
    gray = grayscale(torch.as_tensor(rgb).to(dev))
    return gray[None].repeat(n, 1, 1).contiguous()


def old_division_load(buf, tables):
    """The deep-stage work each warp of 32 windows held under the old
    division (the warp that found a dense survivor walked its deep stages),
    by the plain code: the dense survivors (the first two stages), each
    one's deep weak classifiers evaluated until it dies, summed by warp."""
    import torch
    from headtrackr_tpu_torch.ops import detect as od
    M = tables.M
    alive = torch.arange(buf.shape[0] * M, device=buf.device)
    weak = torch.zeros(buf.shape[0] * M, dtype=torch.int64,
                       device=buf.device)
    dense = None
    for s, stage in enumerate(tables.stages):
        if s == 2:
            dense = alive.clone()
        if alive.numel() == 0:
            break
        if s >= 2:
            weak[alive] += stage.alpha0.numel()
        sums = od._stage_sums(buf, tables, stage, alive // M, alive % M)
        alive = alive[sums >= stage.thresh]
    dense = alive if dense is None else dense
    warp = (dense // M) * (-(-M // 32)) + (dense % M) // 32
    held = torch.bincount(warp)
    held_weak = torch.bincount(warp, weights=weak[dense].double())
    busy = held_weak[held > 0]
    return dict(survivors=int(dense.numel()), warps=int((held > 0).sum()),
                most_survivors=int(held.max()) if held.numel() else 0,
                most_weak=int(busy.max()) if busy.numel() else 0,
                mean_weak=float(busy.mean()) if busy.numel() else 0.0,
                longest_chain=int(weak.max()))


def phase_detect(pools, dev, root):
    """Phase 3's detector kernels: pyramid, cascade and group against their
    twins (run on the card; at <= 8 streams also on the CPU), tolerance 0,
    candidates slot for slot; then their times at DETECT_NS streams."""
    import torch
    import torch.nn.functional as F
    from headtrackr_tpu_torch.cascade import frontalface, toy_cascade
    from headtrackr_tpu_torch.kernels.cascade import cascade
    from headtrackr_tpu_torch.kernels.group import group
    from headtrackr_tpu_torch.kernels.pyramid import pyramid
    from headtrackr_tpu_torch.models import detector as td
    from headtrackr_tpu_torch.ops import detect as od
    from headtrackr_tpu_torch.ops.imageproc import grayscale, pack_pyramid

    cpu = torch.device("cpu")
    cascades = {"real": frontalface(), "toy": toy_cascade()}
    tabs = {}

    def tables(cn, shape, d):
        key = (cn, shape, d)
        if key not in tabs:
            tabs[key] = td.detector_tables(shape[1], shape[0], cascades[cn],
                                           5, d)
        return tabs[key]

    keys = ("x", "y", "width", "height", "confidence", "valid")
    g = torch.Generator().manual_seed(13)
    grays = {f"face_noise={k}": grayscale(torch.as_tensor(p[1]).to(dev))
             for k, p in pools.items()}
    grays["random"] = torch.randint(0, 256, (N_STREAMS, H, W), generator=g,
                                    dtype=torch.uint8).to(dev)
    big = grays["face_noise=0"][:DETECT_BIG].repeat_interleave(
        2, 1).repeat_interleave(2, 2).contiguous()
    cases = [(f"{name} real N={n}", "real", gr[:n].contiguous(), 256)
             for name, gr in grays.items() for n in DETECT_NS]
    faces = face_tiles(N_STREAMS, dev)
    cases += [("faces real N=8", "real", faces[:8].contiguous(), 256),
              (f"faces real N={N_STREAMS}", "real", faces, 256),
              ("face_noise=0 toy N=8", "toy", grays["face_noise=0"][:8], 256),
              ("random toy N=8 (overflow)", "toy", grays["random"][:8], 256),
              ("random toy N=256 (overflow)", "toy", grays["random"], 256),
              ("face_noise=0 real N=8 C=1", "real",
               grays["face_noise=0"][:8], 1),
              (f"480x640 real N={DETECT_BIG}", "real", big, 256)]
    err = dict.fromkeys(DETECT, 0.0)
    survivors = {}
    ks = {}  # a case's k a stream: its last valid slot + 1

    def same(name, label, got, want):
        for a, b in zip(got, want):
            a, b = a.cpu(), b.cpu()
            if a.is_floating_point():
                fin = torch.isfinite(a) & torch.isfinite(b)
                if fin.any():
                    err[name] = max(err[name],
                                    float((a - b)[fin].abs().max()))
            if not torch.equal(a, b):
                raise AssertionError(f"{name} differs from its twin on "
                                     f"{label}")

    for label, cn, gray, cap in cases:
        shape = tuple(gray.shape[1:])
        tg = tables(cn, shape, dev)
        twins = [(tg, gray)]
        if gray.shape[0] <= 8:
            twins.append((tables(cn, shape, cpu), gray.cpu()))
        buf = pyramid(gray, tg)
        cand = cascade(buf, tg, cap)
        slots, best = group(*(cand[k] for k in keys), 1)
        for t, gr in twins:
            where = f"{label} (twin on the {gr.device.type})"
            want_buf = pack_pyramid(gr, 5, t.plane_keys, t.geom_levels)
            same("pyramid", where, [buf], [want_buf])
            want = od.cascade_plain(want_buf, t, cap)
            same("cascade", where, [cand[k] for k in want],
                 list(want.values()))
            ws, wb = od.group_plain(*(want[k] for k in keys), 1)
            same("group", where, [slots[k] for k in ws] + list(best),
                 list(ws.values()) + list(wb))
            w0s, w0b = od.group_plain(*(want[k] for k in keys), 0)
            s0, b0 = group(*(cand[k] for k in keys), 0)
            same("group", where + " min_neighbors 0",
                 [s0[k] for k in w0s] + list(b0), list(w0s.values())
                 + list(w0b))
        survivors[label] = (int(cand["valid"].sum()),
                            int(cand["overflow"].sum()),
                            int(best[0].sum()))
        ks[label] = last_slots(cand["valid"])
        if label == WORST_GROUP:
            worst = [cand[k] for k in keys]
        if "overflow" in label and not survivors[label][1] > 0:
            raise AssertionError(f"{label}: no survivor beyond the capacity")
    log(f"kernels: pyramid, cascade and group bit-equal to their twins "
        f"(candidates slot for slot, overflow equal) on {len(cases)} "
        f"inputs: " + "; ".join(f"{k}: {v[0]} kept, {v[1]} over, {v[2]} "
                                f"found" for k, v in survivors.items()))
    gcases = group_cases(root)
    for name, arrays in gcases.items():
        cpu_in = [torch.as_tensor(a) for a in arrays]
        dev_in = [a.to(dev) for a in cpu_in]
        for mn in (0, 1, 3):
            s, b = group(*dev_in, mn)
            for twin_in in (dev_in, cpu_in):
                ws, wb = od.group_plain(*twin_in, mn)
                same("group", f"{name} min_neighbors {mn} (twin on the "
                     f"{twin_in[0].device.type})",
                     [s[k] for k in ws] + list(b),
                     list(ws.values()) + list(wb))
    log(f"kernels: group bit-equal to its twin (card and CPU) on "
        f"{len(gcases)} adversarial slot sets at min_neighbors 0, 1 and 3: "
        f"{', '.join(gcases)}")
    relock = grayscale(torch.as_tensor(
        pools[0][LOSS_AT + 1, :LOSS_STREAMS]).to(dev))
    tg = tables("real", (H, W), dev)
    ks["relock bucket"] = last_slots(cascade(pyramid(relock, tg), tg,
                                             256)["valid"])
    k_pools = {"bench": f"face_noise=0 real N={N_STREAMS}",
               "face_noise=20": f"face_noise=20 real N={N_STREAMS}",
               "faces": f"faces real N={N_STREAMS}",
               "relock bucket": "relock bucket",
               "random toy (overflow)": WORST_GROUP}
    k_dist = {name: k_spread(ks[label]) for name, label in k_pools.items()}
    for name, d in k_dist.items():
        log(f"kernels: group's k on {name}: {d['streams']} streams, "
            f"{d['share_le_32']:.3f} at k <= 32 (warp 0 alone); k min "
            f"{d['min']}, median {d['median']}, max {d['max']}; by range "
            f"{d['by_range']}")

    for n in (8, N_STREAMS):
        tg = tables("real", (H, W), dev)
        load = old_division_load(pyramid(grays["face_noise=0"][:n]
                                         .contiguous(), tg), tg)
        log(f"kernels: cascade at N={n} on the bench pool under the old "
            f"division (a warp walked its own dense survivors' deep "
            f"stages): {load['survivors']} deep survivors in "
            f"{load['warps']} warps of 32 windows; the busiest warp held "
            f"{load['most_survivors']} of them and "
            f"{load['most_weak']} deep weak classifiers (mean over warps "
            f"with any: {load['mean_weak']:.1f}); the longest single chain "
            f"{load['longest_chain']}")

    def plain_vs(kern, plain):
        p1 = cuda_ms(plain, reps=5)
        k1 = cuda_ms(kern)
        k2 = cuda_ms(kern)
        p2 = cuda_ms(plain, reps=5)
        return (k1 + k2) / 2, (p1 + p2) / 2

    t = {}
    runs = [(n, (H, W), grays["face_noise=0"][:n].contiguous())
            for n in DETECT_NS] + [(DETECT_BIG, (2 * H, 2 * W), big)]
    for n, shape, gray in runs:
        tg = tables("real", shape, dev)
        buf = pyramid(gray, tg)
        cand = cascade(buf, tg, 256)
        cargs = [cand[k] for k in keys]
        k = int(cand["valid"].sum(1).max())
        sfx = ("" if n == N_STREAMS else f" n{n}") if shape == (H, W) \
            else " 480x640"
        hh, ww = shape
        # pyramid: the frames read, the packed planes written; ~8 f32
        # operations a pixel.  Nearest library call: one bilinear resize
        # (F.interpolate) of the frames to the first level, not the same
        # function.
        w1, h1 = dict(tg.spec.dims)[1]
        ms, plain_ms = plain_vs(
            lambda: pyramid(gray, tg),
            lambda: pack_pyramid(gray, 5, tg.plane_keys, tg.geom_levels))
        b, by = bound(n * (hh * ww + tg.L), 8 * n * tg.L)
        gf = gray[:, None].float()
        t["pyramid" + sfx] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
            graph_ms=graph_ms(lambda: pyramid(gray, tg)),
            library_ms=cuda_ms(lambda: F.interpolate(
                gf, size=(h1, w1), mode="bilinear", align_corners=False)),
            library_call="F.interpolate(bilinear), one level (nearest, not "
                         "the same function)",
            launches_per_call=launches_of("pyramid",
                                          lambda: pyramid(gray, tg)))
        # cascade: the packed planes read once, the slots written; ~12
        # operations a weak classifier evaluated (10 pixel compares, the
        # vote, the f64 add) over this run's windows
        ms, plain_ms = plain_vs(lambda: cascade(buf, tg, 256),
                                lambda: od.cascade_plain(buf, tg, 256))
        b, by = bound(n * tg.L + n * 256 * 21 + 4 * n,
                      12 * cascade_weak(buf, tg))
        t["cascade" + sfx] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
            graph_ms=graph_ms(lambda: cascade(buf, tg, 256)),
            library_ms=None, launches_per_call=launches_of(
                "cascade", lambda: cascade(buf, tg, 256)))
        if shape != (H, W):
            continue  # group's slots do not grow with the frame
        # group: the slots read and written, the picks written; ~20
        # operations a pair of valid slots
        ms, plain_ms = plain_vs(lambda: group(*cargs, 1),
                                lambda: od.group_plain(*cargs, 1))
        pairs = int((cand["valid"].sum(1) ** 2).sum())
        b, by = bound(n * 256 * (21 + 25) + 21 * n, 20 * pairs)
        nodes = graph_nodes(lambda: group(*cargs, 1))
        if nodes != ["kernel"]:
            raise AssertionError(f"group at N={n}: a captured call is the "
                                 f"graph nodes {nodes}, not one kernel")
        t["group" + sfx] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
            graph_ms=graph_ms(lambda: group(*cargs, 1)), library_ms=None,
            launches_per_call=launches_of("group",
                                          lambda: group(*cargs, 1)),
            graph_nodes=nodes,
            floor_graph_ms=graph_ms(lambda: floor_launch(n)),
            most_candidates=k)
    # its bound as the group entries': the slots read and written, the
    # picks written, ~20 operations a pair of valid slots
    nw, pairs = worst[5].shape[0], int((worst[5].sum(1) ** 2).sum())
    b, by = bound(nw * 256 * (21 + 25) + 21 * nw, 20 * pairs)
    t["group"]["worst_case"] = dict(
        input=WORST_GROUP, graph_ms=graph_ms(lambda: group(*worst, 1)),
        pairs=pairs, bound_ms=b, bound_by=by)
    for name in ("chain", "chain shuffled", "singletons", "dense"):
        gin = [torch.as_tensor(a).to(dev) for a in gcases[name]]
        t["group"]["worst_case"][name] = graph_ms(lambda: group(*gin, 1))
    t["group"]["k"] = k_dist
    for name, e in t.items():
        log(f"kernels: {name} ({e['launches_per_call']} launches a call) "
            f"{e['ms']:.4f} ms, graph replay "
            f"{e['graph_ms']:.4f} ms (plain {e['plain_ms']:.4f} ms, bound "
            f"{e['bound_ms']:.6f} ms by {e['bound_by']}; library "
            f"{fmt_ms(e['library_ms']) if e['library_ms'] is not None else 'none'})")
        if name.startswith("group"):
            log(f"kernels: {name}: a captured call is the graph nodes "
                f"{e['graph_nodes']} (one device operation); an empty "
                f"kernel at its grid (the floor of one device operation) "
                f"{e['floor_graph_ms']:.4f} ms by graph replay")
    wc = t["group"]["worst_case"]
    log(f"kernels: group's worst case ({wc['input']}, {wc['pairs']} pairs "
        f"of valid slots) {wc['graph_ms']:.4f} ms by graph replay, bound "
        f"{wc['bound_ms']:.6f} ms by {wc['bound_by']}; at N=1: "
        + ", ".join(f"{k} {wc[k]:.4f} ms" for k in
                    ("chain", "chain shuffled", "singletons", "dense")))
    return err, t


def last_slots(valid):
    """(N, C) valid -> (N,) its last valid slot + 1 a stream (0 if none):
    group's k."""
    import torch
    idx = torch.arange(1, valid.shape[1] + 1, device=valid.device)
    return (valid * idx).amax(1).cpu()


def k_spread(k):
    """The spread of group's k over a case's streams."""
    ranges = ((0, 0), (1, 32), (33, 64), (65, 128), (129, 256))
    return dict(streams=int(k.numel()),
                share_le_32=float((k <= 32).double().mean()),
                min=int(k.min()), median=int(k.median()), max=int(k.max()),
                by_range={f"{a}-{b}": int(((k >= a) & (k <= b)).sum())
                          for a, b in ranges},
                mean=float(k.double().mean()))


def group_cases(root):
    """tools/torch_group_cases.py's adversarial slot sets."""
    import numpy as np
    return load_example(root, "torch_group_cases", "tools").cases(
        np.random.default_rng(15))


GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
                    4: "graph", 5: "empty"}  # CUgraphNodeType


def node_kinds(g):
    """The node types of a torch.cuda.CUDAGraph captured with
    keep_graph=True (libcuda's cuGraphGetNodes, cuGraphNodeGetType)."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(graph, None, ctypes.byref(count)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    if cu.cuGraphGetNodes(graph, nodes, ctypes.byref(count)):
        raise RuntimeError("cuGraphGetNodes failed")
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)):
            raise RuntimeError("cuGraphNodeGetType failed")
        kinds.append(GRAPH_NODE_TYPES.get(kind.value, str(kind.value)))
    return kinds


def node_names(g):
    """The nodes of a torch.cuda.CUDAGraph captured with keep_graph=True,
    in the graph's order: a kernel node's function name (libcuda's
    cuGraphKernelNodeGetParams_v2, then cuFuncGetName, or cuKernelGetName
    where the node holds a library kernel), any other node its type."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(graph, None, ctypes.byref(count)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    if cu.cuGraphGetNodes(graph, nodes, ctypes.byref(count)):
        raise RuntimeError("cuGraphGetNodes failed")
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)):
            raise RuntimeError("cuGraphNodeGetType failed")
        if kind.value != 0:
            names.append(GRAPH_NODE_TYPES.get(kind.value, str(kind.value)))
            continue
        # CUDA_KERNEL_NODE_PARAMS_v2: func at byte 0, kern at byte 56
        params = (ctypes.c_uint8 * 128)()
        if cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), params):
            raise RuntimeError("cuGraphKernelNodeGetParams_v2 failed")
        func = ctypes.c_void_p.from_buffer(params, 0).value
        kern = ctypes.c_void_p.from_buffer(params, 56).value
        name = ctypes.c_char_p()
        err = (cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(func))
               if func else
               cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(kern)))
        if err or not name.value:
            raise RuntimeError(f"no name for a kernel node (CUresult {err})")
        names.append(name.value.decode())
    return names


def own_kernels(root):
    """The names of the __global__ functions in the checkout's
    headtrackr_tpu_torch/csrc/*.cu: the hand-written kernels."""
    import glob
    import re
    names = set()
    for path in glob.glob(os.path.join(root, "headtrackr_tpu_torch", "csrc",
                                       "*.cu")):
        with open(path) as f:
            text = f.read()
        text = re.sub(r"__(launch_bounds|cluster_dims)__\s*\([^)]*\)", "",
                      text)
        for m in re.finditer(r"__global__\b[^;{(]*?\b(\w+)\s*\(", text):
            names.add(m.group(1))
    return names


def foreign_nodes(g, root):
    """The nodes of graph g that are not launches of a hand-written kernel
    (``own_kernels``): every node that is not a kernel, and every kernel
    whose name is none of those functions, plain or as a mangled name's
    length-prefixed part (a PyTorch operation's kernel: at::native::...)."""
    own = own_kernels(root)
    return [name for name in node_names(g)
            if not any(name == k or f"{len(k)}{k}" in name for k in own)]


def graph_nodes(fn):
    """The node types of the CUDA graph that captures one call of fn."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    return node_kinds(g)


def floor_launch(n):
    """An empty kernel at group's grid (n CTAs of 256 threads), on the
    current stream."""
    import torch
    from headtrackr_tpu_torch.kernels.build import load_library
    err = load_library().fn("group_floor_launch")(
        n, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"group_floor_launch failed: cudaError {err}")


def _stacked(outs):
    """A list of StepOutputs of (N,) tensors -> host arrays (ticks, N)."""
    import torch
    return [torch.stack(v).cpu().numpy() for v in zip(*outs)]


def agree(a_outs, b_outs, where):
    """Tick for tick: integers exact, floats within RTOL / ATOL (NaN where
    NaN).  Returns the largest float difference."""
    import numpy as np
    from headtrackr_tpu_torch.models.facetracker import StepOutput
    worst = 0.0
    for field, x, y in zip(StepOutput._fields, _stacked(a_outs),
                           _stacked(b_outs)):
        if x.dtype.kind in "biu":
            bad = np.nonzero((x != y).any(1))[0]
        else:
            bad = np.nonzero(~np.isclose(x, y, rtol=RTOL, atol=ATOL,
                                         equal_nan=True).all(1))[0]
            both = np.isfinite(x) & np.isfinite(y)
            if both.any():
                worst = max(worst, float(np.abs(x - y)[both].max()))
        if bad.size:
            k = int(bad[0])
            raise AssertionError(f"{where}: tick {k} {field}: {x[k]} vs "
                                 f"{y[k]}")
    return worst


def epilogue_bytes(inputs, state_in, state, out, esc):
    """Bytes a tick_epilogue call must move: each input read once, each
    result it writes (a tensor that is no input and no leaf of the state
    it was given, which passes through) written once."""
    seen = {t.data_ptr() for t in inputs + _leaves_of(state_in)}
    nbytes = sum(t.numel() * t.element_size() for t in inputs)
    for t in _leaves_of(state) + list(out.values()) + [esc]:
        if t is not None and t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            nbytes += t.numel() * t.element_size()
    return nbytes


def phase_epilogue(pools, dev, root):
    """tick_epilogue (K8) against its twin run on the card, bit-equal
    (NaN-equal): (a) tools/torch_epilogue_cases.py's check at N_STREAMS
    (every form under each of the 64 configurations of its flag grid, on
    seeded inputs drawn to reach every branch); (b) the serving path's own
    inputs from the bench pools: each stream handed its face box on batch
    0, then the "track" step with the 96x128 band and bandHist, eager on
    the card, over batches 1 to LOSS_AT (the ring fills and head tracking
    activates; the loss streams' blue frame gives zero mass), and at each
    tick the mean shift's outputs (camshift.shift_band) and the state go
    through the fused form, the finish alone and the supervision of the
    "full" and "wbtrack" variants, kernel and twin, under the headline's
    configuration and under calcAngles with the "escape" audit action.
    Then the fused form's times on batch 1's inputs: events (eager
    wrapper calls) and graph replay beside its twin, an empty kernel at its
    grid, its byte bound; and the same inputs tiled to SCHED_BIG streams
    (events, graph, the empty kernel at that grid).  No PyTorch call
    computes its function.  Returns (max abs err, timing entries)."""
    import torch
    from headtrackr_tpu_torch import TrackerConfig
    from headtrackr_tpu_torch.kernels import epilogue as K
    from headtrackr_tpu_torch.kernels import launch as L
    from headtrackr_tpu_torch.models import camshift as cs
    from headtrackr_tpu_torch.models import facetracker as ft
    from headtrackr_tpu_torch.ops import epilogue as P

    cases = load_example(root, "torch_epilogue_cases", "tools")
    t0 = time.perf_counter()
    grid = cases.check(N_STREAMS, dev)
    if grid["launches"] != grid["runs"] or not all(
            grid[k] for k in ("activations", "lost", "nan_angles",
                              "escaped", "head_valid")):
        raise AssertionError(f"epilogue: the grid's check missed a branch "
                             f"or a launch: {grid}")
    log(f"kernels: tick_epilogue bit-equal to its twin on the card on "
        f"{grid['runs']} form x configuration runs at N={N_STREAMS} "
        f"({grid}; {time.perf_counter() - t0:.1f} s)")

    def flat(r, form):  # every result of a form's call
        if form == "finish":
            return list(r)
        return (cases._leaves(r[0]) + [v for _, v in sorted(r[1].items())]
                + [r[2]])

    configs = {"headline": TrackerConfig(bandHist=True),
               "calcAngles escape": TrackerConfig(
                   bandHist=True, calcAngles=True,
                   bandHistAuditAction="escape")}
    checked, worst, seen = 0, 0.0, dict(activated=0, zero_mass=0, lost=0)
    timed = None
    for k, pool in pools.items():
        boxes = torch.as_tensor(face_boxes(pool[0])).to(dev)
        frames = [torch.as_tensor(pool[t]).to(dev) for t in
                  range(LOSS_AT + 1)]
        for cname, cfg in configs.items():
            ep = P.epilogue_config(cfg, (H, W))
            state = ft.init_state(N_STREAMS, band_audit=True, device=dev)
            state = state._replace(
                mode=torch.full_like(state.mode, ft.MODE_CS),
                cs=cs.init_tracker(frames[0], boxes, audit_band=BAND))
            for t in range(1, LOSS_AT + 1):
                win, m, zm, esc, dirty = cs.shift_band(
                    state.cs, frames[t], BAND, None, True,
                    cfg.bandHistAuditAction == "escape")
                args = (state, win, m, zm, esc, dirty, ep)
                before = L.launches["tick_epilogue"]
                got = K.track(*args)
                torch.cuda.synchronize()
                if L.launches["tick_epilogue"] != before + 1:
                    raise AssertionError("epilogue: the fused form is not "
                                         "one launch")
                want = P.track_plain(*args)
                res = cases.Result(*(got[1][f] for f in (
                    "face_x", "face_y", "face_w", "face_h", "face_angle",
                    "face_conf", "wb")), escaped=esc)
                runs = [("track", got, want),
                        ("finish", K.finish(win, m, zm, ep.calc_angles, H, W),
                         P.finish_plain(win, m, zm, ep.calc_angles, H, W))]
                for variant in ("full", "wbtrack"):
                    e = esc if variant == "wbtrack" else None
                    runs.append((f"supervise {variant}",
                                 K.supervise(state, state.mode, res, ep,
                                             variant, e),
                                 P.supervise_plain(state, state.mode, res, ep,
                                                   variant, e)))
                for form, a, b in runs:
                    for x, y in zip(flat(a, form), flat(b, form)):
                        if (x is None) != (y is None) or (
                                x is not None and not cases.same_bits(x, y)):
                            raise AssertionError(
                                f"epilogue: tick_epilogue differs from its "
                                f"twin on the bench pool (face_noise={k}, "
                                f"{cname}, tick {t}, {form})")
                        if x is not None and x.is_floating_point():
                            fin = torch.isfinite(x) & torch.isfinite(y)
                            if fin.any():
                                worst = max(worst, float(
                                    (x - y)[fin].abs().max()))
                    checked += 1
                new = got[0]
                seen["activated"] += int((state.first_run
                                          & ~new.first_run).sum())
                seen["zero_mass"] += int(zm.sum())
                seen["lost"] += int(((got[1]["status"] & 24) != 0).sum())
                if timed is None and t == 1 and cname == "headline":
                    timed = args, epilogue_bytes(
                        [win, *(m[c] for c in ("mu20", "mu02", "mu11",
                                               "invM00")), zm, esc,
                         state.mode, state.cs.window, state.cs.track_x,
                         state.cs.track_y, state.cs.track_w,
                         state.cs.track_h, state.cs.track_angle,
                         state.first_run, state.face_found, state.sm_init,
                         state.headpose_active, state.stopped, state.sm_sp,
                         state.diag_ring, state.diag_n, state.tan_fov,
                         state.fov_width, state.head_diag_cam], state, *got)
                state = new._replace(mode=torch.full_like(new.mode,
                                                          ft.MODE_CS))
    if not (seen["zero_mass"] and seen["lost"]):
        raise AssertionError(f"epilogue: the bench pool's loss batch gave "
                             f"no zero-mass or lost stream: {seen}")
    log(f"kernels: tick_epilogue bit-equal to its twin run on the card on "
        f"the bench pool's mean-shift outputs and states ({checked} form "
        f"runs: the fused form, the finish, the supervision of full and "
        f"wbtrack; {len(configs)} configurations, ticks 1-{LOSS_AT}; "
        f"{seen}; max abs err {worst})")

    args, nbytes = timed
    b, by = bound(nbytes, EPILOGUE_OPS * N_STREAMS)
    kernel = lambda: K.track(*args)  # noqa: E731
    ms, plain_ms = interleaved_ms(kernel, lambda: P.track_plain(*args))
    t = {"tick_epilogue": dict(
        ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
        graph_ms=graph_ms(kernel),
        empty_ms=graph_ms(lambda: epilogue_floor(N_STREAMS)),
        library_ms=None, library_graph_ms=None, bytes=nbytes,
        launches_a_call=launches_of("tick_epilogue", kernel))}
    e = t["tick_epilogue"]
    # the same inputs tiled to SCHED_BIG streams (the moments and flags
    # still columns of one block each)
    big = tile_epilogue_args(args, SCHED_BIG // N_STREAMS)
    got, want = K.track(*big), P.track_plain(*big)
    for x, y in zip(flat(got, "track"), flat(want, "track")):
        if (x is None) != (y is None) or (
                x is not None and not cases.same_bits(x, y)):
            raise AssertionError(f"epilogue: tick_epilogue differs from its "
                                 f"twin at {SCHED_BIG} streams")
    kernel_big = lambda: K.track(*big)  # noqa: E731
    e.update(big_streams=SCHED_BIG, big_ms=cuda_ms(kernel_big),
             big_graph_ms=graph_ms(kernel_big),
             big_empty_ms=graph_ms(lambda: epilogue_floor(SCHED_BIG)),
             big_bound_ms=bound(nbytes * (SCHED_BIG // N_STREAMS),
                                EPILOGUE_OPS * SCHED_BIG)[0])
    log(f"kernels: tick_epilogue (fused track form, N={N_STREAMS}) "
        f"{ms:.4f} ms, graph replay {e['graph_ms']:.4f} ms, an empty kernel "
        f"at its grid {e['empty_ms']:.4f} ms (plain {plain_ms:.4f} ms, "
        f"bound {b:.6f} ms by {by}, {nbytes} B; no PyTorch call computes "
        f"its function); N={SCHED_BIG}: {e['big_ms']:.4f} ms, graph replay "
        f"{e['big_graph_ms']:.4f} ms, an empty kernel at its grid "
        f"{e['big_empty_ms']:.4f} ms, bound {e['big_bound_ms']:.6f} ms")
    return worst, t


def epilogue_floor(n):
    """An empty kernel at tick_epilogue's grid for n streams, on the
    current stream."""
    import torch
    from headtrackr_tpu_torch.kernels.build import load_library
    err = load_library().fn("tick_epilogue_floor_launch")(
        n, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"tick_epilogue_floor_launch failed: cudaError "
                           f"{err}")


def tile_epilogue_args(args, k):
    """tick_epilogue's fused-form arguments (state, win, m, zero_mass,
    escaped, dirty, ep) with every stream repeated k times: the moments
    columns of one (N k, 12) block, zero_mass and escaped of one (N k, 2)
    block, as the mean shift hands them over."""
    import torch
    from headtrackr_tpu_torch.ops.meanshift import MOMENTS
    state, win, m, zm, esc, dirty, ep = args

    def rep(t):
        return None if t is None else t.repeat(k, *[1] * (t.dim() - 1))

    def tree(x):
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(tree(v) for v in x))
        return rep(x)

    mom = torch.stack([rep(m[c]) for c in MOMENTS], 1)
    flags = torch.stack([rep(zm), rep(esc) if esc is not None
                         else torch.zeros_like(rep(zm))], 1)
    return (tree(state), rep(win),
            {c: mom[:, j] for j, c in enumerate(MOMENTS)}, flags[:, 0],
            None if esc is None else flags[:, 1], rep(dirty), ep)


def bucket_workloads(pool, dev):
    """The bucket kernels' timed calls on the bench pool's frame after the
    loss frame: (a) the relock tick's, BUCKET_SLOTS slots over N_STREAMS
    streams, LOSS_STREAMS of them served (entering in VJ after their blue
    frame, then WB ones) and the rest padding, each stream's face box its
    detection, the BAND audit, a state of the headline's leaves; (b) at
    N_STREAMS streams the cold start's: every stream entering in VJ and
    switching on its face box with the BAND audit (the full tick's
    handoff), frame_prep over every stream with the gray plane (the full
    tick, streams in VJ) and without it (wbtrack, streams in WB).  Returns
    (name -> (kernel, args, kwargs, streams), the state, the slots)."""
    import torch
    from headtrackr_tpu_torch.kernels.schedule import slot_gather
    from headtrackr_tpu_torch.models import facetracker as ft
    from headtrackr_tpu_torch.ops.imageproc import frame_prep_plain
    frames = torch.as_tensor(pool[LOSS_AT + 1]).to(dev)
    S = BUCKET_SLOTS
    idx = torch.full((S,), N_STREAMS, dtype=torch.int64)
    idx[:LOSS_STREAMS] = torch.arange(LOSS_STREAMS)
    idx = idx.to(dev)
    state = ft.init_state(N_STREAMS, band_audit=True, device=dev)
    mode = torch.full((N_STREAMS,), ft.MODE_CS, dtype=torch.int32)
    mode[:LOSS_STREAMS] = ft.MODE_VJ
    mode[LOSS_STREAMS:2 * LOSS_STREAMS] = ft.MODE_WB
    state = state._replace(mode=mode.to(dev))
    sub, _ = slot_gather(state, idx)
    boxes = torch.as_tensor(face_boxes(pool[LOSS_AT + 1])).to(dev)

    def det_of(rows):
        n = rows.shape[0]
        return (torch.ones((n,), dtype=torch.bool, device=dev),
                *(rows[:, j].float() + 0.5 for j in range(4)),
                torch.full((n,), 3.0, device=dev))

    # the modes frame_prep hands the handoff (its twin's: the same bits)
    sub_mode = frame_prep_plain(frames, idx, sub.mode, sub.wb_ring,
                                sub.wb_n, gray=False)[4]
    vj = torch.full((N_STREAMS,), ft.MODE_VJ, dtype=torch.int32, device=dev)
    every = (frames, None, vj, state.wb_ring, state.wb_n)
    calls = {
        "frame_prep": ("frame_prep",
                       (frames, idx, sub.mode, sub.wb_ring, sub.wb_n), {}, S),
        "handoff": ("handoff", (frames, idx), dict(
            det=det_of(boxes.index_select(0, idx.clamp(max=N_STREAMS - 1))),
            entry_mode=sub.mode, mode=sub_mode, old=tuple(sub.cs),
            band=BAND), S),
        f"frame_prep n{N_STREAMS}": ("frame_prep", every, {}, N_STREAMS),
        f"frame_prep n{N_STREAMS} no gray": (
            "frame_prep", (frames, None, state.mode, state.wb_ring,
                           state.wb_n), dict(gray=False, wb_vj=True),
            N_STREAMS),
        f"handoff n{N_STREAMS}": ("handoff", (frames, None), dict(
            det=det_of(boxes), entry_mode=vj, mode=vj,
            old=tuple(state.cs), band=BAND), N_STREAMS),
    }
    return calls, state, idx


def bucket_bytes(key, args, kw, out):
    """The bytes a bucket kernel's call must move on this run's data: each
    input row read once, each output written once; handoff reads a
    switching stream's rect and, auditing, the frame outside the band up
    to its first model-colored pixel (3 bytes where one is found, the
    whole outside where none is); any other stream copies its 16 KB row."""
    import torch
    from headtrackr_tpu_torch.models import facetracker as ft
    from headtrackr_tpu_torch.models.camshift import band_rect
    frames, slots = args[0], args[1]
    H_, W_ = frames.shape[1:3]
    px = H_ * W_
    slot = 0 if slots is None else 8
    if key == "frame_prep":
        S = args[2].shape[0]
        gray = kw.get("gray", True)
        return S * (3 * px + (px if gray else 0) + 4 * 15 * 2 + 4 * 4 + 4
                    + slot)
    det = kw["det"]
    S = det[0].shape[0]
    rects = torch.floor(torch.stack(det[1:5], 1)).int()
    rw = (torch.clamp(rects[:, 0] + rects[:, 2], max=W_)
          - torch.clamp(rects[:, 0], min=0)).clamp(min=0)
    rh = (torch.clamp(rects[:, 1] + rects[:, 3], max=H_)
          - torch.clamp(rects[:, 1], min=0)).clamp(min=0)
    switched = (kw["entry_mode"] == ft.MODE_VJ).cpu()
    _, _, bh, bw = band_rect(rects, kw["band"], (H_, W_))
    dirty = out[0][7].cpu()
    scan = torch.where(dirty, 3, 3 * (px - bh * bw))
    return int((switched * (3 * (rw * rh).cpu() + scan)).sum()) \
        + S * (4 * 4096 + 8 * 4 + 4 * 7 + slot)


def phase_bucket(pools, dev, root):
    """Phase 3b, the relock tick's bucket kernels: frame_prep (K9),
    handoff (K7) and slot_gather (S5) against their twins run on the card,
    bit-equal: (a) tools/torch_bucket_cases.py's check at BUCKET_NS
    streams, and its check_gather there (slot_gather at every slot count
    to the chunk cap and at escape_bucket, both keep rules)
    streams (every branch: WB streams with stable rings, VJ streams
    switching or not, detections at and past the frame's edges and empty,
    model pixels one row or column outside the band, padded slots); (b)
    its check_splits at BUCKET_NS: frame_prep and handoff with their split
    forced to every P the launchers can pick, each against its twin at
    that P; (c) bucket_workloads' calls: the relock tick's shapes and the
    cold start's at N_STREAMS streams.  Then each kernel's times on those
    calls: events and graph replay beside its twin, an empty kernel at its
    grid (the streams times the launcher's split), its bound (the bytes
    this run's data needs) and a library call (frame_prep: a channel sum
    over the served frames; handoff: torch.bincount of the rects' bins,
    the histogram alone; slot_gather: index_select of the model
    histograms' rows, the largest leaf).  Returns (max abs err by kernel,
    timing entries)."""
    import torch
    from headtrackr_tpu_torch.kernels.frameprep import frame_prep, pick_split
    from headtrackr_tpu_torch.kernels.handoff import handoff
    from headtrackr_tpu_torch.kernels.launch import sm_count
    from headtrackr_tpu_torch.kernels.schedule import (gather_ctas,
                                                       slot_gather,
                                                       slot_gather_plain)
    from headtrackr_tpu_torch.ops.handoff import handoff_plain
    from headtrackr_tpu_torch.ops.histogram import rgb_bins
    from headtrackr_tpu_torch.ops.imageproc import frame_prep_plain

    cases = load_example(root, "torch_bucket_cases", "tools")
    t0 = time.perf_counter()
    reached = {n: cases.check(n, dev) for n in BUCKET_NS}
    big = reached[N_STREAMS]
    if not all(big[k] for k in ("stable", "switched", "dirty", "clean",
                                "kept")):
        raise AssertionError(f"bucket: the cases missed a branch: {big}")
    for n, r in reached.items():
        if r["launches"] != {"frame_prep": 4, "handoff": 4,
                             "slot_gather": 1}:
            raise AssertionError(f"bucket: launches at N={n}: {r}")
    log(f"kernels: frame_prep, handoff and slot_gather bit-equal to their "
        f"twins on the card at N={list(BUCKET_NS)} ({big}; "
        f"{time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    for n in BUCKET_NS:
        r = cases.check_gather(n, dev)
        if r["launches"] != r["calls"]:
            raise AssertionError(f"bucket: slot_gather at N={n}: {r}")
    log(f"kernels: slot_gather bit-equal to its twin at every slot count to "
        f"the chunk cap and at escape_bucket, both keep rules, at "
        f"N={list(BUCKET_NS)} ({r}; {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    for n in BUCKET_NS:
        r = cases.check_splits(n, dev)
        if r["launches"] != {p: {"frame_prep": 4, "handoff": 3}
                             for p in cases.SPLITS} or (
                n == N_STREAMS and not (r["dirty"] and r["clean"])):
            raise AssertionError(f"bucket: the forced splits at N={n}: {r}")
    log(f"kernels: frame_prep and handoff at every forced split "
        f"{list(cases.SPLITS)} bit-equal to their twins at that split, at "
        f"N={list(BUCKET_NS)} ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    calls_in_place = 8  # tools/torch_bucket_cases.py in_place_calls
    shapes, offsets = cases.IN_PLACE_SHAPES, cases.IN_PLACE_OFFSETS
    for n in (BUCKET_SLOTS, N_STREAMS):
        r = cases.check_in_place(n, dev)
        if r["cases"] != len(shapes) * len(offsets) * calls_in_place or \
                r["launches"] != len(shapes) * (1 + len(offsets)) * \
                calls_in_place:
            raise AssertionError(f"bucket: in place at N={n}: {r}")
    log(f"kernels: frame_prep and handoff reading tick "
        f"{cases.IN_PLACE_TICK} of a scan in place bit-equal to their direct "
        f"reads at N={[BUCKET_SLOTS, N_STREAMS]}, frames {list(shapes)}, the "
        f"scan {list(offsets)} bytes past a 16-byte boundary "
        f"({time.perf_counter() - t0:.1f} s)")

    pool = pools[0]
    calls, state, idx = bucket_workloads(pool, dev)
    sub, keep = slot_gather(state, idx)
    want_sub, want_keep = slot_gather_plain(state, idx)
    for a, b in zip(_leaves_of(sub) + [keep],
                    _leaves_of(want_sub) + [want_keep]):
        if not cases._same(a, b):
            raise AssertionError("bucket: slot_gather differs from its twin "
                                 "on the relock tick")
    wrapper = {"frame_prep": (frame_prep, frame_prep_plain),
               "handoff": (handoff, handoff_plain)}
    outs = {}
    for name, (key, args, kw, _) in calls.items():
        kernel, plain = wrapper[key]
        got, want = kernel(*args, **kw), plain(*args, **kw)
        if key == "frame_prep":
            cases._check(f"{name} on the bench pool", got, want)
        else:
            cases._check(f"{name} leaves on the bench pool", got[0], want[0])
            cases._check(f"{name} mode and result on the bench pool",
                         (got[1],) + got[2], (want[1],) + want[2])
        outs[name] = got
    torch.cuda.synchronize()

    S = BUCKET_SLOTS
    leaves = _leaves_of(state)
    sg_bytes = 2 * sum(t.nbytes // N_STREAMS for t in leaves) * S + 9 * S
    # the few escape body's gather: SCHED_EB slots, the last
    # SCHED_ESCAPES[1] streams and padding, the frames an extra leaf
    frames = calls["frame_prep"][1][0]
    eidx = torch.full((SCHED_EB,), N_STREAMS, dtype=torch.int64)
    eidx[:SCHED_ESCAPES[1]] = torch.arange(N_STREAMS - SCHED_ESCAPES[1],
                                           N_STREAMS)
    eidx = eidx.to(dev)
    got = slot_gather(state, eidx, True, (frames,))
    want = slot_gather_plain(state, eidx, True, (frames,))
    for a, b in zip(_leaves_of(got[0]) + list(got[1:]),
                    _leaves_of(want[0]) + list(want[1:])):
        if not cases._same(a, b):
            raise AssertionError("bucket: slot_gather differs from its twin "
                                 "on the few escape body's slots")
    esc_rows = [t.nbytes // N_STREAMS for t in leaves + [frames]]
    sge_bytes = 2 * sum(esc_rows) * SCHED_EB + 9 * SCHED_EB
    sms = sm_count(dev)

    def rect_ids(args, kw):
        """The per-stream-offset bins of the switching streams' rects."""
        frames, slots = args
        det = kw["det"]
        n = det[0].shape[0]
        rows = frames if slots is None else frames.index_select(
            0, torch.clamp(slots, max=N_STREAMS - 1))
        rects = torch.floor(torch.stack(det[1:5], 1)).int().tolist()
        switched = (kw["entry_mode"] == 1).tolist()
        bins = rgb_bins(rows)
        inside = torch.zeros_like(bins, dtype=torch.bool)
        for j, (x, y, w, h) in enumerate(rects):
            if switched[j]:
                inside[j, max(y, 0):max(y + h, 0), max(x, 0):max(x + w, 0)] \
                    = True
        return (bins.long() + 4096 * torch.arange(n, device=dev).view(
            n, 1, 1))[inside], n

    timed = {}
    for name, (key, args, kw, n) in calls.items():
        kernel, plain = wrapper[key]
        if key == "frame_prep":
            rows = args[0] if args[1] is None else args[0][:n]
            lib = (lambda r=rows: r.sum(dim=(1, 2), dtype=torch.int32), True)
        else:
            ids, m = rect_ids(args, kw)
            lib = (lambda i=ids, m=m: torch.bincount(i, minlength=m * 4096),
                   False)
        timed[name] = (lambda k=kernel, a=args, w=kw: k(*a, **w),
                       lambda p=plain, a=args, w=kw: p(*a, **w),
                       bucket_bytes(key, args, kw, outs[name]), lib,
                       n * pick_split(n, sms), key)
    timed["slot_gather"] = (
        lambda: slot_gather(state, idx), lambda: slot_gather_plain(state, idx),
        sg_bytes, (lambda: state.cs.model_hist.index_select(0, idx.clamp(
            max=N_STREAMS - 1)), True),
        S * gather_ctas([t.nbytes // N_STREAMS for t in leaves]),
        "slot_gather")
    timed["slot_gather escape"] = (
        lambda: slot_gather(state, eidx, True, (frames,)),
        lambda: slot_gather_plain(state, eidx, True, (frames,)), sge_bytes,
        (lambda: frames.index_select(0, eidx.clamp(max=N_STREAMS - 1)),
         True), SCHED_EB * gather_ctas(esc_rows), "slot_gather")
    times = {}
    for name, (kernel, plain, nbytes, (lib, capturable), grid, key) \
            in timed.items():
        ms, plain_ms = interleaved_ms(kernel, plain)
        b, by = bound(nbytes, 0)
        times[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                           graph_ms=graph_ms(kernel),
                           empty_ms=graph_ms(lambda g=grid: floor_launch(g)),
                           grid=grid, bytes=nbytes,
                           launches_a_call=launches_of(key, kernel),
                           **library_times(lib, capturable))
        e = times[name]
        where = (f"the relock tick: {S} slots, {LOSS_STREAMS} served, of "
                 f"{N_STREAMS} streams" if " n" not in name else
                 f"the cold start's {N_STREAMS} streams")
        if name == "slot_gather escape":
            where = (f"the few escape body: {SCHED_EB} slots, "
                     f"{SCHED_ESCAPES[1]} escaped, the frames a leaf")
        log(f"kernels: {name} ({where}) {ms:.4f} ms, graph replay "
            f"{e['graph_ms']:.4f} ms, an empty kernel at its grid of {grid} "
            f"CTAs {e['empty_ms']:.4f} ms (plain {plain_ms:.4f} ms, bound "
            f"{b:.6f} ms by {by}, {nbytes} B; library "
            f"{e['library_ms']:.4f} ms events, graph "
            f"{fmt_ms(e['library_graph_ms'])}; no one PyTorch call computes "
            f"its whole function)")
        if e["launches_a_call"] != 1:
            raise AssertionError(f"bucket: {name} is not one launch a call")
    # frame_prep and handoff reading tick k's frames in place (through a
    # word, as the serving program's bodies do) against their direct read
    # of them, bit for bit and graph ms in turns, on each of the calls
    from headtrackr_tpu_torch.kernels import launch as L
    seq, word = cases.staged_scan(frames, cases.IN_PLACE_TICKS,
                                  cases.IN_PLACE_TICK, 0)
    tick = seq[cases.IN_PLACE_TICK]
    buf = torch.full_like(frames, 255)
    for name, (key, args, kw, _) in calls.items():
        kernel = wrapper[key][0]

        def direct(k=kernel, a=args[1:], w=kw):
            return k(tick, *a, **w)

        def in_place(k=kernel, a=args[1:], w=kw):
            with L.frames_at(buf, word):
                return k(buf, *a, **w)

        cases._check(f"{name} in place", cases._leaves(in_place()),
                     cases._leaves(direct()))
        ip, dr = [], []
        for _ in range(2):  # direct, in place, in place, direct
            dr.append(graph_ms(direct))
            ip += [graph_ms(in_place), graph_ms(in_place)]
            dr.append(graph_ms(direct))
        times[name]["in_place"] = {"graph_ms": ip, "direct_graph_ms": dr}
        log(f"kernels: {name} in place bit-equal to its direct read, graph "
            f"ms in turns: in place {[round(x, 5) for x in ip]}, direct "
            f"{[round(x, 5) for x in dr]} ({sum(ip) / sum(dr) - 1:+.1%})")
    if not bool((buf == 255).all()):
        raise AssertionError("bucket: a kernel in place wrote its buffer")
    return {k: 0.0 for k in BUCKET}, times


def epilogue_bodies(bt):
    """Each serving-program body of a warmed tracker: its tick_epilogue
    and bucket kernels' launches a run (its tally) and its graph's nodes;
    raises where a body launches no tick_epilogue."""
    out = {}
    for (n, key), body in bt._steps._graphs.items():
        kinds = node_kinds(body.graph)
        out[str(key)] = {"tick_epilogue": body.launches["tick_epilogue"],
                         "nodes": len(kinds),
                         "kernel_nodes": kinds.count("kernel"),
                         **{k: body.launches[k] for k in BUCKET}}
    missing = [k for k, v in out.items() if not v["tick_epilogue"]]
    if missing:
        raise AssertionError(f"epilogue: the bodies {missing} launch no "
                             f"tick_epilogue")
    return out


def phase_serving(name, frames, dev):
    """frames: the (POOL, N, H, W, 3) bench pool, staged on the card.
    Returns (launch counts of the run, ms/tick by entry point, the locked
    tracker)."""
    import numpy as np
    import torch
    from headtrackr_tpu_torch import BatchedTracker
    from headtrackr_tpu_torch.kernels import launch as L
    from headtrackr_tpu_torch.models import facetracker as ft

    kw, path = CONFIGS[name]
    bt = BatchedTracker(N_STREAMS, (H, W), device=dev, **kw)
    t0 = time.perf_counter()
    bt.warmup(scan_len=POOL)
    t_warm = time.perf_counter() - t0
    torch.cuda.synchronize()
    L.reset_launches()
    t0 = time.perf_counter()
    outs = [bt.step_auto(frames[0]) for _ in range(LOCK_TICKS)]
    locked = float((bt.modes == ft.MODE_CS).mean())
    torch.cuda.synchronize()
    t_lock = time.perf_counter() - t0
    if locked < 0.99:
        raise AssertionError(f"{name}: only {100 * locked:.1f}% of streams "
                             f"locked")
    n_ticks = 2 * POOL
    t0 = time.perf_counter()
    for t in range(n_ticks):
        outs.append(bt.step_auto(frames[t % POOL]))
    torch.cuda.synchronize()
    dt_auto = time.perf_counter() - t0
    t0 = time.perf_counter()
    scan = bt.run_scan(frames)
    torch.cuda.synchronize()
    dt_scan = time.perf_counter() - t0
    divergence = None
    if kw.get("bandHist"):  # the periodic bandHist cross-check (a user's
        # entry point; its band histogram is histpdf_band's hist-only mode)
        divergence = bt.band_hist_divergence(frames[0])
        path = path + ("histpdf_band_hist",)
    counts = dict(L.launches)
    missing = [k for k in path if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{name}: kernels of the path never launched: "
                             f"{missing} ({counts})")
    if counts["scan_step"]:  # every body reads the tick's frames in place
        raise AssertionError(f"{name}: scan_step ran {counts['scan_step']} "
                             f"times over the cold start, relocks and "
                             f"steady ticks")
    outs += [ft.StepOutput(*(v[k] for v in scan)) for k in range(POOL)]

    status = np.stack([o.status.cpu().numpy() for o in outs[LOCK_TICKS:]])
    redet = (status[:, :LOSS_STREAMS] & ft.STATUS_REDETECTING) != 0
    found = (status[:, :LOSS_STREAMS] & ft.STATUS_FOUND) != 0
    modes = bt.modes
    for s in range(LOSS_STREAMS):
        r = np.nonzero(redet[:, s])[0]
        if r.size < 3 or not found[r[0]:, s].any() or modes[s] != ft.MODE_CS:
            raise AssertionError(f"{name}: loss stream {s} did not redetect "
                                 f"and relock on each pool pass")
    for o in outs:
        for field, v in zip(o._fields, o):
            if v.is_floating_point():
                nan = torch.isnan(v)
                if field == "face_angle":
                    nan &= ~((o.detection == ft.MODE_CS) & (o.face_w == 0))
                if bool(nan.any()):
                    raise AssertionError(f"{name}: NaN in output {field}")
    esc = float(np.mean([int(o.escaped.sum()) for o in outs[LOCK_TICKS:]]))
    dirty = bt.state.cs.band_dirty
    n_dirty = int(dirty.sum()) if dirty is not None else None

    # the eager twin: the host scheduler at sync_interval 1, same frames
    ref = BatchedTracker(N_STREAMS, (H, W), device=dev, sync_interval=1, **kw)
    seq = ([frames[0]] * LOCK_TICKS + [frames[t % POOL] for t in range(n_ticks)]
           + list(frames))
    ref_outs = [ref.step(f, sync=True) for f in seq[:LOCK_TICKS]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_outs += [ref.step(f, sync=True) for f in seq[LOCK_TICKS:]]
    torch.cuda.synchronize()
    dt_step = time.perf_counter() - t0
    worst = agree(outs, ref_outs, f"{name}: step_auto/run_scan vs step")

    ms = {"step_auto": 1000 * dt_auto / n_ticks, "run_scan": 1000 * dt_scan
          / POOL, "step": 1000 * dt_step / (n_ticks + POOL)}
    log(f"serving [{name}] {kw}: warmup {t_warm:.2f} s; {100 * locked:.1f}% "
        f"of {N_STREAMS} streams locked after {LOCK_TICKS} ticks "
        f"({t_lock:.2f} s, {LOCK_TICKS * N_STREAMS / t_lock:.0f} frames/s "
        f"cold start); step_auto {ms['step_auto']:.3f} ms/tick over "
        f"{n_ticks} ticks ({N_STREAMS * n_ticks / dt_auto:.0f} frames/s), "
        f"run_scan K={POOL} {ms['run_scan']:.3f} ms/tick "
        f"({N_STREAMS * POOL / dt_scan:.0f} frames/s), step (eager, "
        f"sync_interval 1) {ms['step']:.3f} ms/tick; escapes {esc:.2f}/tick; "
        f"band_dirty {n_dirty}; {LOSS_STREAMS} loss streams relocked on each "
        f"pool pass; bandHist divergence of stream 0 {divergence}; launches "
        f"{counts}")
    log(f"serving [{name}]: step_auto + run_scan agree with step(sync=True) "
        f"on {len(outs)} ticks (integers exact, floats rtol {RTOL} / atol "
        f"{ATOL}; largest float difference {worst})")
    return counts, ms, bt


def steady_s(tick, frames, ticks=PROFILE_TICKS):
    """Host seconds of ``ticks`` all-tracking ticks of ``tick``."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(ticks):
        tick(frames[t % LOSS_AT])
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_profile(trackers, frames):
    """Steady-tick profile of each locked tracker's step_auto (graph
    replay) and step (eager), configurations in turns, two passes:
    name -> entry point -> [one dict per pass]."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from headtrackr_tpu_torch.kernels import launch as L
    from headtrackr_tpu_torch.models import facetracker as ft

    rows = {name: {"step_auto": [], "step": []} for name in trackers}
    for rep in range(2):
        for name, bt in trackers.items():
            for entry in ("step_auto", "step"):
                if not (bt.modes == ft.MODE_CS).all():
                    raise AssertionError(f"profile [{name}]: not every "
                                         f"stream tracks")
                tick = getattr(bt, entry)
                steady_s(tick, frames)  # warm
                wall = steady_s(tick, frames)
                for _ in range(2):  # a session has lost all its device
                    # events on this card (PERF.md §7): one more window
                    L.reset_launches()
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        pwall = steady_s(tick, frames)
                    events = prof.events()
                    dev_ops = [e for e in events if e.device_type
                               == torch.autograd.DeviceType.CUDA]
                    if dev_ops:
                        break
                if not dev_ops:
                    raise AssertionError("the profiler saw no device kernels")
                host = sum(e.name in HOST_LAUNCHES for e in events)
                device_s = sum(e.device_time_total for e in dev_ops) / 1e6
                r = {"ms_per_tick": 1e3 * wall / PROFILE_TICKS,
                     "profiled_ms_per_tick": 1e3 * pwall / PROFILE_TICKS,
                     "device_ms": 1e3 * device_s / PROFILE_TICKS,
                     "device_busy": device_s / pwall,
                     "launches": len(dev_ops) / PROFILE_TICKS,
                     "host_launches": host / PROFILE_TICKS,
                     "kernel_launches": {k: v / PROFILE_TICKS
                                         for k, v in L.launches.items()}}
                rows[name][entry].append(r)
                log(f"profile [{name}] {entry} pass {rep}: "
                    f"{r['ms_per_tick']:.3f} ms/tick "
                    f"({r['profiled_ms_per_tick']:.3f} profiled), device "
                    f"{r['device_ms']:.3f} ms/tick "
                    f"({100 * r['device_busy']:.1f}% busy), "
                    f"{r['launches']:.2f} device ops/tick, "
                    f"{r['host_launches']:.2f} host launch calls/tick, "
                    f"kernels {r['kernel_launches']}")
    return rows


HOST_SYNCS = ("cudaStreamSynchronize", "cudaEventSynchronize")


def phase_allcs(runs, prof, root):
    """Phase 5's checks of the steady tick in every configuration: no
    scan_step ran on a profiled all-CS step_auto tick (each all-CS body
    reads the tick's frames in place), and the band and full-frame
    all-CS bodies' graphs hold ALLCS_NODES nodes, none of them other than
    a launch of a hand-written kernel (``foreign_nodes``).  Returns each
    checked body's nodes by kernel name."""
    out = {}
    for name, (_, _, bt) in runs.items():
        steps = [r["kernel_launches"]["scan_step"]
                 for r in prof[name]["step_auto"]]
        if any(steps):
            raise AssertionError(f"allcs [{name}]: scan_step ran on all-CS "
                                 f"ticks ({steps} a tick)")
        if name not in ALLCS_NODES:
            continue
        body = bt._steps._graphs[(bt.n, 0)]
        names = node_names(body.graph)
        foreign = foreign_nodes(body.graph, root)
        copy = bt._steps.copy_mode(0)
        if foreign or len(names) != ALLCS_NODES[name] or copy != "none":
            raise AssertionError(f"allcs [{name}]: the all-CS body copies "
                                 f"{copy!r}, holds {names}, not "
                                 f"hand-written: {foreign}")
        out[name] = names
    log(f"allcs: no scan_step on any configuration's all-CS ticks; the "
        f"band and full-frame all-CS bodies hold hand-written kernels "
        f"alone: {out}")
    return out


def phase_relock(bt, frames):
    """Phase 5's relock tick on the headline's locked tracker: the
    LOSS_STREAMS streams turn blue (pool batch LOSS_AT, an all-CS tick) and
    redetect on the next batch: a bucket tick.  Arms in turns, two passes
    each: the tick as one launch of the serving program (``_Steps.scheduled``
    on) and run eagerly on the per-tick path (off).  Per relock tick: host
    ms (host clock, ending in a synchronize), and under torch.profiler
    device ms, device operations, host launch calls and host reads (stream
    and event synchronizations)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from headtrackr_tpu_torch.models import facetracker as ft

    def relock_state():
        bt.step_auto(frames[LOSS_AT])
        pend = int((bt.modes != ft.MODE_CS).sum())
        if pend != LOSS_STREAMS:
            raise AssertionError(f"relock: {pend} streams pending after the "
                                 f"blue frame, not {LOSS_STREAMS}")

    from headtrackr_tpu_torch.kernels import launch as L
    rows = {"graph": [], "eager": []}
    steps0 = L.launches["scan_step"]
    for rep in range(2):
        for arm in rows:
            host, dev_s, ops, launches, syncs = [], 0.0, 0, 0, 0
            for _ in range(RELOCK_TICKS):
                relock_state()
                bt._steps.scheduled = arm == "graph"
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                bt.step_auto(frames[LOSS_AT + 1])
                torch.cuda.synchronize()
                host.append(time.perf_counter() - t0)
                bt._steps.scheduled = True
                if not (bt.modes == ft.MODE_CS).all():
                    raise AssertionError("relock: a stream did not relock")
            for _ in range(RELOCK_TICKS):
                relock_state()
                bt._steps.scheduled = arm == "graph"
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    bt.step_auto(frames[LOSS_AT + 1])
                    torch.cuda.synchronize()
                bt._steps.scheduled = True
                events = prof.events()
                dev_ops = [e for e in events if e.device_type
                           == torch.autograd.DeviceType.CUDA]
                dev_s += sum(e.device_time_total for e in dev_ops) / 1e6
                ops += len(dev_ops)
                launches += sum(e.name in HOST_LAUNCHES for e in events)
                syncs += sum(e.name in HOST_SYNCS for e in events)
            host.sort()
            r = {"host_ms_p50": 1e3 * host[len(host) // 2],
                 "host_ms_mean": 1e3 * sum(host) / len(host),
                 "device_ms": 1e3 * dev_s / RELOCK_TICKS,
                 "device_ops": ops / RELOCK_TICKS,
                 "host_launches": launches / RELOCK_TICKS,
                 "host_reads": syncs / RELOCK_TICKS}
            rows[arm].append(r)
            log(f"relock [headline] {arm} pass {rep}: {LOSS_STREAMS} "
                f"redetects, host {r['host_ms_p50']:.3f} ms p50 "
                f"({r['host_ms_mean']:.3f} mean), device "
                f"{r['device_ms']:.3f} ms, {r['device_ops']:.2f} device ops, "
                f"{r['host_launches']:.2f} host launch calls, "
                f"{r['host_reads']:.2f} host reads a relock tick")
    if L.launches["scan_step"] != steps0:
        raise AssertionError(f"relock: scan_step ran "
                             f"{L.launches['scan_step'] - steps0} times")
    return rows


def sched_frames(pool, dev, n):
    """Phase 15's second scan, (SCHED_K, n, H, W, 3) on the card, from the
    pool's batches before its loss frame: SCHED_LOSSES[0] streams blue at
    tick 1 (a bucket tick follows), SCHED_LOSSES[1] others at tick 4 (a
    chunk tick); the faces of the last SCHED_ESCAPES[1] streams stretched
    to 120 rows of their color from tick 0, those of the last
    SCHED_ESCAPES[0] from tick 4.  A window grows to its stretched face
    over ~8 ticks and escapes the band once taller than it: the few
    streams escape first (within escape_bucket), then the many."""
    import numpy as np
    import torch
    from bench import _face_rgb
    seq = torch.as_tensor(pool[[(t + 1) % LOSS_AT for t in range(SCHED_K)]]
                          ).to(dev).clone()
    blue = torch.tensor([0, 0, 250], dtype=torch.uint8, device=dev)
    a, b = SCHED_LOSSES
    seq[1, :a] = blue
    seq[4, a:a + b] = blue
    skin = torch.as_tensor(np.median(_face_rgb().reshape(-1, 3), 0)
                           .astype(np.uint8)).to(dev)
    many, few = SCHED_ESCAPES
    for t in range(SCHED_K):
        for s in range(n - (many if t >= 4 else few), n):
            f = seq[t, s]
            rows, cols = torch.nonzero((f // 16 == skin // 16).all(-1),
                                       as_tuple=True)  # the face's bin
            if rows.numel():
                cy = int(rows.float().mean())
                f[max(0, cy - 60):cy + 60, int(cols.min()):int(cols.max())
                  + 1] = skin
    return seq


def phase_schedule(pool, dev):
    """Phase 15: the serving program, the device-scheduled tick whole on the
    card.  Its kernels first: tick_select and escape_select bit-equal to
    their twins on random vectors with ties at SCHED_NS streams, scan_step
    and scan_commit to theirs on the main path's frames and a headline
    tracker's state and outputs; each timed by graph replay beside its
    twin (events), its byte bound and one PyTorch call.  Then the headline
    configuration at 256 streams from init_state, twice: overload "full"
    (a cold start of 15 wbtrack ticks and a full tick, then bucket and
    chunk ticks after losses and band escapes beyond escape_bucket and
    within it) and overload "rotate" (the cold start's burst of 256 pending
    streams served chunk_cap at a time), each as two run_scan calls of
    SCHED_K ticks: every StepOutput leaf and the final state bit-equal to
    the per-tick path run eagerly (``_Steps.scheduled`` off) on the same
    frames; the program's bodies ran every branch and each schedule
    kernel ran once a tick (the runs the card reports, which the launch
    counters take); the per-tick path's host code (its eager branches, the
    state machine's host index lists, the host escape recompute) never
    reached; then one more scan under torch.profiler: one launch of the
    program, one host read, no kernel launched from the host.  Returns the
    kernels' errors and times, the launch counts of the scheduled runs and
    the numbers."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from headtrackr_tpu_torch import BatchedTracker
    from headtrackr_tpu_torch.kernels import histpdf as K
    from headtrackr_tpu_torch.kernels import launch as L
    from headtrackr_tpu_torch.kernels import schedule as S
    from headtrackr_tpu_torch.models import facetracker as ft
    from headtrackr_tpu_torch.runtime.serving import _clone

    from headtrackr_tpu_torch.kernels.build import load_library

    n = pool.shape[1]
    kw, _ = CONFIGS["headline"]
    err, times = dict.fromkeys(SCHED_KERNELS, 0.0), {}
    g = torch.Generator().manual_seed(18)
    for m in SCHED_NS:
        kb = min(kw["bucket"], m)
        cap = max(kb, (min(m, 4 * kb) // kb) * kb)
        for c in (cap, 8):
            got = load_library().fn("select_scratch_bytes")(m, c)
            if got != S.scratch_bytes(m, c):
                raise AssertionError(f"select scratch at N={m}, cap {c}: "
                                     f"{got} bytes in csrc, "
                                     f"{S.scratch_bytes(m, c)} in Python")
        for trial in range(8):
            mode = torch.randint(0, 3, (m,), generator=g, dtype=torch.int32)
            age = torch.randint(0, 4, (m,), generator=g, dtype=torch.int32)
            if trial == 1:
                mode[:] = ft.MODE_CS
                mode[torch.randperm(m, generator=g)[:kb]] = ft.MODE_VJ
            esc = torch.rand(m, generator=g) < (0.002, 0.02, 0.5)[trial % 3]
            for rotate in (False, True):
                params = torch.zeros(S.PARAM_WORDS, dtype=torch.int64,
                                     device=dev)
                idx = torch.empty(cap, dtype=torch.int64, device=dev)
                aout = torch.empty(m, dtype=torch.int32, device=dev)
                S.tick_select(mode.to(dev), age.to(dev), kb, cap, rotate,
                              idx, aout, params)
                b, want_i, want_a = S.tick_select_plain(mode, age, kb, cap,
                                                        rotate)
                eidx = torch.empty(8, dtype=torch.int64, device=dev)
                # the many body's list, small and big chunks of 16 and 64
                elist = torch.full((-(-m // 64) * 64,), -1,
                                   dtype=torch.int64, device=dev)
                S.escape_select(esc.to(dev), 8, eidx, params, elist, 16,
                                64)
                sel, want_e = S.escape_select_plain(esc, 8)
                want_l, plan = S.escape_list_plain(esc, 16, 64)
                torch.cuda.synchronize()
                if (int(params[S.P_BRANCH]) != b
                        or not torch.equal(idx.cpu(), want_i)
                        or not torch.equal(aout.cpu(), want_a)):
                    raise AssertionError(f"tick_select differs from its twin "
                                         f"at N={m} trial {trial}")
                if int(params[S.P_ESEL]) != sel or \
                        not torch.equal(eidx.cpu(), want_e) or \
                        (sel == 2 and not torch.equal(elist.cpu(), want_l)) \
                        or tuple(params[[S.P_CHUNKS, S.P_TAIL, S.P_TAILS]]
                                 .tolist()) != (plan if sel == 2
                                                else (0, 0, 0)):
                    raise AssertionError(f"escape_select differs from its "
                                         f"twin at N={m} trial {trial}")
    log(f"schedule: tick_select and escape_select (its many list and chunk "
        f"plan too, chunks of 16 and 64) equal their twins on random vectors "
        f"with ties at N = {SCHED_NS}, both overloads")

    # the main path's shapes: a bucket tick's selection at 256 streams
    mode = torch.full((n,), ft.MODE_CS, dtype=torch.int32)
    mode[:SCHED_LOSSES[0]] = ft.MODE_VJ
    age = torch.zeros(n, dtype=torch.int32)
    esc = torch.zeros(n, dtype=torch.bool)
    esc[-SCHED_ESCAPES[1]:] = True
    kb = kw["bucket"]
    cap = 4 * kb
    dmode, dage, desc = mode.to(dev), age.to(dev), esc.to(dev)
    params = torch.zeros(S.PARAM_WORDS, dtype=torch.int64, device=dev)
    idx = torch.empty(cap, dtype=torch.int64, device=dev)
    aout = torch.empty(n, dtype=torch.int32, device=dev)
    eidx = torch.empty(8, dtype=torch.int64, device=dev)
    key = torch.where(dmode != ft.MODE_CS, 1 + dage.long(), 0)
    # mode read and pend_age written for every stream, pend_age read for
    # the pending ones, the slots written
    sel_bytes = 8 * n + 4 * SCHED_LOSSES[0] + 8 * cap

    def select():
        S.tick_select(dmode, dage, kb, cap, False, idx, aout, params)

    def escape():
        S.escape_select(desc, 8, eidx, params)

    times["tick_select"] = {
        "ms": cuda_ms(select), "graph_ms": graph_ms(select),
        "plain_ms": cuda_ms(lambda: S.tick_select_plain(dmode, dage, kb, cap,
                                                        False)),
        **dict(zip(("bound_ms", "bound_by"), bound(sel_bytes, 0))),
        **library_times(lambda: torch.topk(key, cap), True)}
    times["escape_select"] = {
        "ms": cuda_ms(escape), "graph_ms": graph_ms(escape),
        "plain_ms": cuda_ms(lambda: S.escape_select_plain(desc, 8)),
        **dict(zip(("bound_ms", "bound_by"), bound(n + 64, 0))),
        **library_times(lambda: torch.topk(desc.int(), 8), True)}
    sizes = {}
    for m in SCHED_NS:
        sizes.update(select_times(m, dev))
    for name in ("tick_select", "escape_select"):
        times[name]["sizes"] = {k.split(" ", 1)[1]: v
                                for k, v in sizes.items()
                                if k.startswith(name)}

    bt = BatchedTracker(n, (H, W), device=dev, **kw)
    bt.warmup(scan_len=SCHED_K)
    prog = bt._steps._programs[n]
    seq = torch.as_tensor(pool[:2]).to(dev)
    frames = torch.empty_like(seq[0])
    p0 = torch.zeros(S.PARAM_WORDS, dtype=torch.int64)
    p0[S.P_K], p0[S.P_TICKS], p0[S.P_FRAMES] = 1, 2, seq.data_ptr()
    p0[S.P_FRAME_AT] = seq[1].data_ptr()  # as tick_select writes it
    p0 = p0.to(dev)
    # scan_step's modes on a poisoned buffer: whole; rows, a bucket tick's
    # 8 slots (SCHED_LOSSES[0] served, the rest padding)
    served = SCHED_LOSSES[0]
    slots = torch.tensor(list(range(served)) + [n] * (kw["bucket"] - served),
                         dtype=torch.int64, device=dev)
    want = torch.empty_like(frames)
    for rows in (None, slots):
        frames.fill_(255)
        want.fill_(255)
        S.scan_step(p0, frames, rows)
        S.scan_step_plain(seq[1], want, rows)
        torch.cuda.synchronize()
        e = float((frames.int() - want.int()).abs().max())
        err["scan_step"] = max(err["scan_step"], e)
        if e:
            mode = "whole" if rows is None else "rows"
            raise AssertionError(f"scan_step ({mode}) differs from its twin")

    def step_once():
        S.scan_step(p0, frames)

    def step_rows():
        S.scan_step(p0, frames, slots)

    row_bytes = frames.numel() // n
    # the library call writes the same buffer: a copy's rate on the card
    # depends on where its destination lies
    times["scan_step"] = {
        "ms": cuda_ms(step_once), "graph_ms": graph_ms(step_once),
        "plain_ms": cuda_ms(lambda: S.scan_step_plain(seq[1], want)),
        **dict(zip(("bound_ms", "bound_by"), bound(2 * frames.numel(), 0))),
        **library_times(lambda: frames.copy_(seq[1]), True)}
    times["scan_step rows"] = {
        "slots": kw["bucket"], "served": served,
        "ms": cuda_ms(step_rows), "graph_ms": graph_ms(step_rows),
        "plain_ms": cuda_ms(lambda: S.scan_step_plain(seq[1], want, slots)),
        **dict(zip(("bound_ms", "bound_by"),
                   bound(2 * served * row_bytes, 0))),
        **library_times(lambda: frames.index_copy_(
            0, slots[:served], seq[1].index_select(0, slots[:served])),
            True)}
    # histpdf_band reading tick k's frames in place (through the word that
    # tick_select sets) against its direct read of them, bit for bit and
    # timed in turns, on the headline's band at the bench pool's faces
    boxes = torch.as_tensor(face_boxes(pool[1])).to(dev)
    model = K.histpdf_band(seq[1], boxes)
    word = p0[S.P_FRAME_AT:S.P_FRAME_AT + 1]
    frames.fill_(255)

    def in_place():
        with L.frames_at(frames, word):
            return K.histpdf_band(frames, boxes, model, BAND)

    def direct():
        return K.histpdf_band(seq[1], boxes, model, BAND)

    for a, b in zip(in_place(), direct()):
        if not torch.equal(a, b):
            raise AssertionError("histpdf_band in place differs from its "
                                 "direct read")
    ip, dr = [], []
    for _ in range(2):  # direct, in place, in place, direct
        dr.append(graph_ms(direct))
        ip += [graph_ms(in_place), graph_ms(in_place)]
        dr.append(graph_ms(direct))
    times["histpdf_band in place"] = {"graph_ms": ip, "direct_graph_ms": dr}
    log(f"schedule: scan_step rows mode ({served} of {kw['bucket']} slots) "
        f"and whole bit-equal to their twins on a poisoned buffer; rows "
        f"{times['scan_step rows']['graph_ms']:.4f} graph ms (bound "
        f"{times['scan_step rows']['bound_ms']:.6f}); histpdf_band in place "
        f"bit-equal to its direct read, graph ms in turns: in place "
        f"{[round(x, 5) for x in ip]}, direct {[round(x, 5) for x in dr]}")
    times["scan_commit"] = commit_times(prog, dev)
    for k, t in sizes.items():
        log(f"schedule: {k}: {t['ms']:.4f} ms, graph replay "
            f"{t['graph_ms']:.4f} ms; an empty kernel at its grid "
            f"({t['ctas']} CTAs) {t['floor_graph_ms']:.4f}; torch.topk "
            f"{t['topk_ms']:.4f} / {t['topk_graph_ms']:.4f}; bound "
            f"{t['bound_ms']:.7f} (bytes)")
    for k in SCHED_KERNELS:
        t = times[k]
        log(f"schedule: {k} {t['ms']:.4f} ms, graph replay "
            f"{t['graph_ms']:.4f} ms vs twin "
            f"{t['plain_ms']:.4f}, bound {t['bound_ms']:.6f} "
            f"({t['bound_by']}), library {t['library_ms']:.4f} / "
            f"{fmt_ms(t['library_graph_ms'])}")
    del bt, prog

    # the device-scheduled tick against the per-tick path, from init_state
    cold = torch.as_tensor(pool[[0] * SCHED_K]).to(dev)
    second = sched_frames(pool, dev, n)
    counts, runs, numbers = {}, {}, {}
    for overload in ("full", "rotate"):
        mk = lambda: BatchedTracker(n, (H, W), device=dev,  # noqa: E731
                                    overload=overload,
                                    escape_bucket=SCHED_EB, **kw)
        bt, ref = mk(), mk()
        ref._steps.scheduled = False
        t0 = time.perf_counter()
        bt.warmup(scan_len=SCHED_K)
        t_build = time.perf_counter() - t0
        prog = bt._steps._programs[n]
        torch.cuda.synchronize()
        L.reset_launches()
        got, ran = [], np.zeros(16, int)
        t0 = time.perf_counter()
        chunks = 0
        for seq in (cold, second):
            poison(prog)  # a body reading them stale differs
            got.append(bt.run_scan(seq))
            ran += np.array(prog.runs)
            chunks += prog.chunks
        torch.cuda.synchronize()
        t_scan = time.perf_counter() - t0
        counts[overload] = dict(L.launches)
        # the schedule kernels' counts, which the card reports in the
        # program's parameter block: one run of each a tick; scan_step's
        # none (no body copies a frame: the launch counts of the bodies'
        # captured kernels hold none)
        want_runs = dict.fromkeys(SCHED_KERNELS, 2 * SCHED_K)
        want_runs["scan_step"] = 0
        # scan_commit: one more a few body's run (its rows after the tick
        # body's table) and one more a many body's chunk (its rows after
        # the tick body's table with the escaped rows held)
        want_runs["scan_commit"] += int(ran[9]) + chunks
        if chunks != many_chunks(bt, got):
            raise AssertionError(f"schedule [{overload}]: {chunks} chunks "
                                 f"of {ran[10]} many bodies, not "
                                 f"{many_chunks(bt, got)}")
        off = {k: counts[overload][k] for k in SCHED_KERNELS
               if counts[overload][k] != want_runs[k]}
        if off:
            raise AssertionError(f"schedule [{overload}]: the card reports "
                                 f"runs other than {want_runs} for "
                                 f"{2 * SCHED_K} ticks: {off}")
        if any(L.host_paths.values()):
            raise AssertionError(f"schedule [{overload}]: the per-tick "
                                 f"path's host code ran: {L.host_paths}")
        want = [ref.run_scan(seq) for seq in (cold, second)]
        torch.cuda.synchronize()
        same_bits(got, want, f"schedule [{overload}]")
        same_bits([bt.state], [ref.state], f"schedule [{overload}] state")
        m = prog.cap // prog.kb
        entry = torch.cat([o.detection for o in got]).cpu().numpy()
        npend = (entry != ft.MODE_CS).sum(1)
        need = {"wbtrack": m + 1}
        need.update({"track": 0, "full": m + 2} if overload == "full"
                    else {})
        missing = [b for b, i in need.items() if not ran[i]]
        if not ran[1:m + 1].any():
            missing.append("bucket")
        if overload == "full" and not (ran[2:m + 1].any()):
            missing.append("chunks")
        if overload == "full" and not (ran[9] and ran[10]):
            missing.append("escape few and many")
        if overload == "rotate" and not (ran[m] and npend.max() > prog.cap):
            missing.append("rotation")
        if missing:
            raise AssertionError(f"schedule [{overload}]: no {missing} tick "
                                 f"(body runs {ran.tolist()})")
        escapes = torch.cat([o.escaped for o in got]).sum(1).tolist()
        runs[overload] = ran.tolist()
        numbers[overload] = {"build_s": t_build,
                             "ms_per_tick": 1e3 * t_scan / (2 * SCHED_K),
                             "pending_max": int(npend.max()),
                             "escapes_per_tick": escapes}
        log(f"schedule [{overload}]: program built in {t_build:.2f} s; two "
            f"run_scan calls of {SCHED_K} ticks from init_state equal the "
            f"per-tick path run eagerly, every leaf and the final state bit "
            f"for bit; body runs {ran.tolist()} (track, bucket x{m}, "
            f"wbtrack{', full' if overload == 'full' else ''}; escape few "
            f"{ran[9]}, many {ran[10]}); pending at most {npend.max()}; "
            f"escapes a tick {escapes}; host code of the per-tick path "
            f"not reached; scan_step runs {want_runs['scan_step']} of "
            f"{2 * SCHED_K} ticks, the frame buffer freed; "
            f"{numbers[overload]['ms_per_tick']:.3f} ms/tick")
        if overload == "full":  # all-CS scans: no copy; one profiled
            seq = torch.as_tensor(pool[[t % LOSS_AT
                                        for t in range(SCHED_K)]]).to(dev)
            bt.run_scan(seq)
            steps0 = L.launches["scan_step"]
            o = bt.run_scan(seq)
            torch.cuda.synchronize()
            if (o.detection != ft.MODE_CS).any() or o.escaped.any():
                raise AssertionError("schedule: the steady scan is not "
                                     "all-CS without escapes")
            numbers["all_cs_scan_steps"] = L.launches["scan_step"] - steps0
            if numbers["all_cs_scan_steps"]:
                raise AssertionError(f"schedule: an all-CS scan of "
                                     f"{SCHED_K} ticks ran scan_step "
                                     f"{numbers['all_cs_scan_steps']} times")
            log(f"schedule: an all-CS run_scan of {SCHED_K} ticks: "
                f"scan_step {numbers['all_cs_scan_steps']} runs")
            launches0 = prog.launches
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as pr:
                bt.run_scan(seq)
            events = pr.events()
            dev_ops = [e for e in events if e.device_type
                       == torch.autograd.DeviceType.CUDA]
            p = {"program_launches": prog.launches - launches0,
                 "host_graph_launches": sum(e.name in ("cudaGraphLaunch",
                                                       "cuGraphLaunch")
                                            for e in events),
                 "host_kernel_launches": sum(
                     e.name in HOST_LAUNCHES and "Graph" not in e.name
                     for e in events),
                 "host_reads": sum(e.name in HOST_SYNCS for e in events),
                 "device_ops_per_tick": len(dev_ops) / SCHED_K,
                 "device_ms_per_tick": sum(e.device_time_total
                                           for e in dev_ops) / 1e3 / SCHED_K}
            if p["program_launches"] != 1 or p["host_reads"] != 1 or \
                    p["host_kernel_launches"]:
                raise AssertionError(f"schedule: a scan is not one launch "
                                     f"and one host read: {p}")
            numbers["profile"] = p
            log(f"schedule: a profiled run_scan of {SCHED_K} all-CS ticks: "
                f"{p['program_launches']} program launch "
                f"({p['host_graph_launches']} graph launch calls seen), "
                f"{p['host_reads']} host read, {p['host_kernel_launches']} "
                f"kernel launches from the host; "
                f"{p['device_ops_per_tick']:.2f} device ops and "
                f"{p['device_ms_per_tick']:.3f} device ms a tick")
            numbers["many"] = many_ticks(bt, seq[1], SCHED_MANY, "schedule")
            # the many body over several chunks of each size
            chunked = mk()
            chunked._steps.escape_chunk, chunked._steps.escape_tail = \
                SCHED_CHUNKS
            chunked.warmup(scan_len=1)
            chunked.set_state(_clone(bt.state), bt.modes.copy())
            numbers["many_chunked"] = many_ticks(
                chunked, seq[1], SCHED_CHUNKED_MANY,
                f"schedule, chunks of {SCHED_CHUNKS}")
            del chunked
        del bt, ref, prog
    launches = {k: counts["full"][k] + counts["rotate"][k]
                for k in counts["full"]}
    numbers["big"] = phase_schedule_big(pool, dev)
    return {"err": err, "times": times, "launches": launches, "runs": runs,
            **numbers}


def poison(prog):
    """Fill the many escape body's list and chunk slots (elist, cidx,
    tidx) with stream 0, and check that the bodies' frame buffer was freed
    once they were captured: a chunk that read a list or slots its tick
    did not write, or a body that read the buffer where it should read
    tick k's frames, would differ."""
    if prog.bufs._frames is not None:
        raise AssertionError("the serving program holds its bodies' frame "
                             "buffer after their capture")
    for t in (prog.bufs.elist, prog.bufs.cidx, prog.bufs.tidx):
        t.fill_(0)


def many_chunks(bt, outs):
    """The many escape body's chunks over run_scan outputs ``outs``: on a
    tick that escapes more than escape_bucket streams (or any, where
    escape_bucket covers the batch), its big and small chunks
    (``schedule.chunk_plan``)."""
    from headtrackr_tpu_torch.kernels import schedule as S
    eb, runs = bt._steps.escape_bucket, 0
    for o in outs:
        n = o.escaped.shape[-1]
        m, ms = bt._steps.chunk_rows(n)
        for e in o.escaped.sum(-1).reshape(-1).tolist():
            if e > eb or (e and eb >= n):
                big, tail0, tails = S.chunk_plan(e, ms, m)
                runs += big + tails - tail0
    return runs


def spread(n, e):
    """E streams of n spread evenly, the first and the last among them."""
    if e >= n:
        return list(range(n))
    return sorted({round(i * (n - 1) / (e - 1)) for i in range(e)})


def tall_windows(state, idx, rows):
    """A copy of ``state`` whose search windows of the streams ``idx`` are
    TALL rows high around their centres (frames of ``rows`` rows): taller
    than the band, so that those streams escape on the next tick."""
    import torch
    from headtrackr_tpu_torch.runtime.serving import _clone
    state = _clone(state)
    win = state.cs.window
    idx = torch.as_tensor(idx, device=win.device)
    cy = win[idx, 1] + win[idx, 3] // 2
    win[idx, 1] = torch.clamp(cy - TALL // 2, 0, rows - TALL)
    win[idx, 3] = TALL
    return state


def many_ticks(bt, frame, counts, where):
    """Many escape ticks of the headline tracker ``bt`` (warmed, locked,
    all-CS) on ``frame``: for each E of ``counts``, from its state with the
    windows of ``spread(N, E)`` streams made taller than the band
    (``tall_windows``), one step_auto tick through the program and one
    through the per-tick path (``_Steps.scheduled`` off: the host
    recompute), every output and the state after it bit-equal; exactly
    those streams escaped, the many body ran once in its chunk plan's big
    and small chunks (``schedule.chunk_plan``);
    then that tick's device span with the host's enqueue hidden behind a
    spin (``torch.cuda._sleep``: every chunk), and once more under
    torch.profiler (device ms and operations: the whole tick where it
    runs one chunk; the profiler keeps a WHILE node's later iterations in
    part or not at all).
    ``bt``'s state is restored.  {E: numbers}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from headtrackr_tpu_torch.kernels import schedule as S
    from headtrackr_tpu_torch.runtime.serving import _clone
    n = frame.shape[0]
    steps = bt._steps
    prog = steps._programs[n]
    m, ms = prog.bufs.m, prog.bufs.ms
    clean, modes = _clone(bt.state), bt.modes.copy()

    def set_state(state):
        torch._foreach_copy_(_leaves_of(bt.state), _leaves_of(state))
        bt.set_state(bt.state, modes)

    out = {}
    for e in counts:
        idx = spread(n, e)
        start = tall_windows(clean, idx, frame.shape[1])
        res = []
        for scheduled in (True, False):
            steps.scheduled = scheduled
            set_state(start)
            o = bt.step_auto(frame)
            res.append((_host_tree(o), _host_tree(bt.state)))
            if scheduled:
                runs, chunks = list(prog.runs), prog.chunks
                big = prog.big_chunks
        steps.scheduled = True
        same_bits([res[0][0]], [res[1][0]], f"{where}: many {e}")
        same_bits([res[0][1]], [res[1][1]], f"{where}: many {e} state")
        got = torch.nonzero(res[0][0].escaped).flatten().tolist()
        want_big, tail0, tails = S.chunk_plan(len(idx), ms, m)
        if got != idx or runs[10] != 1 or \
                (big, chunks - big) != (want_big, tails - tail0):
            raise AssertionError(f"{where}: many {e}: escaped {len(got)} "
                                 f"streams, many body runs {runs[10]}, "
                                 f"{big} big chunks of {m} and "
                                 f"{chunks - big} small of {ms}, not "
                                 f"{want_big} and {tails - tail0}")
        spans = []
        for _ in range(3):
            set_state(start)
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(5_000_000)  # the host enqueues meanwhile
            a.record()
            bt.step_auto(frame)
            b.record()
            torch.cuda.synchronize()
            spans.append(a.elapsed_time(b))
        set_state(start)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as pr:
            bt.step_auto(frame)
        dev_ops = [e_ for e_ in pr.events()
                   if e_.device_type == torch.autograd.DeviceType.CUDA]
        out[e] = {"chunks": [big, chunks - big], "chunk_rows": [m, ms],
                  "busy_span_ms": sorted(spans)[1],
                  "profiled_device_ops": len(dev_ops),
                  "profiled_device_ms": sum(e_.device_time_total
                                               for e_ in dev_ops) / 1e3}
        log(f"{where}: a many escape tick of {e} of {n} streams (the first "
            f"and the last among them) bit-equal to the per-tick path, "
            f"{big} big chunks of {m} rows and {chunks - big} small of "
            f"{ms}: "
            f"{out[e]['busy_span_ms']:.4f} device span ms (every chunk); "
            f"profiled {out[e]['profiled_device_ms']:.4f} device ms, "
            f"{out[e]['profiled_device_ops']} device operations (of a "
            f"tick of one chunk; of more, what the profiler kept)")
    set_state(clean)
    return out


def commit_times(prog, dev):
    """scan_commit on a program's own tables: the all-CS body's (its model
    histograms passed through: no entry), that table with the escaped
    streams' rows held ("held": a many escape tick's, SCHED_MANY[0]
    streams spread over the batch), the bucket body's at kb slots (the
    relock tick's: the track pass's changed leaves whole, the sub-batch's
    rows merged by its slot map, the model histograms by their served
    rows alone), the few escape body's and one chunk's of the many body
    (the kept rows alone of what its step changed), each into copies of
    the state (a merge writes only its rows) and a scan's packs of 2
    ticks, bit-equal to scan_commit_plain; timed by events and graph
    replay beside its twin, its byte bound (each table's bytes read and
    written; the held table's all the same) and one torch._foreach_copy_
    over the entries with a source (none for the escape bodies' tables,
    which have none).  The all-CS table's numbers at the top level, each
    table's under "tables"."""
    import torch
    from headtrackr_tpu_torch.kernels import schedule as S
    bodies = {"all-CS": prog.bodies[0], "held": prog.bodies[0],
              "bucket": prog.bodies[1], "few": prog.few, "many": prog.many}
    # the big chunk's slots and kept flags as a many tick of SCHED_MANY[0]
    # escapes leaves them (a poisoned or never-run chunk's are not a map)
    n, m = prog.bufs.age.shape[0], prog.bufs.m
    slots = torch.full((m,), n, dtype=torch.int64)
    slots[:SCHED_MANY[0]] = torch.tensor(spread(n, SCHED_MANY[0]))
    prog.bufs.cidx.copy_(slots)
    prog.many.merge.keep.copy_(slots < n)
    packs = [torch.empty((shape[0], 2) + shape[1:], dtype=dt, device=dev)
             for dt, shape in prog.bufs.packs.items()]
    tables, held_dsts = [], []
    for name, body in bodies.items():
        carry, rows, *slots = (
            prog._few_pairs(body.merge) if name in ("few", "many") else
            prog._commit_pairs(body.state, body.out, body.merge))
        clones = [(c[0], c[1].clone()) + tuple(c[2:]) for c in carry]
        if name == "held":
            held_dsts = [d[1] for c, d in zip(carry, clones)
                         if any(c[1] is h for h in prog.held)]
        tables.append((clones, rows, *slots))
    ct = S.segments(tables, dev, held_dsts)
    esc = torch.zeros(n, dtype=torch.bool, device=dev)
    esc[spread(n, SCHED_MANY[0])] = True
    esc_at = torch.tensor([esc.data_ptr()], dtype=torch.int64, device=dev)
    p = torch.zeros(S.PARAM_WORDS, dtype=torch.int64)
    p[S.P_K], p[S.P_TICKS] = 1, 2  # row k - 1 = 0
    for j, pk in enumerate(packs):
        p[S.P_OUT + j] = pk.data_ptr()
    p = p.to(dev)
    out = {}
    for t, (name, (carry, rows, *slots)) in enumerate(zip(bodies, tables)):
        want = [c[1].clone() for c in carry]
        want_packs = [torch.zeros_like(pk) for pk in packs]
        for pk in packs:
            pk.zero_()
        hold = esc_at if name == "held" else None
        S.scan_commit(p, ct, t, hold)
        plain = lambda: S.scan_commit_plain(  # noqa: E731
            0, [(c[0], w) + tuple(c[2:]) for c, w in zip(carry, want)],
            [(r[0], want_packs[r[1]], r[2]) + tuple(r[3:]) for r in rows],
            *(slots or [None]), hold=S.Hold(esc, tuple(
                w for c, w in zip(carry, want)
                if any(c[1] is h for h in held_dsts))) if hold is not None
            else None)
        plain()
        torch.cuda.synchronize()
        for a, b in zip([c[1] for c in carry] + [pk[:, 0] for pk in packs],
                        want + [pk[:, 0] for pk in want_packs]):
            if not torch.equal(a, b):
                raise AssertionError(f"scan_commit ({name}) differs from "
                                     f"its twin")
        first, count = ct.tables[t, :2].tolist()
        moved = int(ct.segs[first:first + count, 2].sum())
        whole = [c for c in carry if c[0] is not None]
        sourced = [r for r in rows if r[0] is not None]
        srcs = [c[0] for c in whole] + [r[0] for r in sourced]
        dsts = [c[1] for c in whole] + [packs[r[1]][r[2], 0]
                                        for r in sourced]
        commit = lambda t=t, h=hold: S.scan_commit(p, ct, t, h)  # noqa
        out[name] = {
            "entries": count, "bytes": moved,
            "merged_entries": sum(len(c) > 2 for c in carry)
            + sum(len(r) > 3 for r in rows),
            "passed_through_bytes": sum(
                d.nbytes for d in _leaves_of(prog.bufs.state_in))
            - sum(c[1].nbytes for c in whole),
            "ms": cuda_ms(commit), "graph_ms": graph_ms(commit),
            "plain_ms": cuda_ms(plain),
            **dict(zip(("bound_ms", "bound_by"), bound(2 * moved, 0))),
            **(library_times(lambda: torch._foreach_copy_(dsts, srcs), True)
               if srcs else {"library_ms": None,
                             "library_graph_ms": None})}
    held = {id(t) for t in _leaves_of(prog.bufs.state_in)}
    kept = {}
    for key, body in zip([str(k) for k in range(len(prog.bodies))]
                         + ["few", "many", "tail"],
                         prog.bodies + [prog.few, prog.many, prog.tail]):
        if body is not None:
            extra = [] if body.merge is None else (
                _leaves_of(body.merge.state) + list(body.merge.out))
            leaves = {t.data_ptr(): t.nbytes for t in
                      _leaves_of(body.state) + _leaves_of(body.out) + extra
                      if id(t) not in held}
            kept[key] = sum(leaves.values())
    out["all-CS"]["kept_bytes_per_body"] = kept
    log(f"schedule: the results each body keeps, bytes by body "
        f"(tick bodies by index, few, many, tail): {kept}")
    def library(v):
        return ("none: no source" if v["library_ms"] is None
                else fmt_ms(v["library_graph_ms"]))

    log(f"schedule: scan_commit bit-equal to its twin on {list(bodies)} "
        f"tables at {prog.bufs.age.shape[0]} streams: " + "; ".join(
            f"{k} {v['bytes']} B ({v['merged_entries']} merged entries), "
            f"graph {v['graph_ms']:.4f} ms (bound {v['bound_ms']:.4f}, "
            f"_foreach_copy_ {library(v)})" for k, v in out.items()))
    return {**out["all-CS"], "tables": out}


def _leaves_of(tree):
    """The tensors of a NamedTuple tree (None leaves skipped)."""
    return [t for _, t in _named(tree)]


def select_times(n, dev):
    """tick_select and escape_select at n streams, timed by
    tools/torch_select_times.py's select_cases (the headline's bucket 8,
    chunk cap 32, escape bucket 8; a bucket tick of 4 pending VJ streams
    and 3 escaped, and an all-CS tick: events and graph ms, torch.topk
    over the keys, an empty kernel at the grid), with each select's CTAs
    and byte bound.  {"<kernel> <n> <case>": numbers}."""
    from headtrackr_tpu_torch.kernels import schedule as S
    tool = load_example(os.path.dirname(os.path.abspath(__file__)),
                        "torch_select_times", "tools")
    out = {}
    tool.select_cases(n, dev, out)
    cap = 4 * tool.BUCKET
    for label, t in out.items():
        if not isinstance(t, dict):
            raise AssertionError(f"schedule: {label}: {t}")
        name, _, case = label.split()
        pending = tool.PENDING if case == "bucket" else 0
        c, nbytes = ((cap, 8 * n + 4 * pending + 8 * cap)
                     if name == "tick_select" else (tool.EB, n + 8 * tool.EB))
        t.update(ctas=S.select_blocks(n, c)[0], bound_ms=bound(nbytes, 0)[0])
    return out


def _named(tree, prefix=""):
    """The (name, tensor) leaves of a StepOutput or TrackerState."""
    if isinstance(tree, tuple):
        return [leaf for name, t in zip(tree._fields, tree)
                for leaf in _named(t, prefix + name + ".")]
    return [] if tree is None else [(prefix[:-1], tree)]


def _host_tree(tree):
    """A StepOutput or TrackerState with every tensor copied to the host."""
    if isinstance(tree, tuple):
        return type(tree)(*(_host_tree(t) for t in tree))
    return None if tree is None else tree.cpu()


def phase_schedule_big(pool, dev):
    """Phase 15's run past the 4,096 streams one select CTA once took: the
    headline at SCHED_BIG streams from init_state, the pool's streams
    tiled on the card (a host pool would be 38 GB), run_scan calls of
    SCHED_BIG_K ticks (9.4 GB staged a call).  Under "full" (the cold
    start's wbtrack and full ticks, steady ticks, a full tick after
    SCHED_BIG_LOSS losses a 256 streams) and "rotate" (the cold start's
    burst of every stream pending, served chunk_cap a tick, with the
    pool's losses on top): every StepOutput leaf and the final state
    bit-equal to the per-tick path run eagerly on the same frames; one
    program launch a run_scan call; each schedule kernel run once a tick
    (the card's counts); the per-tick path's host code never reached.
    Under "full" each stream s also bit-equal to stream s mod 256 of a
    256-stream program run on the same ticks, and then: host ms a tick of
    the cold start's scans, host ms and device span (CUDA events) a tick
    of 5 all-CS scans, and one more all-CS scan profiled (one program
    launch, one host read, no kernel launched from the host)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from headtrackr_tpu_torch import BatchedTracker
    from headtrackr_tpu_torch.kernels import launch as L
    from headtrackr_tpu_torch.models import facetracker as ft

    base_n = pool.shape[1]
    n, tile, K = SCHED_BIG, SCHED_BIG // base_n, SCHED_BIG_K
    kw, _ = CONFIGS["headline"]
    loss_tick = 16 + LOSS_AT - 4
    order = [0] * 16 + [4 + t for t in range(SCHED_BIG_TICKS - 16)]
    base = torch.as_tensor(pool[order]).to(dev)
    blue = torch.tensor([0, 0, 250], dtype=torch.uint8, device=dev)
    numbers = {}

    def tiled(seq, k0):
        return seq[k0:k0 + K].repeat(1, tile, 1, 1, 1)

    for overload in ("full", "rotate"):
        seq = base
        if overload == "full":
            seq = base.clone()
            seq[loss_tick, :SCHED_BIG_LOSS] = blue

        def mk(m):
            return BatchedTracker(m, (H, W), device=dev, overload=overload,
                                  escape_bucket=SCHED_EB, **kw)

        bt = mk(n)
        t0 = time.perf_counter()
        bt.warmup(scan_len=K)
        t_build = time.perf_counter() - t0
        prog = bt._steps._programs[n]
        torch.cuda.synchronize()
        L.reset_launches()
        got, host_ms, ran, chunks = [], [], np.zeros(16, int), 0
        for k0 in range(0, SCHED_BIG_TICKS, K):
            frames = tiled(seq, k0)
            poison(prog)  # a body reading them stale differs
            torch.cuda.synchronize()
            before = prog.launches
            t0 = time.perf_counter()
            out = bt.run_scan(frames)
            host_ms.append(1e3 * (time.perf_counter() - t0) / K)
            if prog.launches - before != 1:
                raise AssertionError(f"schedule big [{overload}]: a run_scan "
                                     f"call made {prog.launches - before} "
                                     f"program launches")
            got.append(_host_tree(out))
            ran += np.array(prog.runs)
            chunks += prog.chunks
            del frames
        counts = dict(L.launches)
        want_runs = dict.fromkeys(SCHED_KERNELS, SCHED_BIG_TICKS)
        want_runs["scan_step"] = 0  # no body copies a frame
        want_runs["scan_commit"] += int(ran[9]) + chunks
        if chunks != many_chunks(bt, got):
            raise AssertionError(f"schedule big [{overload}]: {chunks} "
                                 f"chunks, not {many_chunks(bt, got)}")
        off = {k: counts[k] for k in SCHED_KERNELS
               if counts[k] != want_runs[k]}
        if off or any(L.host_paths.values()):
            raise AssertionError(f"schedule big [{overload}]: schedule "
                                 f"kernels' runs {off}, not {want_runs}; "
                                 f"host paths {L.host_paths}")
        state = _host_tree(bt.state)
        ref = mk(n)
        ref._steps.scheduled = False
        want = []
        for k0 in range(0, SCHED_BIG_TICKS, K):
            want.append(_host_tree(ref.run_scan(tiled(seq, k0))))
        same_bits(got, want, f"schedule big [{overload}]")
        same_bits([state], [_host_tree(ref.state)],
                  f"schedule big [{overload}] state")
        del ref
        entry = torch.cat([o.detection for o in got])
        npend = (entry != ft.MODE_CS).sum(1)
        r = {"build_s": t_build, "host_ms_per_tick": host_ms,
             "pending_per_tick": npend.tolist(),
             "runs": ran.tolist(), "scan_step_runs": want_runs["scan_step"]}
        if overload == "full":
            r["commit"] = commit_times(prog, dev)
            small = mk(base_n)
            small.warmup(scan_len=K)
            few = [_host_tree(small.run_scan(seq[k0:k0 + K]))
                   for k0 in range(0, SCHED_BIG_TICKS, K)]
            pairs = [(f"scan {k} {name}", u, v, 1)
                     for k, (a, b) in enumerate(zip(got, few))
                     for (name, u), (_, v) in zip(_named(a), _named(b))]
            pairs += [(f"state {name}", u, v, 0) for (name, u), (_, v) in
                      zip(_named(state), _named(_host_tree(small.state)))]
            for where, u, v, lead in pairs:  # stream s vs s mod 256
                u = _bits(u).reshape(u.shape[:lead] + (tile, base_n)
                                     + u.shape[lead + 1:])
                if not (u == np.expand_dims(_bits(v), lead)).all():
                    raise AssertionError(f"schedule big: {where}: a stream "
                                         f"differs from its copy in the "
                                         f"{base_n}-stream run")
            del small
            steady = torch.as_tensor(pool[[t % LOSS_AT for t in range(K)]]
                                     ).to(dev).repeat(1, tile, 1, 1, 1)
            bt.run_scan(steady)
            torch.cuda.synchronize()
            scan_ms, span_ms, pend, copies = [], [], 0, 0
            for _ in range(5):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                a.record()
                o = bt.run_scan(steady)
                b.record()
                scan_ms.append(1e3 * (time.perf_counter() - t0) / K)
                torch.cuda.synchronize()
                span_ms.append(a.elapsed_time(b) / K)
                pend += int((o.detection != ft.MODE_CS).sum())
                copies = L.launches["scan_step"] - counts["scan_step"]
                if copies:
                    raise AssertionError(f"schedule big: scan_step ran "
                                         f"{copies} times in steady scans")
            launches0 = prog.launches
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as pr:
                bt.run_scan(steady)
            events = pr.events()
            p = {"program_launches": prog.launches - launches0,
                 "host_kernel_launches": sum(
                     e.name in HOST_LAUNCHES and "Graph" not in e.name
                     for e in events),
                 "host_reads": sum(e.name in HOST_SYNCS for e in events)}
            if p["program_launches"] != 1 or p["host_reads"] != 1 or \
                    p["host_kernel_launches"]:
                raise AssertionError(f"schedule big: a scan is not one "
                                     f"launch and one host read: {p}")
            r.update(cold_host_ms_per_tick=sum(host_ms[:4]) / 4,
                     steady_host_ms_per_tick=scan_ms,
                     steady_span_ms_per_tick=span_ms,
                     steady_pending=pend, steady_scan_steps=copies,
                     profile=p)
            r["many"] = many_ticks(bt, steady[1], SCHED_BIG_MANY,
                                   "schedule big")
            del steady
        numbers[overload] = r
        log(f"schedule big [{overload}]: {n} streams, program built in "
            f"{t_build:.2f} s; {SCHED_BIG_TICKS} ticks from init_state in "
            f"run_scan calls of {K} equal the per-tick path, every leaf and "
            f"the final state bit for bit"
            + (f", and every stream its copy in the {base_n}-stream run"
               if overload == "full" else "")
            + f"; one launch a call; the schedule kernels' runs {want_runs} "
            f"(the card's counts); body runs {r['runs']}; pending a tick "
            f"{r['pending_per_tick']}; host ms a tick by call "
            f"{[round(x, 3) for x in host_ms]}")
        if overload == "full":
            log(f"schedule big: cold start {r['cold_host_ms_per_tick']:.3f} "
                f"host ms a tick; all-CS scans {r['steady_host_ms_per_tick']}"
                f" host ms and {r['steady_span_ms_per_tick']} device span ms "
                f"a tick ({r['steady_pending']} pending, "
                f"{r['steady_scan_steps']} scan_step runs); a profiled scan "
                f"{r['profile']}")
        del bt, prog, seq
    return numbers


def escape_lists(n, dev):
    """escape_select's list for the many escape body at n streams against
    its twin (escape_list_plain), bit for bit, and its chunk plan: random
    shares of escaped streams with the first and the last among them, and
    every stream, in small and big chunks of 32 and 256, 128 and 128.
    Returns the cases checked."""
    import torch
    from headtrackr_tpu_torch.kernels import schedule as S
    g = torch.Generator().manual_seed(n)
    cases = 0
    for share in (0.001, 0.3, 1.0):
        esc = torch.rand(n, generator=g) < share
        esc[[0, n - 1]] = True
        for m, mb in ((32, 256), (128, 128)):
            want, plan = S.escape_list_plain(esc, m, mb)
            params = torch.zeros(S.PARAM_WORDS, dtype=torch.int64,
                                 device=dev)
            eidx = torch.empty(SCHED_EB, dtype=torch.int64, device=dev)
            elist = torch.full_like(want, -1, device=dev)
            S.escape_select(esc.to(dev), SCHED_EB, eidx, params, elist, m,
                            mb)
            torch.cuda.synchronize()
            words = params[[S.P_CHUNKS, S.P_TAIL, S.P_TAILS]].tolist()
            if int(params[S.P_ESEL]) != 2 or tuple(words) != plan or \
                    not torch.equal(elist.cpu(), want):
                raise AssertionError(f"escape_select's list differs from "
                                     f"its twin at {n} streams, "
                                     f"{int(esc.sum())} escaped, chunks "
                                     f"of {m} and {mb}")
            cases += 1
    return cases


def phase_f32(dev, root):
    """Phase 16, F32: every kernel whose grid's y dimension is the stream
    at F32_N streams of 160x120 (tools/torch_f32_cases.py check: each
    wrapper a launch a chunk of 65,535 streams, bit-equal to its twin,
    histpdf_band also through the address word from a poisoned buffer);
    each launcher refusing 65,536 streams; then, with the launch counts at
    0, BatchedTracker(F32_N) from init_state over F32_TICKS ticks (the
    last F32_K one run_scan), the serving program bit-equal to the
    per-tick path, tick for tick and the final state, every kernel of
    F32_PATH launched in the program's own calls and scan_step none."""
    import torch
    from headtrackr_tpu_torch.kernels import launch as L
    cases = load_example(root, "torch_f32_cases", "tools")
    t0 = time.perf_counter()
    kernels = cases.check(F32_N, dev)
    bucket = load_example(root, "torch_bucket_cases", "tools").check(F32_N,
                                                                     dev)
    if bucket["launches"] != {"frame_prep": 4, "handoff": 4,
                              "slot_gather": 1}:
        raise AssertionError(f"f32: the bucket kernels at {F32_N}: {bucket}")
    took = cases.refusals()
    if took:
        raise AssertionError(f"f32: {took} took 65,536 streams a launch")
    lists = escape_lists(F32_N, dev)
    t_kernels = time.perf_counter() - t0
    torch.cuda.empty_cache()
    L.reset_launches()
    t0 = time.perf_counter()
    prog = cases.program_check(F32_N, dev, ticks=F32_TICKS, scan_k=F32_K)
    missing = [k for k in F32_PATH if not prog["launches"][k]]
    if missing or prog["launches"]["scan_step"]:
        raise AssertionError(f"f32: the program at {F32_N} streams "
                             f"launched no {missing}, scan_step "
                             f"{prog['launches']['scan_step']} times")
    torch.cuda.empty_cache()
    log(f"f32: at {F32_N} streams of 160x120 {sorted(kernels)} bit-equal "
        f"to their twins, {kernels['hist4096']['chunks']} launches each "
        f"(cascade: dense and deep a chunk, one compaction), frame_prep, "
        f"handoff and slot_gather bit-equal to their twins, one launch a "
        f"call ({bucket}), escape_select's many list bit-equal to its twin "
        f"({lists} cases), "
        f"{t_kernels:.1f} s; every launcher refuses 65,536; the program "
        f"over {F32_TICKS} ticks from init_state equals the per-tick path "
        f"(body runs {prog['runs']}, {prog['locked']} locked, "
        f"{prog['ms_per_tick']:.2f} host ms a tick), "
        f"{time.perf_counter() - t0:.1f} s")
    return {"kernels": kernels, "program": prog, "bucket": bucket,
            "escape_lists": lists}


def phase_card_vs_cpu(name, pool, dev):
    import numpy as np
    import torch
    from headtrackr_tpu_torch import BatchedTracker
    from headtrackr_tpu_torch.models.facetracker import StepOutput

    kw, _ = CONFIGS[name]
    ticks = [0] * 16 + list(range(4, 12))           # lock, track, lose, relock
    res = []
    for d in (dev, torch.device("cpu")):
        bt = BatchedTracker(2, (H, W), device=d, **kw)
        res.append([[t.cpu().numpy() for t in bt.step_auto(pool[i, :2])]
                    for i in ticks])
    for k, (a, b) in enumerate(zip(*res)):
        for field, x, y in zip(StepOutput._fields, a, b):
            if x.dtype.kind in "biu":
                ok = np.array_equal(x, y)
            else:
                ok = np.allclose(x, y, rtol=RTOL, atol=ATOL, equal_nan=True)
            if not ok:
                raise AssertionError(f"card vs CPU [{name}]: tick {k} "
                                     f"{field}: {x} vs {y}")
    log(f"card vs CPU [{name}]: 2 streams x {len(ticks)} ticks agree "
        f"(integers exact, floats rtol {RTOL} / atol {ATOL})")


def _listen(add, log):
    """Log (type, payload without ``time``) of the three event types."""
    from headtrackr_tpu_torch import events
    for ty in (events.STATUS, events.FACETRACKING, events.HEADTRACKING):
        add(ty, lambda e, ty=ty: log.append(
            (ty, {k: v for k, v in vars(e).items()
                  if k not in ("type", "time")})))


def _dedup(log):
    from headtrackr_tpu_torch import events
    st = [e["status"] for ty, e in log if ty == events.STATUS]
    return [x for i, x in enumerate(st) if i == 0 or st[i - 1] != x]


def phase_session(pool, dev):
    """Tracker(debug=True), real cascade, over one bench-pool loss stream:
    SESSION_FRAMES frames of 320x240 (16 of the lock frame, then the pool
    in order, so a blue loss frame every 16).  Returns the session's
    numbers, step_once's ms over all frames and by the frame's mode."""
    import math

    import numpy as np
    import torch
    from headtrackr_tpu_torch import ClipSource, Tracker, events
    from headtrackr_tpu_torch.kernels import launch as L
    from headtrackr_tpu_torch.models import facetracker as ft

    s = 0  # build_pool: the first LOSS_STREAMS streams lose their face
    clip = np.stack([pool[0, s]] * LOCK_TICKS
                    + [pool[t % POOL, s]
                       for t in range(SESSION_FRAMES - LOCK_TICKS)])
    bus = events.EventBus()
    evs = []
    _listen(bus.add_event_listener, evs)
    tr = Tracker(ui=False, bus=bus, debug=True, device=dev)
    if not tr.init(ClipSource(clip)) or tr._canvas_size != (W, H):
        raise AssertionError("session: init did not take the 320x240 clip")
    torch.cuda.synchronize()
    L.reset_launches()
    times, modes, n_bp = [], [], 0
    while True:
        t0 = time.perf_counter()
        out = tr.step_once()
        dt = time.perf_counter() - t0
        if out is None:
            break
        times.append(dt)
        modes.append(int(out.detection))
        if modes[-1] == ft.MODE_CS:
            bp = tr.get_debug()["backprojection"]
            if bp is None or bp.shape != (H, W, 3) or bp.dtype != np.uint8:
                raise AssertionError("session: no (240, 320, 3) u8 "
                                     "backprojection on a CS frame")
            n_bp += 1
    counts = dict(L.launches)
    if len(times) != SESSION_FRAMES:
        raise AssertionError(f"session: {len(times)} of {SESSION_FRAMES} "
                             f"frames stepped")
    seq = _dedup(evs)
    if seq[:3] != ["whitebalance", "detecting", "found"]:
        raise AssertionError(f"session: statuses {seq[:6]}")
    lost = [i for i, x in enumerate(seq) if x == "redetecting"]
    if len(lost) < 3 or any("found" not in seq[i:] for i in lost):
        raise AssertionError(f"session: no relock after each loss: {seq}")
    faces = [e for ty, e in evs if ty == events.FACETRACKING]
    heads = [e for ty, e in evs if ty == events.HEADTRACKING]
    for e in faces:
        vals = [e[k] for k in ("x", "y", "width", "height", "confidence")]
        if e["width"]:  # a zero-mass loss frame has a NaN angle
            vals.append(e["angle"])
        if not all(map(math.isfinite, vals)):
            raise AssertionError(f"session: non-finite payload {e}")
    if not heads or not all(math.isfinite(e[k]) for e in heads
                            for k in ("x", "y", "z")):
        raise AssertionError("session: no finite headtrackingEvents")
    missing = [k for k in ("hist_mma", "backproject_ratio")
               if counts[k] <= 0]
    if missing:
        raise AssertionError(f"session: kernels never launched: {missing}")
    ms, modes = 1e3 * np.asarray(times), np.asarray(modes)

    def stats(x):
        return {"frames": int(x.size), "ms_mean": float(x.mean()),
                "ms_p50": float(np.percentile(x, 50)),
                "ms_p99": float(np.percentile(x, 99)), "ms_max": float(x.max())}

    by_mode = {name: stats(ms[modes == m]) for name, m in
               (("WB", ft.MODE_WB), ("VJ", ft.MODE_VJ), ("CS", ft.MODE_CS))
               if (modes == m).any()}
    r = {**stats(ms), "by_mode": by_mode, "cs_frames": n_bp,
         "face_events": len(faces), "head_events": len(heads),
         "relocks": len(lost), "launches": counts}
    log(f"session: Tracker(debug=True) over {SESSION_FRAMES} frames of a "
        f"bench-pool stream: statuses {' -> '.join(seq)}; {len(faces)} "
        f"facetrackingEvents, {len(heads)} headtrackingEvents, {n_bp} "
        f"backprojection images; launches {counts}")
    for name, x in [("all", r)] + list(by_mode.items()):
        log(f"session: step_once, {name} frames ({x['frames']}): "
            f"{x['ms_mean']:.3f} ms mean, p50 {x['ms_p50']:.3f}, p99 "
            f"{x['ms_p99']:.3f}, max {x['ms_max']:.3f}")
    return r


def phase_fanout(pool, dev, root):
    """BatchedSession of N_STREAMS pull-mode clips (headline configuration)
    against a StreamFanout fed from a second tracker's step(sync=True);
    then a checkpoint of the session's tracker resumed in a fresh one.
    Returns the numbers."""
    import numpy as np
    import torch
    from headtrackr_tpu_torch import (BatchedSession, BatchedTracker,
                                      StreamFanout, checkpoint)

    kw, _ = CONFIGS["headline"]
    n = N_STREAMS
    seq = np.concatenate([np.repeat(pool[:1], LOCK_TICKS, 0), pool])
    sess = BatchedSession(n, sources=[seq[:, s] for s in range(n)],
                          frame_shape=(H, W), device=dev, **kw)
    logs = [[] for _ in range(n)]
    for i, lg in enumerate(logs):
        _listen(lambda ty, cb, i=i: sess.fanout.add_event_listener(i, ty, cb),
                lg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ticks = sess.run(sync=True)
    dt_sess = time.perf_counter() - t0
    if ticks != FANOUT_TICKS:
        raise AssertionError(f"fanout: {ticks} ticks, not {FANOUT_TICKS}")
    bt = BatchedTracker(n, (H, W), device=dev, **kw)
    fan = StreamFanout(n)
    ref = [[] for _ in range(n)]
    for i, lg in enumerate(ref):
        _listen(lambda ty, cb, i=i: fan.add_event_listener(i, ty, cb), lg)
    for f in seq:
        fan.emit(bt.step(f, sync=True))
    n_events = 0
    for i, (got, want) in enumerate(zip(logs, ref)):
        if [t for t, _ in got] != [t for t, _ in want]:
            raise AssertionError(f"fanout: stream {i} event types differ")
        for a_t, b_t in zip(got, want):
            a, b = a_t[1], b_t[1]
            same = a.keys() == b.keys() and all(
                a[k] == b[k] if isinstance(b[k], str) else
                bool(np.isclose(a[k], b[k], rtol=RTOL, atol=ATOL,
                                equal_nan=True)) for k in b)
            if not same:
                raise AssertionError(f"fanout: stream {i}: {a} vs {b}")
        n_events += len(got)
    relocked = sum("redetecting" in _dedup(lg) and _dedup(lg)[-1] == "found"
                   for lg in logs[:LOSS_STREAMS])
    if relocked != LOSS_STREAMS:
        raise AssertionError(f"fanout: {relocked} of {LOSS_STREAMS} loss "
                             f"streams relocked")
    log(f"fanout: BatchedSession of {n} ClipSources, {ticks} ticks + flush "
        f"({1e3 * dt_sess / ticks:.3f} ms/tick, step(sync=True) and "
        f"emission of the previous tick): {n_events} events, per stream "
        f"equal to a StreamFanout of step(sync=True) (time excluded)")

    path = os.path.join(root, "build", "chip_smoke", "resume.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    src = sess.tracker  # mid-track: every stream locked, 16 pool ticks in
    t0 = time.perf_counter()
    checkpoint.save_tracker(path, src)
    t_save = time.perf_counter() - t0
    fresh = BatchedTracker(n, (H, W), device=dev, **kw)
    t0 = time.perf_counter()
    checkpoint.load_tracker(path, fresh)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    resumed = [fresh.step_auto(pool[t]) for t in range(RESUME_TICKS)]
    want = [src.step_auto(pool[t]) for t in range(RESUME_TICKS)]
    worst = agree(resumed, want, "checkpoint resume")
    r = {"ticks": ticks, "ms_per_tick": 1e3 * dt_sess / ticks,
         "events": n_events, "checkpoint_bytes": os.path.getsize(path),
         "save_ms": 1e3 * t_save, "load_ms": 1e3 * t_load,
         "resume_ticks": RESUME_TICKS, "resume_worst_float_diff": worst}
    log(f"checkpoint: save_tracker {r['save_ms']:.1f} ms, "
        f"{r['checkpoint_bytes']} bytes; load_tracker {r['load_ms']:.1f} ms; "
        f"the resumed tracker's next {RESUME_TICKS} ticks equal the "
        f"uninterrupted tracker's (largest float difference {worst})")
    os.unlink(path)
    return r


def phase_facade(pool, dev):
    """The reference-parity namespace on the card over the session's clip:
    facetrackr.Tracker, headposition.Tracker with a camera controller on
    the bus, Smoother, camshift.Histogram and ccv.detect_objects; the first
    FACADE_CPU_FRAMES frames again on the CPU.  Returns the numbers."""
    import math

    import numpy as np
    import torch
    import headtrackr_tpu_torch as pt
    from headtrackr_tpu_torch.kernels import launch as L
    from headtrackr_tpu_torch.kernels.histpdf import hist4096
    from headtrackr_tpu_torch.ops import histogram as hg

    s = 0  # build_pool: the first LOSS_STREAMS streams lose their face
    clip = np.stack([pool[0, s]] * LOCK_TICKS
                    + [pool[t % POOL, s]
                       for t in range(SESSION_FRAMES - LOCK_TICKS)])
    loss = [i for i in range(len(clip))
            if i >= LOCK_TICKS and (i - LOCK_TICKS) % POOL == LOSS_AT]

    def run(device, frames):
        bus = pt.events.EventBus()
        events = []
        bus.add_event_listener(pt.events.FACETRACKING,
                               lambda e: events.append(e))
        tr = pt.facetrackr.Tracker(bus=bus, device=device)
        tr.init(pt.ClipSource(frames))
        res, ms = [], []
        for _ in range(len(frames)):
            t0 = time.perf_counter()
            r = tr.track()
            ms.append(1e3 * (time.perf_counter() - t0))
            res.append(r)
        return res, ms, events

    heads, poses = [], []

    class Camera:
        aspect = 4 / 3

        def apply(self, pose):
            poses.append(pose)

    ctl = pt.controllers.RealisticAbsoluteCameraControl(Camera(), 1.0,
                                                        (0, 0, 100))
    listener = pt.events.add_event_listener(pt.events.HEADTRACKING,
                                            heads.append)
    torch.cuda.synchronize()
    L.reset_launches()
    try:
        res, ms, faces = run(dev, clip)
        det = [r.detection for r in res]
        if det[:16] != ["WB"] * 15 + ["VJ"] or set(det[16:]) != {"CS"}:
            raise AssertionError(f"facade: modes {det[:20]}")
        cs = [r for r in res if r.detection == "CS"]
        if len(faces) != len(cs):
            raise AssertionError(f"facade: {len(faces)} facetrackingEvents "
                                 f"for {len(cs)} CS frames")
        vals = [v for r in cs for v in (r.x, r.y, r.width, r.height, r.angle)]
        if not all(map(math.isfinite, vals)):
            raise AssertionError("facade: a non-finite CS box")
        live = [r for i, r in enumerate(res)
                if r.detection == "CS" and i < loss[0]]
        if not live or any(r.width <= 0 or r.height <= 0 for r in live):
            raise AssertionError("facade: no live CS box before the loss")
        if any(r.width or r.height for r in res[loss[0]:]):
            raise AssertionError("facade: the loss frame did not collapse "
                                 "the box")
        hp = pt.headposition.Tracker(live[0], W, H, device=dev)
        sm = pt.Smoother(device=dev)
        sm.init(live[0])
        smoothed = []
        for r in live:
            hp.track(r)
            smoothed.append(sm.smooth(r))
        hists, hist_ms = [], []
        for f in clip:
            t0 = time.perf_counter()
            hists.append(pt.camshift.Histogram(f, device=dev))
            hist_ms.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        counts = dict(L.launches)
    finally:
        pt.events.remove_event_listener(pt.events.HEADTRACKING, listener)
        ctl.close()
    missing = [k for k in FACADE_PATH if counts[k] <= 0]
    if missing:
        raise AssertionError(f"facade: kernels never launched: {missing} "
                             f"({counts})")
    if len(heads) != len(live) or len(poses) != len(heads):
        raise AssertionError(f"facade: {len(heads)} headtrackingEvents, "
                             f"{len(poses)} poses for {len(live)} boxes")
    for e, p in zip(heads, poses):
        v = [e.x, e.y, e.z, p.fov, *p.position, *p.view_offset]
        if not all(map(math.isfinite, v)):
            raise AssertionError(f"facade: non-finite pose {e} {p}")
    if not all(math.isfinite(v) for d in smoothed
               for k, v in d.items() if k in ("x", "y", "width", "height")):
        raise AssertionError("facade: non-finite smoothed box")
    frames = torch.as_tensor(clip).to(dev)
    want = hist4096(frames, hg.full_rects(len(clip), (H, W), dev)).cpu()
    if not torch.equal(torch.as_tensor(np.stack(hists)), want):
        raise AssertionError("facade: Histogram differs from hist4096")

    # the first frames again on the CPU
    cpu, _, cpu_faces = run("cpu", clip[:FACADE_CPU_FRAMES])
    worst = 0.0
    for k, (a, b) in enumerate(zip(res, cpu)):
        for f in ("detection", "x", "y", "width", "height", "angle",
                  "confidence", "wb"):
            x, y = getattr(a, f), getattr(b, f)
            if isinstance(y, str) or (isinstance(x, int)
                                      and isinstance(y, int)):
                ok = x == y  # modes, and the CS box's integers
            else:
                ok = bool(np.isclose(x, y, rtol=RTOL, atol=ATOL))
                worst = max(worst, abs(float(x) - float(y)))
            if not ok:
                raise AssertionError(f"facade card vs CPU: frame {k} {f}: "
                                     f"{x} vs {y}")
    if len(cpu_faces) != sum(r.detection == "CS" for r in cpu):
        raise AssertionError("facade card vs CPU: facetrackingEvents")

    gray = pt.ccv.grayscale(clip[0], device=dev)
    det_ms = []
    for _ in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        boxes = pt.ccv.detect_objects(gray, pt.cascade(), 5, 1)
        det_ms.append(1e3 * (time.perf_counter() - t0))
    if not boxes:
        raise AssertionError("facade: ccv.detect_objects found no face")

    def stats(x):
        x = np.asarray(x)
        return {"frames": int(x.size), "ms_p50": float(np.percentile(x, 50)),
                "ms_p99": float(np.percentile(x, 99)),
                "ms_mean": float(x.mean())}

    ms = np.asarray(ms)
    by_mode = {m: stats(ms[np.asarray(det) == m]) for m in ("WB", "VJ", "CS")}
    r = {"frames": len(clip), "loss_frames": len(loss), "live_cs": len(live),
         "head_events": len(heads), "track_ms_by_mode": by_mode,
         "detect_objects_ms": stats(det_ms[1:]), "histogram_ms": stats(hist_ms),
         "cpu_frames": FACADE_CPU_FRAMES, "cpu_worst_float_diff": worst,
         "launches": counts}
    log(f"facade: facetrackr.Tracker over {len(clip)} frames ({len(loss)} "
        f"loss frames): WB x 15 -> VJ -> CS, {len(live)} live CS boxes, then "
        f"the box collapses at frame {loss[0]}; {len(heads)} head poses, "
        f"finite; Histogram == hist4096 on every frame; the first "
        f"{FACADE_CPU_FRAMES} frames on the CPU agree (largest float "
        f"difference {worst}); launches {counts}")
    for m, x in by_mode.items():
        log(f"facade: track() {m} frames ({x['frames']}): p50 "
            f"{x['ms_p50']:.3f} ms, p99 {x['ms_p99']:.3f}, mean "
            f"{x['ms_mean']:.3f}")
    log(f"facade: ccv.detect_objects at {W}x{H}: p50 "
        f"{r['detect_objects_ms']['ms_p50']:.3f} ms ({len(boxes)} faces); "
        f"camshift.Histogram p50 {r['histogram_ms']['ms_p50']:.3f} ms, p99 "
        f"{r['histogram_ms']['ms_p99']:.3f}")
    return r


def load_example(root, name, folder="examples"):
    """<folder>/<name>.py as a module (the examples and tools are scripts,
    not a package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, folder, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_plan(pool, dev, root):
    """plan_serving's kwargs build a BatchedTracker of N_STREAMS streams on
    the card that locks the bench pool and runs a short scan; then
    examples/torch_batched_serving.py and examples/torch_facetracking.py
    (toy cascade, 120x160) run on the card.  The launch counts are set to 0
    before and read after: the headline configuration's kernels must have
    run.  Returns the numbers."""
    import contextlib
    import io

    import numpy as np
    import torch
    import headtrackr_tpu_torch as pt
    from headtrackr_tpu_torch.kernels import launch as L
    from headtrackr_tpu_torch.models import facetracker as ft

    plan = pt.plan_serving(N_STREAMS, (H, W), max_face_px=24,
                           simultaneous_losses=LOSS_STREAMS)
    L.reset_launches()
    t0 = time.perf_counter()
    bt = pt.BatchedTracker(N_STREAMS, (H, W), device=dev, band=plan["band"],
                           bucket=plan["bucket"], overload=plan["overload"],
                           bandHist=plan["bandHist"],
                           sparseHist=plan["sparse_hist"])
    frames = torch.as_tensor(pool[:4]).to(dev)
    for _ in range(LOCK_TICKS):
        bt.step_auto(frames[0])
    locked = float((bt.modes == ft.MODE_CS).mean())
    scan = bt.run_scan(frames)
    torch.cuda.synchronize()
    t_plan = time.perf_counter() - t0
    if locked < 0.99:
        raise AssertionError(f"plan: only {100 * locked:.1f}% of streams "
                             f"locked")
    for field, v in zip(scan._fields, scan):
        if v.is_floating_point() and field != "face_angle" and \
                not bool(torch.isfinite(v).all()):
            raise AssertionError(f"plan: non-finite {field} in run_scan")
    del bt, frames

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        heads, modes, xs = load_example(root, "torch_batched_serving").main(
            ["--device", str(dev)])
        tracker = load_example(root, "torch_facetracking").main(
            ["--toy", "--device", str(dev)])
    torch.cuda.synchronize()
    t_ex = time.perf_counter() - t0
    counts = dict(L.launches)
    lines = out.getvalue().splitlines()
    if modes != [ft.MODE_CS] * len(modes) or not all(heads) or \
            not np.isfinite(xs).all():
        raise AssertionError(f"torch_batched_serving: modes {modes}, head "
                             f"events {[len(h) for h in heads]}")
    if tracker.status != "tracking" or not any(
            ln.startswith("[head]") for ln in lines):
        raise AssertionError(f"torch_facetracking: status {tracker.status}")
    # a cold start and tracking ticks: no bucket tick (slot_gather)
    missing = [k for k in CONFIGS["headline"][1] if counts[k] <= 0
               and k != "slot_gather"]
    if missing:
        raise AssertionError(f"plan/examples: kernels never launched: "
                             f"{missing} ({counts})")
    log(f"plan: plan_serving({N_STREAMS}, {(H, W)}, max_face_px=24, "
        f"simultaneous_losses={LOSS_STREAMS}) = {plan}; its BatchedTracker "
        f"locked {100 * locked:.1f}% in {LOCK_TICKS} ticks and ran a K=4 "
        f"scan ({t_plan:.2f} s)")
    log(f"examples: torch_batched_serving (modes {modes}, "
        f"{[len(h) for h in heads]} head events) and torch_facetracking "
        f"--toy (status {tracker.status}) on the card, {t_ex:.2f} s, "
        f"{len(lines)} lines printed; launches {counts}")
    return {"plan": plan, "locked": locked, "plan_s": t_plan,
            "examples_s": t_ex, "launches": counts}


def _bits(t):
    """A tensor's values on the host, f32 as their bit patterns."""
    a = t.cpu().numpy()
    return a.view("int32") if a.dtype.name == "float32" else a


def same_bits(a, b, where):
    """Two lists of StepOutputs (or TrackerStates): every leaf equal,
    integers exactly, floats bit for bit."""
    import numpy as np

    for k, (x, y) in enumerate(zip(a, b)):
        for (name, u), (_, v) in zip(_named(x), _named(y)):
            if not np.array_equal(_bits(u), _bits(v)):
                raise AssertionError(f"{where}: tick {k} {name}: "
                                     f"{u.cpu().numpy()} vs {v.cpu().numpy()}")


def phase_mesh(pool, dev, root):
    """Phase 11: the headline configuration meshless, on stream_mesh() and
    on MESH_SHARDS shards of the one card.  Returns the numbers."""
    import torch
    from headtrackr_tpu_torch import BatchedTracker, checkpoint
    from headtrackr_tpu_torch.kernels import launch as L
    from headtrackr_tpu_torch.models import facetracker as ft
    from headtrackr_tpu_torch.parallel import stream_mesh

    kw, _ = CONFIGS["headline"]
    frames = torch.as_tensor(pool).to(dev)
    meshes = {"meshless": None, "mesh_a": stream_mesh(),
              "mesh_b": stream_mesh([dev] * MESH_SHARDS)}
    if meshes["mesh_a"].devices.size != torch.cuda.device_count():
        raise AssertionError("mesh: stream_mesh() does not name every card")
    n_ticks = 2 * POOL
    runs = {}
    for name, mesh in meshes.items():
        shards = 1 if mesh is None else mesh.devices.size
        bt = BatchedTracker(N_STREAMS, (H, W), mesh=mesh,
                            device=dev if mesh is None else None, **kw)
        bt.warmup(scan_len=POOL)
        torch.cuda.synchronize()
        L.reset_launches()
        outs = [bt.step_auto(frames[0]) for _ in range(LOCK_TICKS)]
        torch.cuda.synchronize()
        per_tick = []
        t0 = time.perf_counter()
        for t in range(n_ticks):
            before = dict(L.launches)
            outs.append(bt.step_auto(frames[t % POOL]))
            per_tick.append({k: L.launches[k] - before[k]
                             for k in ("histpdf_band", "meanshift")})
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        before = dict(L.launches)
        scan = bt.run_scan(frames)
        torch.cuda.synchronize()
        scan_launches = {k: L.launches[k] - before[k]
                         for k in ("histpdf_band", "meanshift")}
        outs += [ft.StepOutput(*(v[k] for v in scan)) for k in range(POOL)]
        short = [(t, c) for t, c in enumerate(per_tick)
                 if min(c.values()) < shards]
        if short or min(scan_launches.values()) < shards * POOL:
            raise AssertionError(f"mesh [{name}]: histpdf_band / meanshift "
                                 f"not launched once a shard every tick: "
                                 f"{short[:3]}, scan {scan_launches}")
        if not (bt.modes == ft.MODE_CS).all():
            raise AssertionError(f"mesh [{name}]: not every stream tracks")
        runs[name] = {"bt": bt, "outs": outs, "shards": shards,
                      "ms_per_tick": 1e3 * dt / n_ticks,
                      "launches": dict(L.launches),
                      "launches_per_tick": {
                          k: sum(c[k] for c in per_tick) / n_ticks
                          for k in ("histpdf_band", "meanshift")}}
    ref = runs["meshless"]
    for name in ("mesh_a", "mesh_b"):
        same_bits(runs[name]["outs"], ref["outs"], f"mesh [{name}]")
        same_bits([runs[name]["bt"].state], [ref["bt"].state],
                  f"mesh [{name}] final state")
    log(f"mesh: stream_mesh() = {meshes['mesh_a']} and "
        f"{MESH_SHARDS} shards of {N_STREAMS // MESH_SHARDS} on one card: "
        f"{LOCK_TICKS + n_ticks + POOL} ticks (step_auto and a K={POOL} "
        f"run_scan) and the final state equal the meshless tracker's "
        f"(integers exact, floats bit-equal); histpdf_band and meanshift "
        f"launched once a shard every tick")

    # a checkpoint of (b) resumed meshless
    path = os.path.join(root, "build", "chip_smoke", "mesh.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    src = runs["mesh_b"]["bt"]
    checkpoint.save_tracker(path, src)
    fresh = BatchedTracker(N_STREAMS, (H, W), device=dev, **kw)
    checkpoint.load_tracker(path, fresh)
    os.unlink(path)
    resumed = [fresh.step_auto(frames[t]) for t in range(RESUME_TICKS)]
    want = [src.step_auto(frames[t]) for t in range(RESUME_TICKS)]
    same_bits(resumed, want, "mesh checkpoint resume")
    log(f"mesh: a checkpoint of the {MESH_SHARDS}-shard tracker loaded into "
        f"a meshless one; its next {RESUME_TICKS} ticks equal the "
        f"uninterrupted run's bit for bit")

    # all-CS ticks, trackers in turns (a, b, meshless, meshless, b, a, twice)
    order = ["mesh_a", "mesh_b", "meshless"]
    steady = {name: [] for name in order}
    for name in 2 * (order + order[::-1]):
        steady[name].append(1e3 * steady_s(
            runs[name]["bt"].step_auto, frames, MESH_STEADY_TICKS)
            / MESH_STEADY_TICKS)
    prof = phase_profile({name: runs[name]["bt"]
                          for name in ("mesh_a", "mesh_b")}, frames)
    r = {"shards": {k: v["shards"] for k, v in runs.items()},
         "ms_per_tick": {k: v["ms_per_tick"] for k, v in runs.items()},
         "steady_ms_per_tick": steady, "profile": prof,
         "launches_per_tick": {k: v["launches_per_tick"]
                               for k, v in runs.items()},
         "launches": {k: v["launches"] for k, v in runs.items()},
         "resume_ticks": RESUME_TICKS}
    log(f"mesh: step_auto ms/tick over {n_ticks} ticks (4 loss streams): "
        f"{r['ms_per_tick']}; all-CS ms/tick over {MESH_STEADY_TICKS} "
        f"ticks, four turns: {r['steady_ms_per_tick']}; launches per tick "
        f"{r['launches_per_tick']}")
    return r


def phase_gate(dev, root):
    """Phase 12: tools/torch_verify_gpu.py on the card, every clip kind at
    both sizes.  Returns its results; a failed gate raises."""
    gate = load_example(root, "torch_verify_gpu", folder="tools")
    t0 = time.perf_counter()
    ok, res = gate.run_gate(GATE_FRAMES, "all", GATE_SIZES, dev,
                            log=lambda m: log(f"gate: {m}"))
    if not ok:
        raise AssertionError("gate: the port failed the conformance gate "
                             "against the oracle (lines above)")
    log(f"gate: every clip kind at "
        f"{', '.join(f'{w}x{h}' for h, w in GATE_SIZES)} passes "
        f"({time.perf_counter() - t0:.1f} s)")
    return res


def phase_surface(pools, dev):
    """The reference's public surface on the card, every device argument
    left at None: hist_pallas and pdf_pallas on the bench pool's bins at
    N=256 and N=1 (and one (H, W) frame, and ids outside [0, 4096)),
    models.camshift.mean_shift on pdf_pallas's pdf, handoff_band_audit on
    bins, detect_best(gray, cascade), init_state and cascade_to_torch.  The
    launch counts are set to 0 just before those calls and read just after;
    every kernel of SURFACE_PATH must have launched.  Each result is held,
    bit for bit, against its kernel's twin on the same inputs and against
    the path it aliases: hist4096 and backproject of the same frames, the
    kernel wrapper's mean shift (track's) and its twin, init_tracker's
    frames audit, detect_best on the tables.  Then the two entry points'
    times.  Returns the numbers."""
    import torch
    import headtrackr_tpu_torch as pt
    from headtrackr_tpu_torch.cascade import cascade_to_torch
    from headtrackr_tpu_torch.kernels import hist_pallas, pdf_pallas
    from headtrackr_tpu_torch.kernels import launch as L
    from headtrackr_tpu_torch.kernels import meanshift as kms
    from headtrackr_tpu_torch.kernels.histpdf import (backproject, hist4096,
                                                      histpdf_band)
    from headtrackr_tpu_torch.models import camshift as tcs
    from headtrackr_tpu_torch.models import detector as td
    from headtrackr_tpu_torch.models import facetracker as tft
    from headtrackr_tpu_torch.ops import histogram as hg
    from headtrackr_tpu_torch.ops.imageproc import grayscale
    from headtrackr_tpu_torch.ops.meanshift import mean_shift_plain

    frames = torch.as_tensor(pools[0][1]).to(dev)
    N = frames.shape[0]
    rects = torch.as_tensor(face_boxes(pools[0][1])).to(dev)
    full = hg.full_rects(N, (H, W), dev)
    model = histpdf_band(frames, rects)
    weights = hg.backprojection_weights(model, hist4096(frames, full))
    bins = hg.rgb_bins(frames)
    # stream 1 with a pixel of its face's color far from the face: dirty
    afr = frames.clone()
    x, y, w, h = (int(v) for v in rects[1])
    afr[1, 2:5, W - 5:W - 2] = frames[1, y + h // 2, x + w // 2]
    abins = hg.rgb_bins(afr)
    odd = bins.clone()
    odd[:, 0, :6] = torch.tensor([-1, -64, 4096, 5000, -2 ** 31, 2 ** 31 - 1],
                                 dtype=torch.int32, device=dev)
    casc = pt.cascade()
    gray = grayscale(frames[:SURFACE_DETECT])
    torch.cuda.synchronize()

    L.reset_launches()
    on_card = [tft.init_state(4).mode, tcs.init_state(4).window,
               cascade_to_torch(casc)["alpha"]]
    got = {}
    for n in SURFACE_NS:
        got[n] = (hist_pallas(bins[:n]), pdf_pallas(bins[:n], weights[:n]))
    frame1 = (hist_pallas(bins[0]), pdf_pallas(bins[0], weights[0]))
    odd_out = (hist_pallas(odd), pdf_pallas(odd, weights))
    three = tcs.mean_shift(got[N][1], rects)
    audit = tcs.handoff_band_audit(abins, model, rects, BAND)
    best = td.detect_best(gray, casc)
    torch.cuda.synchronize()
    launches = {k: L.launches[k] for k in SURFACE_PATH}
    idle = [k for k, v in launches.items() if not v]
    if idle:
        raise AssertionError(f"surface: kernels not launched: {idle}")
    if L.launches["take_along"]:
        raise AssertionError("surface: pdf_pallas launched take_along")
    if any(t.device.type != dev.type for t in on_card):
        raise AssertionError("surface: a None device did not land on the "
                             "card")

    err = {"hist_bins": 0.0, "pdf_bins": 0.0}

    def same(kernel, a, b, what):
        e = float((a.float() - b.float()).abs().max()) if a.numel() else 0.0
        err[kernel] = max(err[kernel], e)
        if not torch.equal(a, b):
            raise AssertionError(f"surface: {what} differs (max abs err {e})")

    for n, (h, p) in got.items():
        same("hist_bins", h, hg.hist_bins_plain(bins[:n].reshape(n, -1)),
             f"hist_pallas vs its twin at N={n}")
        same("hist_bins", h, hist4096(frames[:n], full[:n]),
             f"hist_pallas vs hist4096 at N={n}")
        same("pdf_bins", p, hg.pdf_bins_plain(bins[:n], weights[:n]),
             f"pdf_pallas vs its twin at N={n}")
        same("pdf_bins", p, backproject(frames[:n], weights[:n]),
             f"pdf_pallas vs backproject at N={n}")
    same("hist_bins", frame1[0], got[1][0][0], "hist_pallas on one frame")
    same("pdf_bins", frame1[1], got[1][1][0], "pdf_pallas on one frame")
    same("hist_bins", odd_out[0], hg.hist_bins_plain(odd.reshape(N, -1)),
         "hist_pallas on ids outside [0, 4096)")
    same("pdf_bins", odd_out[1], hg.pdf_bins_plain(odd, weights),
         "pdf_pallas on ids outside [0, 4096)")
    if not (odd_out[1][:, 0, :6] == 0).all():
        raise AssertionError("surface: pdf_pallas looked up an id outside "
                             "[0, 4096)")
    nodes = {n: graph_nodes(lambda n=n: pdf_pallas(bins[:n], weights[:n]))
             for n in SURFACE_NS}
    if any(v != ["kernel"] for v in nodes.values()):
        raise AssertionError(f"surface: a pdf_pallas call is not one kernel "
                             f"node: {nodes}")
    four = kms.mean_shift(got[N][1], rects)
    plain = mean_shift_plain(got[N][1], rects)
    for want, what in ((four, "the kernel wrapper's"), (plain, "its twin's")):
        ok = (torch.equal(three[0], want[0]) and torch.equal(three[2], want[2])
              and all(torch.equal(three[1][k], want[1][k]) for k in three[1]))
        if not ok:
            raise AssertionError(f"surface: mean_shift differs from "
                                 f"{what} mean shift")
    frames_audit = tcs.init_tracker(afr, rects, audit_band=BAND).band_dirty
    if not (torch.equal(audit, frames_audit) and bool(audit[1])):
        raise AssertionError("surface: handoff_band_audit on bins differs "
                             "from init_tracker's frames audit, or misses "
                             "stream 1's far pixel")
    tables = td.detector_tables(W, H, casc)
    for a, b in zip(best, td.detect_best(gray, tables)):
        if not torch.equal(a, b):
            raise AssertionError("surface: detect_best(gray, cascade) "
                                 "differs from detect_best(gray, tables)")
    torch.cuda.synchronize()
    log(f"surface: hist_pallas, pdf_pallas (N={', '.join(map(str, SURFACE_NS))}"
        f", one frame, ids outside [0, 4096)), mean_shift, handoff_band_audit"
        f" on bins ({int(audit.sum())} of {N} dirty), detect_best(gray, "
        f"cascade) ({int(best[0].sum())} of {SURFACE_DETECT} found), "
        f"init_state and cascade_to_torch on the card with device None: "
        f"bit-equal to the twins and the aliased paths; launches {launches}"
        f"; pdf_pallas graph nodes {nodes}")

    card = smi()
    times = {}
    for n in SURFACE_NS:
        b, w = bins[:n], weights[:n]
        P = H * W
        given = (b.reshape(n, -1).long() + 4096 * torch.arange(
            n, device=dev).view(n, 1)).view(-1)
        lib_ids = b.reshape(n, -1).long()
        cases = {
            "hist_pallas": (lambda b=b: hist_pallas(b),
                            lambda b=b, n=n: hg.hist_bins_plain(
                                b.reshape(n, -1)),
                            4 * n * P + 4 * 4096 * n,
                            lambda g=given, n=n: torch.bincount(
                                g, minlength=n * 4096), False, "torch.bincount"),
            "pdf_pallas": (lambda b=b, w=w: pdf_pallas(b, w),
                           lambda b=b, w=w: hg.pdf_bins_plain(b, w),
                           8 * n * P + 4 * 4096 * n,
                           lambda w=w, i=lib_ids: torch.gather(w, 1, i),
                           True, "torch.gather"),
        }
        for name, (kern, twin, nbytes, lib, capt, lib_name) in cases.items():
            ms, plain_ms = interleaved_ms(kern, twin)
            bms, by = bound(nbytes, 0)
            key = f"{name} n{n}"
            times[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                              bound_by=by, graph_ms=graph_ms(kern),
                              library=lib_name, **library_times(lib, capt))
            log(f"surface: {key} ({n} x {H}x{W} bins) {ms:.4f} ms, graph "
                f"replay {times[key]['graph_ms']:.4f} ms (plain "
                f"{plain_ms:.4f} ms, bound {bms:.6f} ms by {by}, {lib_name} "
                f"{times[key]['library_ms']:.4f} ms, graph replay "
                f"{fmt_ms(times[key]['library_graph_ms'])}); {card}")
    return {"launches": launches, "times": times, "err": err,
            "dirty": int(audit.sum()), "found": int(best[0].sum()),
            "pdf_nodes": {f"n{n}": v for n, v in nodes.items()}}


def phase_bench(root):
    """Phase 13: ``python3 bench_torch.py`` on the card, one subprocess an
    arm of BENCH_ARMS at BENCH_TICKS timed ticks (its kernels already built
    by phase 2).  Each arm must exit 0 and print its JSON line with every
    key, >= 99% locked, relocks in the timed region, and the headline
    configuration's kernels launched (histpdf_band and meanshift on every
    tick, the handoff's histpdf_band_hist and backproject).  Returns
    {"arms": {arm: its record}, "seconds": the phase's}."""
    t0 = time.perf_counter()
    arms = {}
    for name, extra in BENCH_ARMS.items():
        cmd = [sys.executable, os.path.join(root, "bench_torch.py"),
               "--ticks", str(BENCH_TICKS), *extra]
        p = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                           timeout=600)
        if p.returncode != 0:
            raise AssertionError(f"bench [{name}]: exit {p.returncode}\n"
                                 f"{p.stderr[-4000:]}")
        line = p.stdout.strip().splitlines()[-1]
        rec = json.loads(line)
        optional = () if name == "headline" else ("exact_value",
                                                  "h2d_value")
        missing = [k for k in BENCH_KEYS if k not in rec
                   or (rec[k] is None and k not in optional)]
        if missing:
            raise AssertionError(f"bench [{name}]: no {missing} in {line}")
        if rec["locked"] < 0.99 or rec["relocks"] <= 0:
            raise AssertionError(f"bench [{name}]: gate missed: {line}")
        idle = [k for k in CONFIGS["headline"][1] if rec["launches"][k] == 0]
        if idle:
            raise AssertionError(f"bench [{name}]: {idle} never launched")
        for ln in p.stderr.splitlines():
            if ln.startswith("#"):
                log(f"bench [{name}] {ln}")
        log(f"bench [{name}]: {line}")
        arms[name] = rec
    r = {"arms": arms, "seconds": time.perf_counter() - t0}
    log(f"bench: {len(arms)} runs of bench_torch.py ({', '.join(arms)}) "
        f"in {r['seconds']:.1f} s")
    return r


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import numpy as np
    from bench import build_pool
    from headtrackr_tpu_torch.kernels.build import load_library

    card = smi()
    dev = torch.device("cuda", 0)
    log(f"device: {torch.cuda.get_device_name(0)} ({card}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    lib = load_library()
    regs = [ln.strip() for ln in lib.log.splitlines() if "registers" in ln]
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(p.name for p in lib.paths)}; {' | '.join(regs)})")

    pools = {k: build_pool(N_STREAMS, H, W, POOL, LOSS_STREAMS,
                           np.random.default_rng(0), face_noise=k)
             for k in (0, 20)}
    err, times = phase_kernels(pools, dev)
    err["take_along"], ta_times = phase_gather(dev)
    times.update(ta_times)
    err["meanshift"], ms_times = phase_meanshift(pools, dev)
    times.update(ms_times)
    err["hist_mma"], mma_times = phase_histmma(pools, dev)
    times.update(mma_times)
    err["hist_bins"], hb_times = phase_histbins(pools, dev)
    times.update(hb_times)
    det_err, det_times = phase_detect(pools, dev, root)
    err.update(det_err)
    times.update(det_times)
    err["tick_epilogue"], ep_times = phase_epilogue(pools, dev, root)
    times.update(ep_times)
    bucket_err, bucket_times = phase_bucket(pools, dev, root)
    err.update(bucket_err)
    times.update(bucket_times)
    frames = torch.as_tensor(pools[0]).to(dev)
    runs = {name: phase_serving(name, frames, dev) for name in CONFIGS}
    prof = phase_profile({name: r[2] for name, r in runs.items()}, frames)
    allcs = phase_allcs(runs, prof, root)
    relock = phase_relock(runs["headline"][2], frames)
    bodies = epilogue_bodies(runs["headline"][2])
    if bodies["0"]["nodes"] > ALLCS_BODY_NODES:
        raise AssertionError(f"the headline's all-CS body has "
                             f"{bodies['0']['nodes']} graph nodes, more than "
                             f"{ALLCS_BODY_NODES}")
    steady = [r["launches"] for r in prof["headline"]["step_auto"]]
    if max(steady) > STEADY_OPS:
        raise AssertionError(f"the headline's steady step_auto tick runs "
                             f"{steady} device operations, more than "
                             f"{STEADY_OPS}")
    relock["nodes_by_body"] = {k: v["nodes"] for k, v in bodies.items()}
    log(f"relock [headline]: graph nodes by body {relock['nodes_by_body']}")
    log(f"epilogue: the headline's program bodies, tick_epilogue launches a "
        f"run and graph nodes: {bodies}")
    counts = {name: r[0] for name, r in runs.items()}
    ms = {name: r[1] for name, r in runs.items()}
    del runs, frames  # free the trackers and the staged pool
    for name in ("full-frame", "headline"):
        phase_card_vs_cpu(name, pools[0], dev)
    sched = phase_schedule(pools[0], dev)
    err.update(sched.pop("err"))
    times.update(sched.pop("times"))
    counts["schedule"] = sched.pop("launches")
    f32 = phase_f32(dev, root)
    session = phase_session(pools[0], dev)
    fanout = phase_fanout(pools[0], dev, root)
    facade = phase_facade(pools[0], dev)
    counts["facade"] = facade["launches"]
    plan = phase_plan(pools[0], dev, root)
    mesh = phase_mesh(pools[0], dev, root)
    gate = phase_gate(dev, root)
    bench = phase_bench(root)
    surface = phase_surface(pools, dev)
    counts["surface"] = surface["launches"]
    times["pdf_bins"] = surface["times"][f"pdf_pallas n{N_STREAMS}"]

    entries = []
    for k, (replaces, path, src) in KERNELS.items():
        e = {"name": k, "route": "cuda", "source": src, "replaces": replaces,
             "launches": counts[path][k], "path": path,
             "max_abs_err": max(err.get(k, 0.0), surface["err"].get(k, 0.0)),
             **times[k]}
        if k in ("hist_bins", "pdf_bins"):
            entry = "hist_pallas" if k == "hist_bins" else "pdf_pallas"
            e["surface"] = {"entry_point": entry,
                            "launches": surface["launches"][k],
                            **{f"n{n}": surface["times"][f"{entry} n{n}"]
                               for n in SURFACE_NS}}
        if k == "backproject_rect":
            e["grid_origins"] = times[BPR_GRID]
        if k in ALSO_REPLACES:
            e["also_replaces"] = ALSO_REPLACES[k]
        if k == "histpdf_band":
            e.update(x4_workload=times[X4],
                     in_place=times["histpdf_band in place"])
        if k == "scan_step":
            e["rows"] = times["scan_step rows"]
            e["note"] = ("on no tick of the program (every body reads the "
                         "tick's frames in place); held against its twin "
                         "in phase 15")
        if k == "tick_epilogue":
            e.update(steady_tick_launches=prof["headline"]["step_auto"][0][
                "kernel_launches"][k], bodies=bodies)
        if k in F32_SPLIT:
            e["f32"] = f32["kernels"][k]
        if k in F32_PATH:
            e["f32_launches"] = f32["program"]["launches"][k]
        if k in BUCKET:
            e.update(relock_body_launches=bodies[str(min(8, N_STREAMS))]
                     .get(k), f32=f32["bucket"]["launches"][k])
            e.update({t[len(k) + 1:].replace(" ", "_"): times[t]
                      for t in times if t.startswith(f"{k} n")})
        if k == "slot_gather":
            e.update(escape=times["slot_gather escape"],
                     few_body_launches=bodies["few"][k])
        if k == "hist4096":
            e.update(random=times[K1_RANDOM], n1=times["hist4096 n1"])
        if k == "take_along":
            e.update({key: times[t] for key, t in TA_EXTRA.items()})
        if k == "meanshift":
            e.update({t.split()[1]: times[t] for t in MS_ENTRIES[1:]})
        if k == "hist_bins":
            e.update(bench=times["hist_bins bench"], n1=times["hist_bins n1"])
        if k in DETECT:
            e.update({f"n{n}": times[f"{k} n{n}"] for n in DETECT_NS[1:]})
        if f"{k} 480x640" in times:
            e["x480x640"] = times[f"{k} 480x640"]
        if k == "hist_mma":
            e.update(session_launches=session["launches"][k],
                     n1=times["hist_mma n1"], x6_workload=times["hist_mma x6"],
                     hist4096_n1=times["hist4096 n1"])
        entries.append(e)
    print(json.dumps({"profile": prof, "relock": relock,
                      "serving_ms_per_tick": ms, "all_cs_bodies": allcs,
                      "ticks": PROFILE_TICKS, "streams": N_STREAMS,
                      "session": session, "fanout": fanout,
                      "facade": facade, "plan": plan, "mesh": mesh,
                      "gate": gate, "bench": bench, "schedule": sched,
                      "f32": {"program": {k: v for k, v in f32[
                          "program"].items() if k != "launches"},
                          "bucket": f32["bucket"]},
                      "surface": {k: surface[k] for k in (
                          "launches", "times", "dirty", "found",
                          "pdf_nodes")}}))
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
