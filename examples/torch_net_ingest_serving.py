"""Multi-host ingest on the PyTorch port: remote producer PROCESSES -> TCP
-> IngestRing -> BatchedSession, on one serving host.  The port of
examples/net_ingest_serving.py.

Cameras live on other machines, frames cross the network once into the
serving host's latest-frame-wins ring, and everything from the ring down
(batching, the GPU, events) is the normal host-local path: no cross-host
device state, no collectives.

Two modes:
  --ring-only   producers + server only; prints ingest throughput (the
                default; runs in seconds)
  --track       additionally drives BatchedSession from the ring with the
                toy cascade and prints per-stream statuses

Run (GPU):  python examples/torch_net_ingest_serving.py [--track]
Run (CPU):  python examples/torch_net_ingest_serving.py --track --device cpu
"""

import argparse
import multiprocessing as mp
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

H, W = 120, 160
N_STREAMS = 4
FRAMES_PER_STREAM = 120


def producer(address, stream, n_frames):
    """One remote camera: a bright blob panning right (a spawned process,
    standing in for a producer on another host).

    Loads the port's netingest.py standalone by path: the client side needs
    only numpy and sockets, so a real producer host installs that one file,
    not the framework (and not torch, whose import would take seconds in
    every camera process)."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "headtrackr_tpu_torch", "runtime",
        "netingest.py")
    spec = importlib.util.spec_from_file_location("netingest", path)
    ni = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ni)
    s = ni.FrameSender(address)
    for k in range(n_frames):
        f = np.full((H, W, 3), 40, np.uint8)
        x = 20 + (stream * 7 + k) % (W - 60)
        y = 30 + stream * 12
        f[y:y + 36, x:x + 36] = 230
        s.send(stream, f)
    s.close()


def main(argv=None):
    ap = argparse.ArgumentParser()
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--ring-only", action="store_true",
                      help="producers and server only (the default)")
    mode.add_argument("--track", action="store_true",
                      help="drive BatchedSession from the ring")
    ap.add_argument("--frames", type=int, default=FRAMES_PER_STREAM,
                    help="frames each producer sends")
    ap.add_argument("--device", default=None,
                    help="torch device of --track (default: the GPU; 'cpu' "
                         "runs the kernels' plain twins)")
    args = ap.parse_args(argv)

    from headtrackr_tpu_torch.runtime.fanout import IngestRing
    from headtrackr_tpu_torch.runtime.netingest import NetIngestServer

    ring = IngestRing(N_STREAMS, (H, W))
    srv = NetIngestServer(ring, host="127.0.0.1").start()
    print(f"ingest server on {srv.address}")

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=producer,
                         args=(srv.address, i, args.frames))
             for i in range(N_STREAMS)]
    t0 = time.time()
    for p in procs:
        p.start()

    statuses = None
    if args.track:
        import headtrackr_tpu_torch as pt
        from headtrackr_tpu_torch.runtime.fanout import BatchedSession
        ses = BatchedSession(N_STREAMS, ring=ring, frame_shape=(H, W),
                             cascade=pt.toy_cascade(), sync_interval=1,
                             device=args.device)
        for i in range(N_STREAMS):
            ses.fanout.add_event_listener(
                i, "headtrackrStatus",
                lambda e: print(f"  stream {e.stream}: {e.status}"))
        ticks = 0
        while any(p.is_alive() for p in procs) or ticks < 30:
            ses.step_once()
            ticks += 1
        ses.flush()
        statuses = list(ses.fanout.status)
        print(f"served {ticks} ticks; final statuses: {statuses}")

    for p in procs:
        p.join()
    dt = time.time() - t0
    total = srv.stats()["received"]
    mb = total * H * W * 3 / 1e6
    print(f"ingested {total} frames ({mb:.0f} MB) from {N_STREAMS} "
          f"producer processes in {dt:.2f}s "
          f"({total / dt:.0f} frames/s, {mb / dt:.0f} MB/s)")
    print(f"server stats: {srv.stats()}")
    srv.close()
    assert total == N_STREAMS * args.frames, "lost frames"
    return total, statuses


if __name__ == "__main__":
    main()
