"""Host-to-device transfer rates on the card, by size, memory and threads.

The counterpart of tools/bench_h2d.py for headtrackr_tpu_torch: copies of
0.25 to 59 MB (59 MB is one 256-stream batch of 320x240 RGB frames) from
pageable NumPy memory and from pinned host tensors, timed on the host clock
to a synchronize; then one 59 MB batch split over 1 and 4 threads, each
copying its slice on a CUDA stream of its own.

Run on the card:  python3 tools/torch_bench_h2d.py
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(
    __file__))))

import argparse  # noqa: E402
import concurrent.futures as cf  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

SIZES_MB = (0.25, 1, 4, 16, 59)
BATCH_MB = 59
THREADS = (1, 4)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=8)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_bench_h2d: no CUDA device")
    from bench_torch import card_name

    dev = torch.device("cuda", 0)
    print(f"# device: {card_name(dev)}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", file=_sys.stderr)
    rng = np.random.default_rng(0)
    res = {}

    def timed(copy, reps):
        copy(0)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(reps):
            copy(i)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps

    for mb in SIZES_MB:
        nbytes = int(mb * 1e6)
        pageable = [rng.integers(0, 256, (nbytes,), dtype=np.uint8)
                    for _ in range(2)]
        pinned = [torch.from_numpy(a).pin_memory() for a in pageable]
        reps = max(args.reps, int(64e6 / nbytes))
        for kind, copy in (
                ("pageable", lambda i: torch.from_numpy(pageable[i % 2])
                 .to(dev)),
                ("pinned", lambda i: pinned[i % 2].to(dev,
                                                      non_blocking=True))):
            dt = timed(copy, reps)
            res[f"{kind} {mb} MB"] = 1e3 * dt
            print(f"h2d {mb:6.2f} MB {kind:8s}: {1e3 * dt:8.3f} ms  "
                  f"{nbytes / dt / 1e9:6.2f} GB/s")

    total = int(BATCH_MB * 1e6)
    for kind in ("pageable", "pinned"):
        for T in THREADS:
            chunk = total // T
            host = [rng.integers(0, 256, (chunk,), dtype=np.uint8)
                    for _ in range(T)]
            bufs = ([torch.from_numpy(a) for a in host] if kind == "pageable"
                    else [torch.from_numpy(a).pin_memory() for a in host])
            streams = [torch.cuda.Stream(dev) for _ in range(T)]

            def one(j):
                with torch.cuda.stream(streams[j]):
                    x = bufs[j].to(dev, non_blocking=kind == "pinned")
                streams[j].synchronize()
                return x

            with cf.ThreadPoolExecutor(T) as ex:
                list(ex.map(one, range(T)))  # warm
                dts = []
                for _ in range(args.reps):
                    t0 = time.perf_counter()
                    list(ex.map(one, range(T)))
                    dts.append(time.perf_counter() - t0)
            dt = float(np.median(dts))
            res[f"{kind} {BATCH_MB} MB x {T} threads"] = 1e3 * dt
            print(f"h2d {BATCH_MB} MB {kind:8s} T={T}: {1e3 * dt:8.3f} ms  "
                  f"{total / dt / 1e9:6.2f} GB/s")
    print(json.dumps({"h2d_ms": res, "device": card_name(dev)}))
    return res


if __name__ == "__main__":
    main()
