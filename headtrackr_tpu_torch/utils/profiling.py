"""Tracing and profiling utilities.

The reference's only instrumentation is a wall-clock ``time`` stamp per
tracking call (src/facetrackr.js:135,152,188,199), kept on
facetrackingEvent.  Here, additionally:

  - StageTimer: host-side stage timing that waits for the device: PyTorch
    returns before the card finishes, so ``sync`` synchronizes the devices
    of the given tensors before a stage closes.
  - trace(path): context manager around torch.profiler that writes a
    Chrome trace of the block (open it in Perfetto / chrome://tracing).
"""

import contextlib
import time

import torch

__all__ = ["StageTimer", "trace"]


class StageTimer:
    """Usage:
        t = StageTimer()
        with t.stage("detect"):
            out = detect(...)
            t.sync(out)          # waits for the device before the stage closes
        print(t.report())
    """

    def __init__(self):
        self.times = {}
        self.counts = {}

    @contextlib.contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    @staticmethod
    def sync(tree):
        """Wait for the work behind the tensors in ``tree`` (a tensor, or a
        list / tuple / NamedTuple / dict of them, nested): one
        ``torch.cuda.synchronize`` per CUDA device among them."""
        devices = set()
        stack = [tree]
        while stack:
            x = stack.pop()
            if torch.is_tensor(x):
                if x.is_cuda:
                    devices.add(x.device)
            elif isinstance(x, dict):
                stack.extend(x.values())
            elif isinstance(x, (list, tuple)):
                stack.extend(x)
        for d in devices:
            torch.cuda.synchronize(d)

    def report(self):
        lines = []
        for name, total in sorted(self.times.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:24s} {1000 * total:9.1f} ms total "
                         f"({1000 * total / n:7.2f} ms x {n})")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(path="headtrackr_trace.json"):
    """torch.profiler over the block (CPU, and the card when there is one);
    the Chrome trace goes to ``path``.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(path))
