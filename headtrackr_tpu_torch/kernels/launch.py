"""What the kernel wrappers share: device dispatch, the launch, and the
count of device launches by kernel.

``launches`` counts the launches that reached the card, so a run can show
that its main path went through the kernels.  A launch issued while a CUDA
graph captures the stream is not one: it is tallied by ``capturing`` instead,
and ``replayed`` adds that tally on each replay of the graph (the serving
program adds each body's tally times the runs the card reports for it).

``host_paths`` counts the entries into the serving tick's host-scheduled
code (the per-tick path's eager branches, the state machine's host index
lists, the host escape recompute), so a run can show that the
device-scheduled path never reached them.

``frames_at`` redirects the kernels that read frames (``histpdf_band``,
``hist4096``, ``hist_mma``, ``backproject`` in both forms, ``frame_prep``,
``handoff``, ``slot_gather``'s extra leaf) from one buffer to where a
tick's frames lie (``frames_of``): the serving program's bodies read tick
k of a scan without a copy.
"""

import contextlib
import functools

import torch

__all__ = ["launches", "host_paths", "reset_launches", "capturing",
           "replayed", "frames_at", "frames_source", "frames_of", "launch",
           "on_cuda",
           "row_ptr", "sm_count"]

launches = {"hist4096": 0, "backproject": 0, "backproject_rect": 0,
            "backproject_ratio": 0, "backproject_rect_ratio": 0,
            "histpdf_band": 0, "histpdf_band_hist": 0, "take_along": 0,
            "hist_mma": 0, "hist_bins": 0, "pdf_bins": 0, "meanshift": 0,
            "pyramid": 0, "cascade": 0, "group": 0, "tick_epilogue": 0,
            "frame_prep": 0, "handoff": 0, "tick_select": 0,
            "escape_select": 0, "scan_step": 0, "scan_commit": 0,
            "slot_gather": 0}
host_paths = {"eager_branch": 0, "dispatch": 0, "recompute": 0}

_tally = None  # the open ``capturing`` block's tally
_redirect = None  # the open ``frames_at`` block's (buffer, source)


def reset_launches():
    for counts in (launches, host_paths):
        for k in counts:
            counts[k] = 0


@contextlib.contextmanager
def capturing():
    """Yield a dict that tallies, by kernel, the launches a CUDA graph
    captures inside the block (pass it to ``replayed`` on each replay)."""
    global _tally
    prev, _tally = _tally, dict.fromkeys(launches, 0)
    try:
        yield _tally
    finally:
        _tally = prev


@contextlib.contextmanager
def frames_at(buffer, source):
    """Inside the block, a kernel that reads its frames in place reads
    those of ``buffer`` at ``source`` instead: on the card a (1,) i64
    tensor whose word holds their device address when the kernel runs (the
    serving program's parameter block word that tick_select sets to tick
    k's frames), on the CPU a tensor of ``buffer``'s shape (tick k's
    frames, which the plain twin reads).  Only ``buffer`` itself is
    redirected, never a view or a copy of it (a sub-batch's
    ``index_select``).  source None: no redirect."""
    global _redirect
    prev, _redirect = _redirect, (None if source is None
                                  else (buffer, source))
    try:
        yield
    finally:
        _redirect = prev


def frames_source(frames):
    """The source ``frames_at`` gives ``frames`` (the very tensor), or
    None."""
    if _redirect is not None and frames is _redirect[0]:
        return _redirect[1]
    return None


def frames_of(frames, on_card):
    """Where a frame reader reads ``frames`` (``frames_at``): on the card
    (frames, the device address of the word that holds their address when
    the kernel runs, 0 where it reads ``frames`` themselves), on the CPU
    (the frames the twin reads, 0)."""
    source = frames_source(frames)
    if source is None:
        return frames, 0
    if on_card:
        if source.dtype != torch.int64 or source.numel() != 1 or \
                source.device != frames.device:
            raise ValueError("on the card frames_at's source is a (1,) i64 "
                             "word on the frames' device")
        return frames, source.data_ptr()
    if source.shape != frames.shape or source.dtype != frames.dtype:
        raise ValueError("frames_at's source must match the frames")
    return source, 0


def replayed(tally):
    """Count one replay of a graph whose captured launches are ``tally``."""
    for k, v in tally.items():
        launches[k] += v


def launch(key, fn_name, *args):
    """Call the C launcher ``fn_name`` on the current stream; raise on a
    refused launch; count it under ``key``."""
    from .build import load_library
    err = load_library().fn(fn_name)(
        *args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{key} launch failed: cudaError {err}")
    if not torch.cuda.is_current_stream_capturing():
        launches[key] += 1
    elif _tally is not None:
        _tally[key] += 1


def on_cuda(*tensors):
    """True for CUDA tensors (which must be contiguous), False for CPU
    tensors (the plain twin's device); any other device raises."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {t.device} vs {dev}")
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        for t in tensors:
            if not t.is_contiguous():
                raise ValueError("kernel inputs must be contiguous")
        return True
    raise ValueError(f"no kernel for device {dev}")


def row_ptr(t, r):
    """The device address of row ``r`` of the contiguous tensor ``t``
    (a launch over a batch's rows r..)."""
    return t.data_ptr() + r * t.stride(0) * t.element_size()


@functools.lru_cache(maxsize=None)
def sm_count(device):
    """The SMs of a CUDA device (the wrappers size their grids by it)."""
    return torch.cuda.get_device_properties(device).multi_processor_count
