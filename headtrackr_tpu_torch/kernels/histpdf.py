"""Wrappers of the camshift CUDA kernels (``csrc/histpdf.cu``).

  hist4096     replaces headtrackr_tpu/kernels/histpdf.py::hist_pallas
  backproject  replaces headtrackr_tpu/kernels/histpdf.py::pdf_pallas

Dispatch: a CPU tensor takes the kernel's plain twin (ops/histogram.py); a
CUDA tensor launches the kernel, built on first use (kernels/build.py);
any other device raises.  There is no fallback: a failed build or launch
raises.  ``launches`` counts the kernel launches of each wrapper, so a run
can show that its main path went through the kernels.
"""

import torch

from ..ops.histogram import NBINS, backproject_plain, hist4096_plain

__all__ = ["hist4096", "backproject", "launches", "reset_launches"]

launches = {"hist4096": 0, "backproject": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


def _check_frames(frames):
    if frames.dtype != torch.uint8 or frames.dim() != 4 or frames.shape[-1] != 3:
        raise ValueError(f"frames must be (N, H, W, 3) uint8, got "
                         f"{tuple(frames.shape)} {frames.dtype}")


def _launch(name, *args):
    from .build import load_library
    fn = getattr(load_library().lib, name + "_launch")
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    launches[name] += 1


def _on_cuda(*tensors):
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


def hist4096(frames, rects):
    """(N, H, W, 3) u8 + (N, 4) i32 [x, y, w, h] -> (N, 4096) f32 exact
    counts of each stream's rect (clamped to the frame)."""
    _check_frames(frames)
    N, H, W, _ = frames.shape
    if rects.dtype != torch.int32 or tuple(rects.shape) != (N, 4):
        raise ValueError(f"rects must be ({N}, 4) int32, got "
                         f"{tuple(rects.shape)} {rects.dtype}")
    if not _on_cuda(frames, rects):
        return hist4096_plain(frames, rects).to(torch.float32)
    out = torch.zeros((N, NBINS), dtype=torch.int32, device=frames.device)
    if N:
        with torch.cuda.device(frames.device):
            _launch("hist4096", frames.data_ptr(), rects.data_ptr(),
                    out.data_ptr(), N, H, W)
    return out.to(torch.float32)


def backproject(frames, weights):
    """(N, H, W, 3) u8 + (N, 4096) f32 -> (N, H, W) f32, pdf = weights[bin]."""
    _check_frames(frames)
    N, H, W, _ = frames.shape
    if weights.dtype != torch.float32 or tuple(weights.shape) != (N, NBINS):
        raise ValueError(f"weights must be ({N}, {NBINS}) float32, got "
                         f"{tuple(weights.shape)} {weights.dtype}")
    if not _on_cuda(frames, weights):
        return backproject_plain(frames, weights)
    if weights.data_ptr() % 16:
        raise ValueError("weights must be 16-byte aligned (float4 table load)")
    out = torch.empty((N, H, W), dtype=torch.float32, device=frames.device)
    if N:
        with torch.cuda.device(frames.device):
            _launch("backproject", frames.data_ptr(), weights.data_ptr(),
                    out.data_ptr(), N, H, W)
    return out
