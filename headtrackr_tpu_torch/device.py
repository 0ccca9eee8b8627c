"""Where the port runs: the card unless the caller asks for another device."""

import numpy as np
import torch

__all__ = ["resolve_device", "to_device"]


def resolve_device(device=None):
    """``device`` as a ``torch.device``; None means the current CUDA device.

    With no card, None raises instead of running on the CPU: the CPU runs
    the kernels' plain twins, which a caller must ask for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                               "the CPU (the kernels' plain PyTorch twins)")
        device = "cuda"
    return torch.device(device)


def to_device(x, device=None):
    """A contiguous tensor of ``x``: a tensor stays on its own device (it
    wins over ``device``); anything else (an array, a list) is copied to
    ``resolve_device(device)``."""
    if torch.is_tensor(x):
        return x.contiguous()
    a = np.ascontiguousarray(x)
    if not a.flags.writeable:  # torch wraps only writable host memory
        a = a.copy()
    return torch.as_tensor(a, device=resolve_device(device))
