"""Where the port runs: the card unless the caller asks for another device."""

import torch

__all__ = ["resolve_device"]


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
