"""The plain PyTorch twin of the ``take_along`` CUDA kernel
(kernels/gather.py): the same function, used for CPU tensors and as the
kernel's reference on the card."""

import torch

__all__ = ["take_along_plain"]


def take_along_plain(src, idx, dim):
    """torch.take_along_dim(src, idx, dim) with i32 indices: src (B, S, L)
    f32, dim 1 or 2, idx (B, K, L or 1) for dim 1, (B, S or 1, K) for
    dim 2; indices in range."""
    return torch.take_along_dim(src, idx.long(), dim)
