"""Image and histogram ops of the PyTorch port."""

from .histogram import (backprojection_weights, histogram_4096, histogram_rect,
                        rgb_bins)
from .imageproc import (PyramidSpec, build_pyramid, grayscale, resize_bilinear,
                        whitebalance)

__all__ = [
    "grayscale", "whitebalance", "resize_bilinear", "build_pyramid", "PyramidSpec",
    "rgb_bins", "histogram_4096", "histogram_rect", "backprojection_weights",
]
