"""CUDA kernels of the PyTorch port and their wrappers.

``hist_pallas`` and ``pdf_pallas`` are the reference package's two kernel
entry points (headtrackr_tpu/kernels/__init__.py), here on the port's
``hist_bins`` and ``pdf_bins`` kernels."""

from .histpdf import hist_pallas, pdf_pallas

__all__ = ["hist_pallas", "pdf_pallas"]
