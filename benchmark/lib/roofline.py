"""The yardstick of the kernels' roofline shares: the card's peaks and the
bytes and operations each kernel's inputs need.

Each input byte counts once and each output byte once, whatever a kernel
reads again; where the work depends on the data, what these inputs need.
The least time of a launch is the larger of its bytes over the memory's
rate and its f32 operations over the f32 rate (``bound``)."""

__all__ = ["HBM_BYTES_PER_S", "F32_OPS_PER_S", "NBINS", "bound_s",
           "histpdf_band_work", "hist4096_work", "cascade_work"]

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA's data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
NBINS = 4096


def bound_s(nbytes, ops):
    """The least time for the work, in seconds."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def histpdf_band_work(n, band):
    """(bytes, operations) of one ``histpdf_band`` launch over n streams'
    (bh, bw) bands: each band's RGB read and its f32 pdf written, the
    window read, the model read and the counts written; ~7 operations a
    pixel and 3 a bin."""
    npx = n * band[0] * band[1]
    return 7 * npx + 16 * n + 8 * NBINS * n, 7 * npx + 3 * NBINS * n


def hist4096_work(n, frame):
    """(bytes, operations) of a full-frame 4096-bin histogram of n frames
    (H, W): the frames read and the f32 counts written, a rect read; ~6
    operations a pixel.  The bound of ``hist_mma``, which computes the same
    counts."""
    npx = n * frame[0] * frame[1]
    return 3 * npx + 16 * n + 4 * NBINS * n, 6 * npx


def cascade_work(n, plane_bytes, slots=256):
    """Bytes of the cascade over n streams: each stream's packed pyramid
    planes (``plane_bytes``) read, its candidate slots (21 bytes each)
    written, its count written.  Its operations depend on how far each
    window gets and are not counted, so the bound is the bytes'."""
    return n * plane_bytes + n * slots * 21 + 4 * n, 0
