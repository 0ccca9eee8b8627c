"""Build the package's CUDA kernels with nvcc and load them with ctypes.

The sources in ``headtrackr_tpu_torch/csrc/`` expose a plain C interface
(no PyTorch headers), so a build takes seconds.  The shared library goes to
``build/headtrackr_tpu_torch/`` at the root of the checkout, named by a hash
of the sources and flags: an edited source builds anew, an unchanged one is
loaded from the previous build.  Nothing here runs at import time.
"""

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

__all__ = ["load_library", "BUILD_DIR", "NVCC_FLAGS"]

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "headtrackr_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_C = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "hist4096_launch": (_C, _C, _C, _I, _I, _I, _C),
    "backproject_launch": (_C, _C, _C, _I, _I, _I, _C),
    "backproject_rect_launch": (_C, _C, _C, _C, _I, _I, _I, _I, _I, _C),
    "histpdf_band_launch": (_C, _C, _C, _C, _C, _I, _I, _I, _I, _I, _C),
}


def _nvcc():
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    path = cand if os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and PATH); "
                           "the CUDA kernels need the CUDA toolkit")
    return path


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources in {CSRC}")
    return srcs


def _digest():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


class Library:
    """The loaded shared library plus what its build printed."""

    def __init__(self, lib, path, log):
        self.lib = lib
        self.path = path
        self.log = log  # nvcc's output (-Xptxas -v resource usage); "" if reused


@functools.lru_cache(maxsize=1)
def load_library():
    """Compile (if needed) and load the kernels; raises on any failure."""
    srcs = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"histpdf-{_digest()}.so"
    log = ""
    if not so.exists():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, srcs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return Library(lib, so, log)
