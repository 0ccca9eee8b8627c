"""Build the package's CUDA kernels with nvcc and load them with ctypes.

The sources in ``headtrackr_tpu_torch/csrc/`` expose a plain C interface
(no PyTorch headers), so a build takes seconds.  Each source builds into
its own shared library, all nvcc processes started together, in
``build/headtrackr_tpu_torch/`` at the root of the checkout; a library is
named by a hash of its source, the headers and the flags, so an edited
source builds anew and an unchanged one is loaded from the previous build.
Nothing here runs at import time.
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
# source stem -> {C launcher: argtypes}
_SIGNATURES = {
    "histpdf": {
        "hist4096_launch": (_C, _C, _C, _I, _I, _I, _I, _C,
                            ctypes.c_longlong, _C),
        "backproject_launch": (_C, _C, _C, _I, _I, _I, _C, _C,
                               ctypes.c_longlong, _C),
        "backproject_rect_launch": (_C, _C, _C, _C, _I, _I, _I, _I, _I, _C,
                                    _C, ctypes.c_longlong, _C),
        "histpdf_band_launch": (_C, _C, _C, _C, _C, _I, _I, _I, _I, _I, _I,
                                _C, ctypes.c_longlong, _C),
    },
    "gather": {
        "take_along_launch": (_C, _C, _C, _I, _I, _I, _I, _I, _I, _C),
    },
    "histmma": {
        "hist_mma_launch": (_C, _C, _C, _C, _I, _I, _I, _I, _I, _C,
                            ctypes.c_longlong, _C),
    },
    "histbins": {
        "hist_bins_launch": (_C, _C, _I, _I, _I, _C),
    },
    "pdfbins": {
        "pdf_bins_launch": (_C, _C, _C, _I, _I, _I, _C),
    },
    "meanshift": {
        "meanshift_launch": (_C, _C, _C, _C, _C, _C, _I, _I, _I, _I, _I, _I,
                             _C),
        "meanshift_scratch_floats": (_I, _I),
        "meanshift_smem_bytes": (_I, _I, _I),
        "meanshift_smem_limits": (_C,),
    },
    "pyramid": {
        "pyramid_launch": (_C, _C, _C, _C, _C, _C, _C, _C, _I, _I, _I, _I,
                           _I, _I, _I, _I, _I, _I, _C),
    },
    "cascade": {
        "cascade_dense_launch": (_C, _C, _C, _C, _C, _I, _I, _C, _I, _I, _C,
                                 _C, _I, _I, _C, _C, _C, _C, _C, _I, _I, _I,
                                 _C),
        "cascade_deep_launch": (_C, _C, _C, _C, _C, _C, _C, _I, _I, _I, _I,
                                _I, _I, _I, _I, _I, _C, _C, _C, _C, _I, _I,
                                _I, _I, _C),
        "cascade_compact_launch": (_C, _C, _C, _C, _C, _C, _C, _C, _C, _I,
                                   _I, _I, _C),
    },
    "schedule": {
        "tick_select_launch": (_C, _C, _C, _C, _C, _C, ctypes.c_longlong,
                               _I, _I, _I, _I, ctypes.c_longlong, _C),
        "escape_select_launch": (_C, _C, _C, _C, ctypes.c_longlong, _I, _I,
                                 _C, _I, _I, ctypes.c_longlong, _C),
        "select_floor_launch": (_I, _I, _C),
        "select_scratch_bytes": (_I, _I),
        "scan_step_launch": (_C, _C, ctypes.c_longlong, _C, _I, _I, _C),
        "scan_commit_launch": (_C, _C, _C, _C, _C, _C, _I, _I, _I, _C),
        "slot_gather_launch": (_C, _C),
        "slot_gather_ctas": (_C,),
        "slot_gather_args_bytes": (),
        "sched_driver_version": (_C,),
        "sched_program_build": (_C, _I, _C, _I, _C),
        "sched_program_launch": (_C, _C),
        "sched_program_destroy": (_C,),
        "sched_error_string": (_I, _C, _I),
    },
    "epilogue": {
        "tick_epilogue_launch": (_C, ctypes.c_longlong, ctypes.c_uint, _C),
        "tick_epilogue_args_bytes": (),
        "tick_epilogue_floor_launch": (ctypes.c_longlong, _C),
    },
    "frameprep": {
        "frame_prep_launch": (_C, _I, _I, _C),
        "frame_prep_args_bytes": (),
    },
    "handoff": {
        "handoff_launch": (_C, _I, _I, _C),
        "handoff_args_bytes": (),
    },
    "group": {
        "group_launch": (_C, _C, _C, _C, _C, _C, _C, _C, _C, _C, _I, _I, _I,
                         _C),
        "group_floor_launch": (_I, _C),
    },
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
    if sorted(p.stem for p in srcs) != sorted(_SIGNATURES):
        raise RuntimeError(f"CUDA sources in {CSRC} ({[p.name for p in srcs]}) "
                           f"do not match the launchers {sorted(_SIGNATURES)}")
    return srcs


def _digest(src):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


class Library:
    """The loaded shared libraries plus what their builds printed."""

    def __init__(self, libs, paths, log):
        self._fns = {}
        for stem, lib in libs.items():
            for name, argtypes in _SIGNATURES[stem].items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                self._fns[name] = fn
        self.paths = paths  # one .so per source
        self.log = log  # nvcc's output (-Xptxas -v resource usage); "" if reused

    def fn(self, name):
        """The C launcher ``name``."""
        return self._fns[name]


@functools.lru_cache(maxsize=1)
def load_library():
    """Compile (if needed) and load the kernels; raises on any failure."""
    srcs = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sos = {p.stem: BUILD_DIR / f"{p.stem}-{_digest(p)}.so" for p in srcs}
    jobs = {}  # stem -> (process, temporary output)
    logs, failed = [], []
    try:
        for p in srcs:
            if sos[p.stem].exists():
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            jobs[p.stem] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(p)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp)
        for stem, (proc, tmp) in jobs.items():
            out, _ = proc.communicate()
            logs.append(f"[{stem}.cu]\n{out}")
            if proc.returncode != 0:
                failed.append(f"{stem}.cu ({proc.returncode})")
            else:
                os.replace(tmp, sos[stem])
    finally:
        for proc, tmp in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{log}")
    libs = {stem: ctypes.CDLL(str(so)) for stem, so in sos.items()}
    return Library(libs, list(sos.values()), log)
