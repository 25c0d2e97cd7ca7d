"""Build and load the CUDA split-GEMM kernels at first use.

The sources under ``csrc/`` are compiled with ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes``.  The
library lands in ``build/repro_torch_kernels/`` at the root of the
checkout (listed in ``.gitignore``), named by a hash of the sources and
the flags, so an edited source rebuilds and an unchanged one loads the
library already there.  Nothing is built when the package is imported:
the CPU tests import every module and have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

__all__ = ["load", "build_info", "NVCC_FLAGS"]

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
              / "repro_torch_kernels")
_SOURCES = ("split_gemm.cu",)

# sm_90a: Hopper with its architecture-specific features.  -fmad=false
# keeps the compiler from contracting a multiply and an add into an FMA
# anywhere (the TwoSum chains already use explicit _rn intrinsics);
# --use_fast_math is never passed.  -Xptxas -v reports registers, shared
# memory and spills in the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_INFO: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                       "the CUDA split-GEMM kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256()
    for name in _SOURCES:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _compile(out: pathlib.Path) -> str:
    """Run nvcc into a temporary file, then move it into place."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[str(_CSRC / name) for name in _SOURCES]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stderr}{proc.stdout}")
    os.replace(tmp, out)
    return proc.stderr + proc.stdout


def _bind(lib: ctypes.CDLL) -> None:
    lib.split_gemm_launch.argtypes = [
        _P, _P, _P, _P, _I, _I, _I, _I, _IP, _IP, _IP, _I, _I, _P]
    lib.split_gemm_launch.restype = _I
    lib.split_gemm_fused_launch.argtypes = [
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _IP, _IP, _IP, _I,
        _I, _P]
    lib.split_gemm_fused_launch.restype = _I
    lib.split_gemm_v1_launch.argtypes = [
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    lib.split_gemm_v1_launch.restype = _I
    lib.split_gemm_error_string.argtypes = [_I]
    lib.split_gemm_error_string.restype = ctypes.c_char_p


def load() -> ctypes.CDLL:
    """The kernel library, built from ``csrc/`` if not built yet."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = _BUILD_DIR / f"split_gemm_{_digest()}.so"
        t0 = time.perf_counter()
        log = ""
        built = not path.exists()
        if built:
            log = _compile(path)
        lib = ctypes.CDLL(str(path))
        _bind(lib)
        _INFO.update(path=str(path), built=built, log=log,
                     seconds=time.perf_counter() - t0)
        _LIB = lib
        return lib


def build_info() -> dict:
    """Path, whether this process compiled it, nvcc's log and seconds."""
    return dict(_INFO)
