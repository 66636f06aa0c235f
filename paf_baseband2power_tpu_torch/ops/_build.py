"""Build the package's CUDA kernels from ``csrc/`` at first use.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain
``extern "C"`` interface, loaded with ``ctypes`` (the pattern of the JAX
package's native ring library, ``io/ringbuffer.py``). It needs neither
``ninja`` nor PyTorch's headers, so a build takes seconds.

The library is named after a hash of the sources and flags, so an edited
source can never load a stale binary, and it is written under a temporary
name and renamed into place, so concurrent processes cannot race.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, ".build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def find_nvcc() -> str | None:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default install; None when there is none."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.access(cand, os.X_OK):
            return cand
    return None


def sources(csrc_dir: str) -> list[str]:
    return sorted(glob.glob(os.path.join(csrc_dir, "*.cu")))


def source_hash(paths: list[str]) -> str:
    """Hash of the flags and every source's name and bytes."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        h.update(os.path.basename(p).encode() + b"\0")
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build(csrc_dir: str | None = None, build_dir: str | None = None,
          nvcc: str | None = None) -> str:
    """Compile the sources (default ``csrc/``) into ``build_dir`` (default
    ``.build/``) unless a library of their hash is there; returns the
    library's path. Raises RuntimeError without ``nvcc`` or when the
    compile fails, with nvcc's output."""
    csrc_dir = csrc_dir or CSRC_DIR
    build_dir = build_dir or BUILD_DIR
    srcs = sources(csrc_dir)
    if not srcs:
        raise RuntimeError(f"no CUDA sources in {csrc_dir}")
    lib = os.path.join(build_dir, f"libpafb2p_cuda-{source_hash(srcs)}.so")
    if os.path.exists(lib):
        return lib
    nvcc = nvcc or find_nvcc()
    if not nvcc or not os.access(nvcc, os.X_OK):
        where = nvcc or "$CUDA_HOME/bin, PATH, /usr/local/cuda/bin"
        raise RuntimeError(
            f"nvcc not found ({where}): the CUDA kernels need the CUDA "
            "toolkit")
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *srcs]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode or not os.path.exists(tmp):
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"nvcc failed ({r.returncode}): {' '.join(cmd)}\n"
            f"{r.stderr}{r.stdout}")
    os.replace(tmp, lib)
    return lib


def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernels' library, with every C
    signature declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            i64, ptr, f64 = ctypes.c_int64, ctypes.c_void_p, ctypes.c_double
            sigs = {
                "pafb2p_power_wire": [ptr, i64, i64, i64, ptr, ptr],
                "pafb2p_power_rows": [ptr, i64, i64, i64, ptr, ptr],
                "pafb2p_power_finish": [ptr, ptr, i64, f64, ptr],
            }
            for name, args in sigs.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            lib.pafb2p_error_string.argtypes = [ctypes.c_int]
            lib.pafb2p_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
