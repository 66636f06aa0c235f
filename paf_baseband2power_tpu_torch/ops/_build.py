"""Build the package's CUDA kernels from ``csrc/`` at first use.

``nvcc`` compiles every ``csrc/*.cu``, one process per source, all started
together, and links the objects into one shared library with a plain
``extern "C"`` interface, loaded with ``ctypes`` (the pattern of the JAX
package's native ring library, ``io/ringbuffer.py``). It needs neither
``ninja`` nor PyTorch's headers, so a build takes seconds.

The library is named after a hash of the sources, headers and flags, so an
edited file can never load a stale binary, and it is built in a private
temporary directory and renamed into place, so concurrent processes cannot
race.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, ".build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

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


def headers(csrc_dir: str) -> list[str]:
    return sorted(glob.glob(os.path.join(csrc_dir, "*.cuh")))


def source_hash(paths: list[str]) -> str:
    """Hash of the flags and every file's name and bytes."""
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
    lib = os.path.join(
        build_dir,
        f"libpafb2p_cuda-{source_hash(srcs + headers(csrc_dir))}.so")
    if os.path.exists(lib):
        return lib
    nvcc = nvcc or find_nvcc()
    if not nvcc or not os.access(nvcc, os.X_OK):
        where = nvcc or "$CUDA_HOME/bin, PATH, /usr/local/cuda/bin"
        raise RuntimeError(
            f"nvcc not found ({where}): the CUDA kernels need the CUDA "
            "toolkit")
    os.makedirs(build_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".build-", dir=build_dir)
    try:
        objs = [os.path.join(tmp, f"{os.path.basename(s)}.o") for s in srcs]
        _run_nvcc([([nvcc, *NVCC_FLAGS, "-c", "-o", o, s], o)
                   for s, o in zip(srcs, objs)])
        tmp_lib = os.path.join(tmp, os.path.basename(lib))
        _run_nvcc([([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp_lib, *objs],
                    tmp_lib)])
        os.replace(tmp_lib, lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def _run_nvcc(jobs: list[tuple[list[str], str]]) -> None:
    """Start every ``(command, output file)`` job at once and wait for all
    of them; raise with nvcc's output for the first that did not write its
    file."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd, _ in jobs]
    outs = [p.communicate() for p in procs]
    for (cmd, path), p, (stdout, stderr) in zip(jobs, procs, outs):
        if p.returncode or not os.path.exists(path):
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(cmd)}\n{stderr}{stdout}")


def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernels' library, with every C
    signature declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            i64, ptr, f64 = ctypes.c_int64, ctypes.c_void_p, ctypes.c_double
            i32 = ctypes.c_int
            sigs = {
                "pafb2p_pfb": [ptr, i32, i64, i64, i64, i64, i64, i32, ptr,
                               ptr, i64, i64, ptr, ptr],
                "pafb2p_pfb_finish": [ptr, ptr, i64, i64, i64, i64, i64, i32,
                                      f64, f64, ptr],
                "pafb2p_power_wire": [ptr, i64, i64, i64, ptr, ptr],
                "pafb2p_power_rows": [ptr, i64, i64, i64, ptr, ptr],
                "pafb2p_power_finish": [ptr, ptr, i64, i64, f64, ptr],
                "pafb2p_stokes_wire": [ptr, i64, i64, i64, ptr, ptr],
                "pafb2p_stokes_rows": [ptr, i64, i64, i64, ptr, ptr],
                "pafb2p_stokes_finish": [ptr, ptr, i64, i64, f64, ptr],
            }
            for name, args in sigs.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            lib.pafb2p_error_string.argtypes = [ctypes.c_int]
            lib.pafb2p_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
