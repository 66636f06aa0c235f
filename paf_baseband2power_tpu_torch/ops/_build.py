"""Build the package's native code at first use.

``nvcc`` compiles every ``csrc/*.cu``, one process per source, all started
together, and links the objects into one shared library with a plain
``extern "C"`` interface, loaded with ``ctypes``. It needs neither ``ninja``
nor PyTorch's headers, so a build takes seconds. ``g++`` builds the
host library (the shared-memory ring buffer, the UDP capture engine and the
sender of ``native/``, bound by ``io/ringbuffer.py``, ``io/capture.py`` and
``io/sender.py``) the same way with :func:`build_host_library`.

Each library is named after a hash of its sources, headers and flags, so an
edited file can never load a stale binary, and it is built in a private
temporary directory and renamed into place, so concurrent processes cannot
race. The compiles run with ``-Xptxas -v``; what ptxas prints (registers,
shared memory and spills of every kernel) is kept beside the library as
``<library>.ptxas`` (:func:`ptxas_report`).
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
GXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread", "-shared")
# the host library's variants (the JAX package's ``native/Makefile``
# targets): each is built under the hash of its own flags
HOST_VARIANTS = {
    "": GXX_FLAGS,
    "debug": ("-O0", "-g", "-DPAFB2P_DEBUG", "-std=c++17", "-fPIC",
              "-pthread", "-shared"),
    "tsan": GXX_FLAGS + ("-g", "-fsanitize=thread"),
    "asan": GXX_FLAGS + ("-g", "-fsanitize=address"),
}
PTXAS_VERBOSE = ("-Xptxas", "-v")     # a report only: the code is the same

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


def source_hash(paths: list[str], flags: tuple = NVCC_FLAGS) -> str:
    """Hash of the flags and every file's name and bytes."""
    h = hashlib.sha256(" ".join(flags).encode())
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
        outs = _run_jobs([([nvcc, *NVCC_FLAGS, *PTXAS_VERBOSE, "-c", "-o", o,
                            s], o) for s, o in zip(srcs, objs)])
        tmp_lib = os.path.join(tmp, os.path.basename(lib))
        _run_jobs([([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp_lib, *objs],
                    tmp_lib)])
        report = "".join(f"== {os.path.basename(s)}\n{out}"
                         for s, out in zip(srcs, outs) if out.strip())
        if report:
            with open(tmp_lib + ".ptxas", "w") as f:
                f.write(report)
            os.replace(tmp_lib + ".ptxas", lib + ".ptxas")
        os.replace(tmp_lib, lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def build_host_library(stem: str, srcs: list[str], hdrs: list[str],
                       build_dir: str | None = None,
                       cxx: str = "g++", flags: tuple = GXX_FLAGS) -> str:
    """Compile host C++ ``srcs`` with ``cxx`` and ``flags`` into
    ``build_dir/<stem>-<hash>.so`` unless it is there; returns its path.
    Raises RuntimeError with the compiler's output when the build fails."""
    build_dir = build_dir or BUILD_DIR
    lib = os.path.join(
        build_dir, f"{stem}-{source_hash(srcs + hdrs, flags)}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(build_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".build-", dir=build_dir)
    try:
        tmp_lib = os.path.join(tmp, os.path.basename(lib))
        _run_jobs([([cxx, *flags, "-o", tmp_lib, *srcs, "-lrt"],
                    tmp_lib)])
        os.replace(tmp_lib, lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def ptxas_report(lib: str) -> str:
    """What ptxas printed when ``lib`` was built ("" when it printed
    nothing): for each source, ``== <name>.cu`` and then its lines."""
    try:
        with open(lib + ".ptxas") as f:
            return f.read()
    except FileNotFoundError:
        return ""


def sass_counts(lib: str, ops: tuple = ("HGMMA", "HMMA")
                ) -> dict[str, dict[str, int]]:
    """``{kernel: {op: n}}``: the instructions ``ops`` (by default the
    tensor cores') in each kernel's SASS (mangled names), from ``cuobjdump
    -sass`` of ``lib``, the tool beside ``nvcc``. An instruction counts for
    the first of ``ops`` it is."""
    tool = os.path.join(os.path.dirname(find_nvcc() or ""), "cuobjdump")
    if not os.access(tool, os.X_OK):
        tool = shutil.which("cuobjdump") or tool
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    counts: dict[str, dict[str, int]] = {}
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = dict.fromkeys(ops, 0)
        elif name:
            for op in ops:
                if f" {op}." in line or f" {op} " in line:
                    counts[name][op] += 1
                    break
    return counts


def _run_jobs(jobs: list[tuple[list[str], str]]) -> list[str]:
    """Start every ``(command, output file)`` job at once and wait for all
    of them; returns each job's stderr and stdout. Raises with the
    compiler's output for the first that did not write its file."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd, _ in jobs]
    outs = [p.communicate() for p in procs]
    for (cmd, path), p, (stdout, stderr) in zip(jobs, procs, outs):
        if p.returncode or not os.path.exists(path):
            raise RuntimeError(f"{os.path.basename(cmd[0])} failed "
                               f"({p.returncode}): {' '.join(cmd)}\n"
                               f"{stderr}{stdout}")
    return [stderr + stdout for stderr, stdout in outs]


_SIGNATURES = {
    "pafb2p_pfb": "p i l l l l l i p p l l p p p p",
    "pafb2p_pfb_finish": "p p l l l l l i d d p",
    "pafb2p_power_wire": "p l l l p p",
    "pafb2p_power_rows": "p l l l p p",
    "pafb2p_power_finish": "p p l l d p",
    "pafb2p_stokes_wire": "p l l l p p",
    "pafb2p_stokes_rows": "p l l l p p",
    "pafb2p_stokes_finish": "p p l l d p",
    "pafb2p_probe_micro": "p l l i i i p p",
    "pafb2p_probe_planes": "p l i l i i i p p p",
    "pafb2p_probe_karatsuba": "p l l i i p p p p p p",
    "pafb2p_probe_tile_sum": "p p l l l p",
    "pafb2p_host_register": "p l",
    "pafb2p_host_unregister": "p",
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_int64,
           "d": ctypes.c_double}


def bind_library(path: str) -> ctypes.CDLL:
    """Load a kernels' library with the C signature of every entry point
    it has declared."""
    lib = ctypes.CDLL(path)
    for name, sig in _SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = [_CTYPES[c] for c in sig.split()]
            fn.restype = ctypes.c_int
    lib.pafb2p_error_string.argtypes = [ctypes.c_int]
    lib.pafb2p_error_string.restype = ctypes.c_char_p
    return lib


def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernels' library, with every C
    signature declared."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = bind_library(build())
        return _lib
