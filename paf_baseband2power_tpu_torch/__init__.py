"""paf_baseband2power_tpu_torch: the PAF baseband->power framework on
PyTorch and CUDA, for one NVIDIA H100.

A port of ``paf_baseband2power_tpu`` (the JAX/TPU package, kept as the
reference it is tested against). The port imports ``torch`` and never
``jax`` and nothing of the reference package: it keeps its own copies of
the numpy/ctypes modules it needs (constants, the INI config, DADA and
ring-buffer I/O, the UDP capture engine and sender, the frame codec and
time bookkeeping, logging and debug checks, the synthetic recorder and the
ring tools).

Layers:
    ops/       plain PyTorch power, Stokes and PFB paths and the CUDA kernel
               bindings
    csrc/      hand-written CUDA kernels (sm_90a), built with nvcc at first use
    probes/    measurement probes of the spectrometer (micro, planes,
               Karatsuba), each a CUDA kernel beside its plain version
    io/        DADA files, the shared-memory ring, UDP capture and the
               sender (native/, g++ at first use)
    runtime/   streaming executor (pinned staging, H2D, kernel, sink)
    cli/       the compute stage (paf_baseband2power), the launcher, the
               ring tools (paf_diskdb, paf_dbdisk, paf_db, paf_monitor),
               paf_capture, paf_soak and paf_gen
"""

from . import constants

__version__ = "0.1.0"
__all__ = ["constants", "__version__"]
