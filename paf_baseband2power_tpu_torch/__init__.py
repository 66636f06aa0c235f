"""paf_baseband2power_tpu_torch: the PAF baseband->power framework on
PyTorch and CUDA, for one NVIDIA H100.

A port of ``paf_baseband2power_tpu`` (the JAX/TPU package, kept as the
reference it is tested against). The port imports ``torch`` and never
``jax``; it reuses the reference package's numpy/ctypes modules (constants,
DADA and ring-buffer I/O, frame codec, golden model, logging) as they are.

Layers:
    ops/       plain PyTorch power path and the CUDA kernel bindings
    csrc/      hand-written CUDA kernels (sm_90a), built with nvcc at first use
    runtime/   streaming executor (pinned staging, H2D, kernel, sink)
    cli/       paf_baseband2power entry point
"""

from paf_baseband2power_tpu import constants

__version__ = "0.1.0"
__all__ = ["constants", "__version__"]
