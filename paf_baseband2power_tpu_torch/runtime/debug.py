"""Runtime checking: the per-block validation of debug mode.

The reference wraps every CUDA call in safe-call macros that abort on error
(``cudautil.cuh:9-116``) and compiles verbose tracing under ``-DDEBUG``.
Here the kernel wrappers raise on a failed launch, so what is left is the
*semantic* check: power spectra must be finite and non-negative.
:func:`check_power` enforces that per block when debug mode is on, which
the env var ``PAFB2P_DEBUG=1`` (or ``set_debug(True)``) turns on together
with verbose pipeline logging.

A copy of the JAX package's ``runtime/debug.py`` without its
``jax.profiler`` trace: the port's CLI has its own ``torch.profiler`` one.
"""

from __future__ import annotations

import os

import numpy as np


_DEBUG = os.environ.get("PAFB2P_DEBUG", "0") not in ("", "0", "false")


def debug_enabled() -> bool:
    return _DEBUG


def set_debug(on: bool) -> None:
    global _DEBUG
    _DEBUG = bool(on)


class PowerCheckError(RuntimeError):
    pass


def check_power(power: np.ndarray, block_index: int = -1,
                signed: bool = False) -> None:
    """Validate a detected power vector: finite, non-negative.

    int16 |x|^2 sums are mathematically >= 0 and bounded by
    nsamp * npol * ndim * 32768^2 < 2^52, so NaN/inf/negative values can
    only come from corrupted input or a kernel defect.

    ``signed=True`` (Stokes records: Q/U/V are legitimately negative)
    checks finiteness only.
    """
    power = np.asarray(power)
    if not np.isfinite(power).all():
        bad = int(np.count_nonzero(~np.isfinite(power)))
        raise PowerCheckError(
            f"block {block_index}: {bad} non-finite power values")
    if not signed and (power < 0).any():
        bad = int(np.count_nonzero(power < 0))
        raise PowerCheckError(
            f"block {block_index}: {bad} negative power values")
