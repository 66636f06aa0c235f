"""Direct power per channel of a wire block, exactly.

Wire layout: frame f, chunk k holds 7168 B = (128 samples, 7 channels,
2 pols, 2 dims) of int16, so a block views as ``(ndf, nchk, 128, 7, 2, 2)``
and channel ``k * 7 + c`` sums the squares of every sample, pol and dim of
its frames. The sums are int64 (at most 8192 * 512 terms below 2^30, so
below 2^53) and are rounded once to float32 through float64.
"""

from __future__ import annotations

import numpy as np
import torch

STATEFUL = False
_SLAB_FRAMES = 256      # frames per int64 temporary (0.7 GB at 48 chunks)


def _channels(block: torch.Tensor, nchk: int) -> torch.Tensor:
    return block.reshape(block.shape[0], nchk, 128, 7, 4)


def sums(block: torch.Tensor, nchk: int, dtype=torch.int64) -> torch.Tensor:
    """``(nchk * 7,)`` sums of squares of ``block``, accumulated in
    ``dtype`` slab by slab of frames."""
    total = torch.zeros(nchk * 7, dtype=dtype, device=block.device)
    for f0 in range(0, block.shape[0], _SLAB_FRAMES):
        x = _channels(block[f0:f0 + _SLAB_FRAMES], nchk).to(dtype)
        total += (x * x).sum(dim=(0, 2, 4)).reshape(-1)
    return total


def record(block: torch.Tensor, prev, cfg: dict) -> np.ndarray:
    s = sums(block, cfg["nchk"])
    return s.to(torch.float64).to(torch.float32).cpu().numpy()


def control(cfg: dict):
    """The reference with float32 sums in place of exact ones."""
    nchk = cfg["nchk"]

    def step(x: torch.Tensor) -> torch.Tensor:
        return sums(x.reshape(x.shape[0], -1), nchk, torch.float32)

    return step
