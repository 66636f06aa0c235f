"""Published peaks of one NVIDIA H100 SXM and the least time of a block's
work, from the configuration's shapes alone.

Copies of the port's ``h100.py`` peaks and of ``chip_smoke.py``'s
``bound`` and ``pfb_ops``, so that the yardstick stays here.
"""

from __future__ import annotations

import math

HBM_BPS = 3.35e12       # HBM3 bytes/s
FP32_FLOPS = 67e12      # fp32 FLOP/s outside the tensor cores


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    """The least time in ms the card could take: bytes moved over the HBM
    rate or fp32 operations over the fp32 rate, the larger, and which."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, nops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pfb_ops(nsamp: int, nfft: int, ntap: int, stokes: bool) -> float:
    """fp32 operations of the PFB on ``nsamp`` complex samples: FIR
    (4 ntap), radix-2 FFT (5 log2 nfft) and detection (4 power, 6 Stokes)
    per sample."""
    return nsamp * (4 * ntap + 5 * math.log2(nfft) + (6 if stokes else 4))


def block_bound(cfg: dict) -> tuple[float, str]:
    """Least ms of one block of ``cfg``: its int16 read once and its record
    written once, or its least fp32 operations (square and add per int16
    for direct detection; ``pfb_ops`` for the PFB)."""
    p = cfg["pipeline"]
    n16 = cfg["ndf"] * cfg["nchk"] * cfg["frame_bytes"] // 2
    nchan = cfg["nchk"] * 7
    ns = 4 if p.get("stokes") else 1
    nfft = p.get("pfb_nfft") or 0
    out_floats = p.get("nout", 1) * ns * nchan * max(nfft, 1)
    ops = (pfb_ops(n16 // 2, nfft, p.get("pfb_ntap", 4), ns == 4) if nfft
           else n16 * (4 if ns == 4 else 2))
    return bound(n16 * 2 + out_floats * 4, ops)
