"""The polyphase spectrometer's power record of a wire block, in float64,
with the overlap-save carry worked out again from the previous block.

Each coarse channel's pol series ``n = f * 128 + s`` (frame f, sample s)
is cut into rows of ``nfft`` samples. Window ``w`` is
``fft(sum_t h[t] * row[w + t])`` with ``h`` the windowed-sinc prototype
folded to ``(ntap, nfft)``. A stream's first block has the windows that
lie inside it; every later block also has the ``ntap - 1`` windows that
begin in the previous block's last ``(ntap - 1) * nfft`` samples. The
record sums ``|y|^2`` over pols and windows, fftshifts the fine channels
of each coarse channel and orders them coarse-major: ``(nchk * 7 * nfft,)``
float32.

The control computes the same in bfloat16: samples, FIR output and power
rounded to bfloat16 (the FFT, which torch has in no precision below
float32 for these sizes, reads the rounded FIR output).
"""

from __future__ import annotations

import numpy as np
import torch

STATEFUL = True


def prototype(nfft: int, ntap: int, window: str) -> np.ndarray:
    """Windowed sinc with its cutoff at the fine-channel width, folded to
    ``(ntap, nfft)`` and scaled to unit mean DC gain per phase (frozen copy
    of the program's prototype filter, so both sides filter alike)."""
    n = np.arange(ntap * nfft, dtype=np.float64)
    sinc = np.sinc(n / nfft - ntap / 2.0)
    win = {"hamming": np.hamming, "hanning": np.hanning,
           "rect": np.ones}[window](ntap * nfft)
    h = (sinc * win).reshape(ntap, nfft)
    return h / h.sum(axis=0).mean()


def _series(block: torch.Tensor, nchk: int) -> torch.Tensor:
    """Wire block -> ``(nchk, 7, 2, ndf * 128, 2)`` int16 pol series."""
    ndf = block.shape[0]
    return (block.reshape(ndf, nchk, 128, 7, 2, 2).permute(1, 3, 4, 0, 2, 5)
            .reshape(nchk, 7, 2, ndf * 128, 2))


def tail(block: torch.Tensor, cfg: dict) -> torch.Tensor:
    """The last ``(ntap - 1) * nfft`` samples of every series, a copy."""
    p = cfg["pipeline"]
    halo = (p["pfb_ntap"] - 1) * p["pfb_nfft"]
    return _series(block, cfg["nchk"])[:, :, :, -halo:].contiguous()


def _lowp(x: torch.Tensor, lowp: bool) -> torch.Tensor:
    """``x`` rounded to bfloat16 (each part of a complex ``x``)."""
    if not lowp:
        return x
    if x.is_complex():
        r = torch.view_as_real(x)
        return torch.view_as_complex(r.to(torch.bfloat16).to(r.dtype))
    return x.to(torch.bfloat16).to(x.dtype)


def spectrum(block: torch.Tensor, halo, cfg: dict, dtype=torch.float64,
             lowp: bool = False) -> torch.Tensor:
    """The record on ``block``'s device, float32; ``halo`` is the previous
    block's ``tail`` or None."""
    p = cfg["pipeline"]
    nfft, ntap, nchk = p["pfb_nfft"], p["pfb_ntap"], cfg["nchk"]
    h = torch.from_numpy(prototype(nfft, ntap, p["pfb_window"])).to(
        device=block.device, dtype=dtype)
    h = _lowp(h, lowp)
    series = _series(block, nchk)
    out = torch.empty((nchk, 7, nfft), dtype=dtype, device=block.device)
    for k in range(nchk):
        s = series[k]
        if halo is not None:
            s = torch.cat([halo[k], s], dim=2)
        v = _lowp(torch.view_as_complex(s.to(dtype).contiguous()), lowp)
        rows = v.reshape(7, 2, -1, nfft)
        nwin = rows.shape[2] - (ntap - 1)
        z = h[0] * rows[:, :, 0:nwin]
        for t in range(1, ntap):
            z = z + h[t] * rows[:, :, t:t + nwin]
        y = torch.fft.fft(_lowp(z, lowp), dim=-1)
        out[k] = (y.real.square() + y.imag.square()).sum(dim=(1, 2))
    out = _lowp(torch.fft.fftshift(out, dim=-1), lowp)
    return out.reshape(-1).to(torch.float32)


def record(block: torch.Tensor, prev, cfg: dict) -> np.ndarray:
    halo = None if prev is None else tail(prev, cfg)
    return spectrum(block, halo, cfg).cpu().numpy()


def control(cfg: dict):
    """The reference in bfloat16, as a streaming step ``(x, carry) ->
    (record, carry)`` whose carry is the block's own tail."""

    def step(x: torch.Tensor, carry):
        x = x.reshape(x.shape[0], -1)
        out = spectrum(x, carry, cfg, torch.float32, lowp=True)
        return out, tail(x, cfg)

    return step
