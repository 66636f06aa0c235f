"""The polyphase spectrometer's full-Stokes record of a wire block, in
float64, with the overlap-save carry worked out again from the previous
block.

Windows, prototype filter and carry are those of ``pfb.py`` (its
``prototype``, ``_series`` and ``tail``). Per window and fine channel, with
x = pol 0 and y = pol 1 after the FFT (the PSR/IEEE convention that the
port's direct Stokes mode states):

    I = |x|^2 + |y|^2    Q = |x|^2 - |y|^2
    U = 2 Re(x y*)       V = 2 Im(x y*)

The record sums each over windows, fftshifts the fine channels of each
coarse channel and orders the values Stokes-major, then coarse-major:
``(1, 4, nchk * 7 * nfft)`` float32, the executor's record at ``nout`` 1.
No departure from the published mode (``--pfb N --stokes``) beyond
``pfb.py``'s: the prototype filter is a frozen copy of the program's.

The control computes the same in bfloat16: samples, FIR output and each
window's products rounded to bfloat16 (the FFT, which torch has in no
precision below float32 for these sizes, reads the rounded FIR output),
and their sums rounded again.
"""

from __future__ import annotations

import numpy as np
import torch

from .pfb import _lowp, _series, prototype, tail

STATEFUL = True


def stokes(block: torch.Tensor, halo, cfg: dict, dtype=torch.float64,
           lowp: bool = False) -> torch.Tensor:
    """The record on ``block``'s device, float32 ``(1, 4, nchan * nfft)``;
    ``halo`` is the previous block's ``tail`` or None."""
    p = cfg["pipeline"]
    nfft, ntap, nchk = p["pfb_nfft"], p["pfb_ntap"], cfg["nchk"]
    h = torch.from_numpy(prototype(nfft, ntap, p["pfb_window"])).to(
        device=block.device, dtype=dtype)
    h = _lowp(h, lowp)
    series = _series(block, nchk)
    out = torch.empty((4, nchk, 7, nfft), dtype=dtype, device=block.device)
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
        del z
        x, yy = y[:, 0], y[:, 1]
        pxx = x.real.square() + x.imag.square()
        pyy = yy.real.square() + yy.imag.square()
        xy = x * yy.conj()
        for j, q in enumerate((pxx + pyy, pxx - pyy, 2 * xy.real,
                               2 * xy.imag)):
            out[j, k] = _lowp(q, lowp).sum(dim=1)
    out = _lowp(torch.fft.fftshift(out, dim=-1), lowp)
    return out.reshape(1, 4, -1).to(torch.float32)


def record(block: torch.Tensor, prev, cfg: dict) -> np.ndarray:
    halo = None if prev is None else tail(prev, cfg)
    return stokes(block, halo, cfg).cpu().numpy()


def control(cfg: dict):
    """The reference in bfloat16, as a streaming step ``(x, carry) ->
    (record, carry)`` whose carry is the block's own tail."""

    def step(x: torch.Tensor, carry):
        x = x.reshape(x.shape[0], -1)
        out = stokes(x, carry, cfg, torch.float32, lowp=True)
        return out, tail(x, cfg)

    return step
