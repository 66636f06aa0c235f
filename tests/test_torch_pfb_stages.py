"""The PFB kernel's staged sample ring (``csrc/pfb.cu``): at the shapes
where copying a step's samples one step ahead can go wrong, the kernel
stays within 2e-5 (peak-normalized) of the float64 plain version, and two
calls are bit-equal. A tile with fewer steps than stages, one-shot blocks,
ntap 1 and 8, the rows layout, Stokes, nfft 128 and 1024. The launches,
counted by the depth the kernel reports, take two stages at every shape
of nfft 256-1024 but nfft 512 at ntap 8, where on an H100 two would leave
an SM one block instead of two (the occupancy API), and one at nfft <=
128, where the samples are loaded. At nfft 256-1024 a transpose in shared
memory takes the FFT's lane factor, and the launches count 2, 1 and 0
cross-lane shuffle stages; at nfft <= 128, log2 of the lanes an FFT spans.

Card only (marker ``cuda``; ``python -m pytest
tests/test_torch_pfb_stages.py -m cuda --noconftest``). This file imports
nothing of JAX, so that it runs on the card.
"""

import pytest
import torch

from paf_baseband2power_tpu_torch.ops import cuda_pfb as CF
from paf_baseband2power_tpu_torch.ops import pfb as PF
from paf_baseband2power_tpu_torch.probes._common import PARITY_BOUND, peak_err

NCHK = 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


# (nfft, ntap, ndf, nout, stokes, layout, carry)
CASES = {
    "1024 one step a tile (wpg 4)": (1024, 4, 64, 2, False, "wire", True),
    "1024 wpg 3, one-shot": (1024, 4, 96, 4, True, "wire", False),
    "1024 two tiles a spectrum": (1024, 4, 512, 1, False, "wire", True),
    "1024 one-shot Stokes": (1024, 4, 256, 1, True, "wire", False),
    "1024 ntap 1": (1024, 1, 256, 1, False, "wire", False),
    "1024 ntap 8 rows Stokes": (1024, 8, 256, 2, True, "rows", True),
    "1024 rows": (1024, 4, 256, 1, False, "rows", True),
    "512 ntap 8 Stokes": (512, 8, 256, 1, True, "wire", True),
    "512 ntap 8 rows, one-shot": (512, 8, 128, 2, False, "rows", False),
    "256 rows": (256, 4, 128, 2, False, "rows", True),
    "128 one step a tile (wpg 8)": (128, 8, 64, 8, True, "wire", False),
    "128 rows": (128, 4, 256, 1, False, "rows", True),
    "128 ntap 1 Stokes": (128, 1, 256, 4, True, "wire", False),
}


def _depth(nfft: int, ntap: int) -> int:
    return 1 if nfft < 256 or (nfft, ntap) == (512, 8) else 2


def _lane_stages(nfft: int) -> int:
    lanes = 1024 // nfft if nfft >= 256 else min(nfft, 32)
    return lanes.bit_length() - 1


def _block(g, ndf: int, layout: str, device) -> torch.Tensor:
    x = torch.randint(-32768, 32768, (ndf, NCHK * 3584), generator=g,
                      device=device, dtype=torch.int16)
    return x if layout == "wire" else x.view(NCHK * 14, ndf, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_staged_ring_against_float64(cuda_device, case):
    nfft, ntap, ndf, nout, stokes, layout, carry = CASES[case]
    g = torch.Generator(device=cuda_device)
    g.manual_seed(nfft * 100 + ntap * 10 + nout)
    x = _block(g, ndf, layout, cuda_device)
    hist = (PF.pfb_history(_block(g, ndf, layout, cuda_device), nfft, ntap,
                           layout) if carry else None)
    want = PF.pfb_spectra(x, nfft, ntap, nout=nout, stokes=stokes,
                          history=hist, layout=layout, dtype=torch.float64)
    before = CF.stage_depths.copy()
    got = [CF.pfb_spectra_cuda(x, nfft, ntap, nout=nout, stokes=stokes,
                               history=hist, layout=layout)
           for _ in range(2)]
    assert CF.stage_depths - before == {_depth(nfft, ntap): 2}
    assert torch.equal(got[0], got[1]), "two calls differ"
    err = peak_err(got[0], want)[1]
    assert err < PARITY_BOUND, f"{err:.3e} against float64"


@pytest.mark.cuda
@pytest.mark.parametrize("nfft", [2, 32, 128, 256, 512, 1024])
def test_stage_depths(cuda_device, nfft):
    layouts = ("wire", "rows") if nfft >= 128 else ("wire",)
    g = torch.Generator(device=cuda_device)
    g.manual_seed(nfft)
    depths = {}
    for layout in layouts:
        x = _block(g, 128, layout, cuda_device)
        for ntap in range(1, CF.CUDA_MAX_NTAP + 1):
            for stokes in (False, True):
                before = CF.stage_depths.copy()
                CF.pfb_spectra_cuda(x, nfft, ntap, stokes=stokes,
                                    layout=layout)
                depths[(ntap, stokes, layout)] = CF.stage_depths - before
    assert all(d == {_depth(nfft, ntap): 1}
               for (ntap, _, _), d in depths.items()), depths


@pytest.mark.cuda
@pytest.mark.parametrize("nfft", [8, 128, 256, 512, 1024])
def test_fft_lane_stages(cuda_device, nfft):
    layouts = ("wire", "rows") if nfft >= 128 else ("wire",)
    g = torch.Generator(device=cuda_device)
    g.manual_seed(nfft + 1)
    lanes = {}
    for layout in layouts:
        x = _block(g, 128, layout, cuda_device)
        for stokes in (False, True):
            before = CF.fft_lane_stages.copy()
            CF.pfb_spectra_cuda(x, nfft, 4, stokes=stokes, layout=layout)
            lanes[(stokes, layout)] = CF.fft_lane_stages - before
        before = CF.fft_lane_stages.copy()
        CF.pfb_power_cuda(x, nfft, 4, layout=layout)
        lanes[("power wrapper", layout)] = CF.fft_lane_stages - before
    assert all(n == {_lane_stages(nfft): 1} for n in lanes.values()), lanes
