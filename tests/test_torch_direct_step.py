"""The direct step's card path on the CPU: each of the six detection
wrappers of ``ops/cuda_power.py`` and ``PowerPipeline`` in each direct mode
give a CUDA block the record shape, the kernel family, the ``mean`` divisor
and the ``launches`` key of their mode. The tensors are fake
(``FakeTensorMode``) and the two library calls (``_accumulate``, the
window sums, and ``_finish``, their epilogue) are replaced by stand-ins
that record what they were asked for.
"""

import pytest
import torch

from paf_baseband2power_tpu_torch import constants as C
from paf_baseband2power_tpu_torch.ops import cuda_power as CP
from paf_baseband2power_tpu_torch.runtime.pipeline import PowerPipeline

NDF, NCHK = 32, 4
NCHAN = NCHK * C.NCHAN_CHK
NSERIES = 2 * NCHAN
WIRE = (NDF, NCHK * C.DT_SIZE // 2)
ROWS = (NSERIES, NDF, 2 * C.NSAMP_DF)


def _wrapper(name, nout):
    fn = getattr(CP, name)
    if name in ("baseband2power_cuda", "baseband2stokes_cuda"):
        return lambda x: fn(x, mean=True)
    return lambda x: fn(x, nout, mean=True)


def _pipeline(stokes, layout, nout):
    pipe = PowerPipeline("cuda", mean=True, nout=nout, stokes=stokes,
                         device_layout=layout == "rows")
    return pipe.power


# (what runs, its input layout, nout, Stokes) -> (record shape, launches key)
CASES = {
    ("baseband2power_cuda", "wire", 1, False):
        ((NCHAN,), "baseband2power_cuda"),
    ("baseband2power_scrunch_cuda", "wire", 4, False):
        ((4, NCHAN), "baseband2power_scrunch_cuda"),
    ("baseband2power_scrunch_cuda", "wire", 1, False):
        ((1, NCHAN), "baseband2power_scrunch_cuda"),
    ("baseband2power_scrunch_rows_cuda", "rows", 4, False):
        ((4, NCHAN), "baseband2power_scrunch_rows_cuda"),
    ("baseband2power_scrunch_rows_cuda", "rows", 1, False):
        ((1, NCHAN), "baseband2power_scrunch_rows_cuda"),
    ("baseband2stokes_cuda", "wire", 1, True):
        ((4, NCHAN), "baseband2stokes_cuda"),
    ("baseband2stokes_scrunch_cuda", "wire", 4, True):
        ((4, 4, NCHAN), "baseband2stokes_scrunch_cuda"),
    ("baseband2stokes_scrunch_cuda", "wire", 1, True):
        ((1, 4, NCHAN), "baseband2stokes_scrunch_cuda"),
    ("baseband2stokes_scrunch_rows_cuda", "rows", 4, True):
        ((4, 4, NCHAN), "baseband2stokes_scrunch_rows_cuda"),
    ("baseband2stokes_scrunch_rows_cuda", "rows", 1, True):
        ((1, 4, NCHAN), "baseband2stokes_scrunch_rows_cuda"),
    ("PowerPipeline", "wire", 1, False): ((NCHAN,), "baseband2power_cuda"),
    ("PowerPipeline", "wire", 4, False):
        ((4, NCHAN), "baseband2power_scrunch_cuda"),
    ("PowerPipeline", "wire", 1, True): ((4, NCHAN), "baseband2stokes_cuda"),
    ("PowerPipeline", "wire", 4, True):
        ((4, 4, NCHAN), "baseband2stokes_scrunch_cuda"),
    ("PowerPipeline", "rows", 1, False):
        ((NCHAN,), "baseband2power_scrunch_rows_cuda"),
    ("PowerPipeline", "rows", 4, False):
        ((4, NCHAN), "baseband2power_scrunch_rows_cuda"),
    ("PowerPipeline", "rows", 1, True):
        ((4, NCHAN), "baseband2stokes_scrunch_rows_cuda"),
    ("PowerPipeline", "rows", 4, True):
        ((4, 4, NCHAN), "baseband2stokes_scrunch_rows_cuda"),
}


@pytest.mark.parametrize("what,layout,nout,stokes", sorted(CASES))
def test_direct_step_shape_and_launch_key(what, layout, nout, stokes,
                                          monkeypatch):
    """One launch of the mode's kernel family on its layout, counted under
    the mode's wrapper, with the ``mean`` divisor of its window, and the
    record in the mode's shape."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    shape, key = CASES[what, layout, nout, stokes]
    asked = []

    def accumulate(family, lay, x, dims, acc_shape):
        asked.append((family, lay, tuple(x.shape), dims, acc_shape))
        return torch.zeros(acc_shape, dtype=torch.int64, device=x.device)

    def finish(family, acc, divisor):
        asked.append((family, divisor))
        return torch.empty(acc.shape, dtype=torch.float32, device=acc.device)

    monkeypatch.setattr(CP, "_accumulate", accumulate)
    monkeypatch.setattr(CP, "_finish", finish)
    family = "stokes" if stokes else "power"
    ndf_w = NDF // nout
    divisor = ndf_w * C.NSAMP_DF * (1 if stokes else C.NPOL_SAMP)
    nsum = (nout, 4, NCHAN) if stokes else (nout, NCHAN)
    dims = (NDF, NCHK) if layout == "wire" else (NSERIES, NDF)
    step = (_pipeline(stokes, layout, nout) if what == "PowerPipeline"
            else _wrapper(what, nout))
    before = CP.launches.copy()
    with FakeTensorMode():
        x = torch.empty(WIRE if layout == "wire" else ROWS,
                        dtype=torch.int16, device="cuda")
        out = step(x)
        assert out.device.type == "cuda"
    assert tuple(out.shape) == shape and out.dtype == torch.float32
    assert asked == [(family, layout, tuple(x.shape), dims, nsum),
                     (family, divisor)]
    after = CP.launches.copy()
    after.subtract(before)
    assert {k: v for k, v in after.items() if v} == {key: 1}
