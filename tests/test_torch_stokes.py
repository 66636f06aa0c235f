"""The port's full-Stokes ops on the CPU: the plain PyTorch versions against
the float64 golden model (bit-equal), the JAX XLA functions and the Pallas
kernels K5-K8 they stand in for (interpret mode), constructed polarisation
states and extreme blocks (exact), and the CUDA bindings' CPU dispatch.

Tolerance against JAX: ``assert_close`` of ``tests/test_spectra.py``, rtol
2e-4 with an absolute floor of 1e-5 x the peak. It comes from float32 sums
on the JAX side and Q's cancellation (xx - yy of two large sums); the port
sums in int64 and is exact, hence bit-equal to the golden.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paf_baseband2power_tpu import constants as C
from paf_baseband2power_tpu.ops import frame as F
from paf_baseband2power_tpu.ops import pallas_power as PP
from paf_baseband2power_tpu.ops import power as JP
from paf_baseband2power_tpu.ops.golden import (
    baseband2power_golden,
    baseband2stokes_golden,
    baseband2stokes_scrunch_golden,
)
from paf_baseband2power_tpu_torch.ops import _build
from paf_baseband2power_tpu_torch.ops import cuda_power as CP
from paf_baseband2power_tpu_torch.ops import power as P


def assert_close(got, want, rtol=2e-4):
    """Scale-aware parity: Q/U/V of noise sit near zero by cancellation, so
    absolute error is bounded by the detection scale (I), not the value."""
    atol = 1e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _block(ndf, nchk, seed=0):
    return F.synthetic_block(rng=seed, ndf=ndf, nchk=nchk)


def _wire(block):
    return torch.from_numpy(block.reshape(block.shape[0], -1))


def _rows(block, two_d=False):
    r = F.block_to_rows(block)
    return torch.from_numpy(r.reshape(r.shape[0], -1) if two_d else r)


# --- plain versions vs the float64 golden: bit-equal ----------------------


@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("nchk", [48, 4])
def test_stokes_2d_bit_equal_golden(nchk, mean):
    block = _block(32, nchk, seed=nchk)
    got = P.baseband2stokes_2d(_wire(block), mean=mean)
    assert got.dtype == torch.float32 and got.shape == (4, nchk * 7)
    np.testing.assert_array_equal(got.numpy(),
                                  baseband2stokes_golden(block, mean=mean))


# 24-frame blocks give odd nout and windows whose mean divisor is not a
# power of two, so dividing in float32 would round differently.
@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("nchk", [48, 4])
@pytest.mark.parametrize("ndf,nout", [(24, 1), (24, 3), (24, 4), (32, 1),
                                      (32, 4), (32, 32)])
def test_stokes_scrunch_2d_bit_equal_golden(ndf, nout, nchk, mean):
    block = _block(ndf, nchk, seed=7)
    got = P.baseband2stokes_scrunch_2d(_wire(block), nout, mean=mean)
    assert got.shape == (nout, 4, nchk * 7)
    np.testing.assert_array_equal(
        got.numpy(), baseband2stokes_scrunch_golden(block, nout, mean=mean))


@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("nout", [1, 2, 4, 8])
@pytest.mark.parametrize("two_d", [False, True])
@pytest.mark.parametrize("nchk", [48, 4])
def test_stokes_rows_bit_equal_golden(nchk, two_d, nout, mean):
    block = _block(32, nchk, seed=9)
    got = P.baseband2stokes_scrunch_rows(_rows(block, two_d), nout,
                                         mean=mean)
    assert got.shape == (nout, 4, nchk * 7)
    np.testing.assert_array_equal(
        got.numpy(), baseband2stokes_scrunch_golden(block, nout, mean=mean))


def test_stokes_I_is_power_and_mean_has_no_pol_factor():
    block = _block(16, 4, seed=5)
    s = P.baseband2stokes_2d(_wire(block))
    np.testing.assert_array_equal(s[0].numpy(), baseband2power_golden(block))
    assert P.stokes_mean_divisor(16) == 16 * C.NSAMP_DF
    assert P.mean_divisor(16) == 2 * P.stokes_mean_divisor(16)


def test_stokes_slabs_cover_every_frame(monkeypatch):
    """Slabs smaller than the block (as at 8192 x 48) still add up."""
    monkeypatch.setattr(P, "_SLAB_ELEMS", 3 * 4 * P.LANES_PER_CHUNK)
    block = _block(32, 4, seed=4)
    want = baseband2stokes_scrunch_golden(block, 4)
    np.testing.assert_array_equal(
        P.baseband2stokes_scrunch_2d(_wire(block), 4).numpy(), want)
    np.testing.assert_array_equal(
        P.baseband2stokes_scrunch_rows(_rows(block), 4).numpy(), want)


# --- exact cases: extreme blocks and constructed polarisation states ------


def _pol_block(xr, xi, yr, yi):
    b = np.zeros(xr.shape + (2, 2), np.int16)
    b[..., 0, 0], b[..., 0, 1] = xr, xi
    b[..., 1, 0], b[..., 1, 1] = yr, yi
    return b


def _stokes_both_layouts(block):
    """Plain wire and rows Stokes of one block, each ``(4, nchan)``."""
    wire = P.baseband2stokes_2d(_wire(block)).numpy()
    rows = P.baseband2stokes_scrunch_rows(_rows(block))[0].numpy()
    np.testing.assert_array_equal(wire, rows)
    return wire


def test_stokes_all_min_block_exact():
    """All -32768: per sample I = 2^32, Q = V = 0, U = I; the int32
    overflow cases of every term, exact in int64."""
    block = np.full((16, 4, 128, 7, 2, 2), -32768, np.int16)
    s = _stokes_both_layouts(block)
    np.testing.assert_array_equal(s, baseband2stokes_golden(block))
    assert (s[0] == 16 * 128 * 2.0 ** 32).all()
    assert (s[1] == 0).all() and (s[3] == 0).all()
    np.testing.assert_array_equal(s[2], s[0])


def test_stokes_full_range_and_turned_block_exact():
    """Full-range int16, and y = i x (x turned by 90 degrees, xi kept off
    -32768 so -xi is an int16): V = -I, Q = U = 0 exactly."""
    rng = np.random.default_rng(20261016)
    shape = (16, 4, 128, 7)
    block = rng.integers(-32768, 32768, shape + (2, 2), dtype=np.int16)
    np.testing.assert_array_equal(_stokes_both_layouts(block),
                                  baseband2stokes_golden(block))
    xr = block[..., 0, 0]
    xi = np.maximum(block[..., 0, 1], -32767)
    s = _stokes_both_layouts(_pol_block(xr, xi, -xi, xr))
    assert (s[1] == 0).all() and (s[2] == 0).all()
    np.testing.assert_array_equal(s[3], -s[0])


@pytest.mark.parametrize("state", ["linear_y_eq_x", "circular_y_eq_ix",
                                   "horizontal_y_0"])
def test_stokes_polarisation_states_exact(state):
    """The states of tests/test_stokes.py, exactly (no tolerance)."""
    rng = np.random.default_rng(3)
    shape = (16, 8, C.NSAMP_DF, C.NCHAN_CHK)
    xr = rng.integers(-100, 100, size=shape).astype(np.int16)
    xi = rng.integers(-100, 100, size=shape).astype(np.int16)
    zero = np.zeros_like(xr)
    yr, yi = {"linear_y_eq_x": (xr, xi), "circular_y_eq_ix": (-xi, xr),
              "horizontal_y_0": (zero, zero)}[state]
    block = _pol_block(xr, xi, yr, yi)
    s = _stokes_both_layouts(block)
    np.testing.assert_array_equal(s, baseband2stokes_golden(block))
    i, q, u, v = s
    if state == "linear_y_eq_x":
        assert (q == 0).all() and (v == 0).all()
        np.testing.assert_array_equal(u, i)
    elif state == "circular_y_eq_ix":
        assert (q == 0).all() and (u == 0).all()
        np.testing.assert_array_equal(v, -i)
    else:
        assert (u == 0).all() and (v == 0).all()
        np.testing.assert_array_equal(q, i)


# --- plain versions vs the JAX XLA functions ------------------------------


@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("nchk", [48, 4])
@pytest.mark.parametrize("fn", ["2d", "scrunch_2d"])
def test_stokes_matches_jax_xla(fn, nchk, mean):
    ndf, nout = 64, 4
    block = _block(ndf, nchk, seed=21)
    x = jnp.asarray(block.reshape(ndf, -1))
    if fn == "2d":
        got = P.baseband2stokes_2d(_wire(block), mean=mean)
        want = JP.baseband2stokes_2d(x, mean=mean)
    else:
        got = P.baseband2stokes_scrunch_2d(_wire(block), nout, mean=mean)
        want = JP.baseband2stokes_scrunch_2d(x, nout, mean=mean)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert_close(got.numpy(), want)


# --- the CUDA wrappers' CPU path vs the Pallas kernels (interpret mode) ---


@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("nchk", [8, 4])
def test_matches_pallas_k5_stokes(nchk, mean):
    block = _block(32, nchk, seed=31)
    want = np.asarray(PP.baseband2stokes_pallas(
        jnp.asarray(PP.pack_block_2d(block)), mean=mean, interpret=True))
    got = CP.baseband2stokes_cuda(_wire(block), mean=mean)
    assert got.shape == want.shape == (4, nchk * 7)
    assert_close(got.numpy(), want)


@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("nout", [2, 4])
def test_matches_pallas_k6_stokes_scrunch(nout, mean):
    block = _block(32, 4, seed=32)
    want = np.asarray(PP.baseband2stokes_scrunch_pallas(
        jnp.asarray(PP.pack_block_2d(block)), nout, mean=mean,
        interpret=True))
    got = CP.baseband2stokes_scrunch_cuda(_wire(block), nout, mean=mean)
    assert got.shape == want.shape == (nout, 4, 28)
    assert_close(got.numpy(), want)


# At ndf=32, nout=1 takes the accumulating tile (K8, _make_stokes_rows_kernel)
# and nout=4 the packed whole-window tile (K7,
# _make_stokes_rows_packed_kernel).
@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("nchk", [8, 4])
@pytest.mark.parametrize("nout", [1, 4], ids=["K8", "K7"])
def test_matches_pallas_k7_k8_stokes_rows(nout, nchk, mean):
    block = _block(32, nchk, seed=33)
    rows = F.block_to_rows(block)
    want = np.asarray(PP.baseband2stokes_scrunch_rows_pallas(
        jnp.asarray(rows), nout, mean=mean, interpret=True))
    got = CP.baseband2stokes_scrunch_rows_cuda(torch.from_numpy(rows), nout,
                                               mean=mean)
    assert got.shape == want.shape == (nout, 4, nchk * 7)
    assert_close(got.numpy(), want)


# --- shape errors, as in JAX ------------------------------------------------


@pytest.mark.parametrize("case", ["lanes", "nout", "rows_nout"])
def test_stokes_shape_errors_match_jax(case):
    shape, nout = {"lanes": ((16, 100), 1),
                   "nout": ((12, P.LANES_PER_CHUNK), 5),
                   "rows_nout": ((14, 12, 256), 5)}[case]
    x = np.zeros(shape, np.int16)
    t = torch.from_numpy(x)
    if case == "rows_nout":
        calls = [lambda: P.baseband2stokes_scrunch_rows(t, nout),
                 lambda: CP.baseband2stokes_scrunch_rows_cuda(t, nout)]
    else:
        calls = [
            lambda: JP.baseband2stokes_scrunch_2d(jnp.asarray(x), nout),
            lambda: P.baseband2stokes_scrunch_2d(t, nout),
            lambda: CP.baseband2stokes_scrunch_cuda(t, nout)]
        if case == "lanes":
            calls += [lambda: JP.baseband2stokes_2d(jnp.asarray(x)),
                      lambda: P.baseband2stokes_2d(t),
                      lambda: CP.baseband2stokes_cuda(t)]
    for call in calls:
        with pytest.raises(ValueError):
            call()


# --- the CUDA bindings on CPU tensors ----------------------------------------


STOKES_WRAPPERS = {
    "baseband2stokes_cuda": (
        lambda x: CP.baseband2stokes_cuda(x, mean=True),
        lambda x: P.baseband2stokes_2d(x, mean=True)),
    "baseband2stokes_scrunch_cuda": (
        lambda x: CP.baseband2stokes_scrunch_cuda(x, 4),
        lambda x: P.baseband2stokes_scrunch_2d(x, 4)),
    "baseband2stokes_scrunch_rows_cuda": (
        lambda x: CP.baseband2stokes_scrunch_rows_cuda(
            x.reshape(4 * 14, 32, 256), 2),
        lambda x: P.baseband2stokes_scrunch_rows(
            x.reshape(4 * 14, 32, 256), 2)),
}


@pytest.mark.parametrize("name", sorted(STOKES_WRAPPERS))
def test_stokes_wrappers_take_plain_path_on_cpu(name):
    """A CPU tensor runs the plain version and launches nothing."""
    wrapper, plain = STOKES_WRAPPERS[name]
    x = _wire(_block(32, 4, seed=41))
    before = sum(CP.launches.values())
    assert torch.equal(wrapper(x), plain(x))
    assert sum(CP.launches.values()) == before


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("name", sorted(STOKES_WRAPPERS))
def test_stokes_wrappers_reject_non_int16(name, dtype):
    wrapper, _ = STOKES_WRAPPERS[name]
    x = torch.zeros((32, 4 * P.LANES_PER_CHUNK), dtype=dtype)
    with pytest.raises(TypeError, match="int16"):
        wrapper(x)


@pytest.mark.parametrize("name", sorted(STOKES_WRAPPERS))
def test_stokes_cuda_tensor_without_cuda_raises(name, monkeypatch, tmp_path):
    """On a host without CUDA a CUDA tensor goes to the kernel, whose build
    fails: the wrapper raises and does not fall back to the plain path."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the kernel would run")
    from torch._subclasses.fake_tensor import FakeTensorMode

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    wrapper, _ = STOKES_WRAPPERS[name]
    before = sum(CP.launches.values())
    with FakeTensorMode():
        x = torch.empty((32, 4 * P.LANES_PER_CHUNK), dtype=torch.int16,
                        device="cuda")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            wrapper(x)
    assert sum(CP.launches.values()) == before


@pytest.mark.parametrize("name", sorted(STOKES_WRAPPERS))
def test_stokes_wrappers_reject_other_devices(name):
    """Neither CPU nor CUDA: raise, never fall back."""
    wrapper, _ = STOKES_WRAPPERS[name]
    x = torch.empty((32, 4 * P.LANES_PER_CHUNK), dtype=torch.int16,
                    device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        wrapper(x)
