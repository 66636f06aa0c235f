"""The port's PFB spectrometer on the CPU (``ops/pfb.py`` and the CPU path
of ``ops/cuda_pfb.py``) against the JAX package: its float64 golden
(``pfb_spectra_golden``, ``pfb_power_golden``) to 1e-10 in float64 and to
2e-5 in float32, peak-normalized (``BOUND_PFB`` of
``benchmarks/parity_tpu.py``); its XLA ``pfb_spectra``/``pfb_power`` and its
fused Pallas kernel (interpret mode) within ``tests/test_spectra.py``'s
``assert_close`` (both accumulate in float32, the kernel through bf16x3);
its carries, which continue the port's stream exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paf_baseband2power_tpu import constants as C
from paf_baseband2power_tpu.ops import frame as F
from paf_baseband2power_tpu.ops import pfb as J
from paf_baseband2power_tpu.ops.pallas_pfb import pfb_spectra_fused
from paf_baseband2power_tpu_torch.ops import _build
from paf_baseband2power_tpu_torch.ops import cuda_pfb as CF
from paf_baseband2power_tpu_torch.ops import cuda_power as CP
from paf_baseband2power_tpu_torch.ops import pfb as P

NDF, NCHK = 16, 2
BOUND_PFB = 2e-5


def _err(got, want) -> float:
    """Peak-normalized max error (``benchmarks/parity_tpu.py:_err``)."""
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


def assert_close(got, want, rtol=2e-4):
    """``tests/test_spectra.py``'s scale-aware parity: Q, U and V of noise
    sit near zero, so the error is bounded by the detection scale."""
    atol = 1e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _block(rng, ndf=NDF, nchk=NCHK):
    return F.synthetic_block(rng=rng, ndf=ndf, nchk=nchk)


def _wire(block):
    return torch.from_numpy(block.reshape(block.shape[0], -1))


def _rows(block):
    return torch.from_numpy(F.block_to_rows(block))


@pytest.mark.parametrize("ntap", range(1, 9))
@pytest.mark.parametrize("window", ["hamming", "hanning", "rect"])
def test_coeffs_bit_equal_jax(window, ntap):
    for nfft in [2 ** i for i in range(1, 11)] + [3, 100]:
        for dtype in (np.float32, np.float64):
            np.testing.assert_array_equal(
                P.pfb_coeffs(nfft, ntap, window, dtype),
                J.pfb_coeffs(nfft, ntap, window, dtype))


CASES = [  # nfft, ntap, nout, stokes, mean, window
    (32, 4, 1, False, False, "hamming"),
    (32, 4, 4, True, True, "hanning"),
    (64, 2, 2, False, True, "rect"),
    (128, 3, 2, True, False, "hamming"),
    (256, 8, 1, False, True, "hanning"),
    (16, 1, 8, True, True, "rect"),
]


@pytest.mark.parametrize("layout", ["wire", "rows"])
@pytest.mark.parametrize("nfft,ntap,nout,stokes,mean,window", CASES)
def test_float64_matches_golden(nfft, ntap, nout, stokes, mean, window,
                                layout):
    block = _block(30)
    x = _wire(block) if layout == "wire" else _rows(block)
    got = P.pfb_spectra(x, nfft, ntap, window=window, nout=nout,
                        stokes=stokes, mean=mean, layout=layout,
                        dtype=torch.float64)
    want = J.pfb_spectra_golden(block, nfft, ntap, window=window, nout=nout,
                                stokes=stokes, mean=mean)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _err(got, want) < 1e-10


@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("window", ["hamming", "rect"])
def test_pfb_power_float64_matches_golden(window, mean):
    block = _block(31)
    got = P.pfb_power(_wire(block), 64, 4, window=window, mean=mean,
                      dtype=torch.float64)
    want = J.pfb_power_golden(block, 64, 4, window=window, mean=mean)
    assert got.shape == want.shape == (NCHK * C.NCHAN_CHK * 64,)
    assert _err(got, want) < 1e-10


@pytest.mark.parametrize("shift", [True, False])
@pytest.mark.parametrize("nfft,ntap,nout,stokes,mean,window", CASES)
def test_float32_matches_golden_and_jax_xla(nfft, ntap, nout, stokes, mean,
                                            window, shift):
    block = _block(32)
    got = P.pfb_spectra(_wire(block), nfft, ntap, window=window, nout=nout,
                        stokes=stokes, mean=mean, shift=shift).numpy()
    want = J.pfb_spectra_golden(block, nfft, ntap, window=window, nout=nout,
                                stokes=stokes, mean=mean, shift=shift)
    assert _err(got, want) < BOUND_PFB
    xla = np.asarray(J.pfb_spectra(jnp.asarray(block), nfft, ntap,
                                   window=window, nout=nout, stokes=stokes,
                                   mean=mean, shift=shift))
    assert_close(got, xla)


@pytest.mark.parametrize("mean,shift", [(False, True), (True, False)])
def test_pfb_power_float32_matches_jax_xla(mean, shift):
    block = _block(33)
    got = CF.pfb_power_cuda(_wire(block), 32, 4, mean=mean, shift=shift)
    assert _err(got, J.pfb_power_golden(block, 32, 4, mean=mean,
                                        shift=shift)) < BOUND_PFB
    assert_close(got.numpy(), np.asarray(
        J.pfb_power(jnp.asarray(block), 32, 4, mean=mean, shift=shift)))


@pytest.mark.parametrize("layout", ["wire", "rows"])
@pytest.mark.parametrize("nfft,ndf,nout,stokes", [(128, 16, 1, False),
                                                  (128, 32, 2, True),
                                                  (256, 16, 1, True),
                                                  (256, 32, 2, False)])
def test_matches_pallas_k10_interpret(nfft, ndf, nout, stokes, layout):
    """K10 (``pfb_spectra_fused``) on the CPU, wire and rows, one-shot and
    continuing a carry of its own."""
    b1, b2 = _block(40, ndf, 1), _block(41, ndf, 1)
    if layout == "wire":
        x1, x2 = jnp.asarray(b1), jnp.asarray(b2)
        t1, t2 = _wire(b1), _wire(b2)
    else:
        x1, x2 = jnp.asarray(F.block_to_rows(b1)), jnp.asarray(
            F.block_to_rows(b2))
        t1, t2 = _rows(b1), _rows(b2)
    kw = dict(nout=nout, stokes=stokes, mean=True)
    k1, h1 = pfb_spectra_fused(x1, nfft, 4, return_history=True,
                               layout=layout, interpret=True, **kw)
    k2 = pfb_spectra_fused(x2, nfft, 4, history=h1, layout=layout,
                           interpret=True, **kw)
    g1, c1 = CF.pfb_spectra_cuda(t1, nfft, 4, return_history=True,
                                 layout=layout, **kw)
    g2 = CF.pfb_spectra_cuda(t2, nfft, 4, history=c1, layout=layout, **kw)
    assert_close(g1.numpy(), np.asarray(k1))
    assert_close(g2.numpy(), np.asarray(k2))


def test_pfb_power_matches_pallas_k9_interpret():
    """K9 (``pfb_power_fused``), the nfft = 128 power kernel."""
    from paf_baseband2power_tpu.ops.pallas_pfb import pfb_power_fused

    block = _block(42, 16, 1)
    want = pfb_power_fused(jnp.asarray(block), 128, 4, mean=True,
                           interpret=True)
    got = CF.pfb_power_cuda(_wire(block), 128, 4, mean=True)
    assert_close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("nfft,k0", [(32, 5), (128, 77), (1024, 137)])
def test_tone_lands_in_its_fine_channel(nfft, k0):
    ndf = max(16, 2 * nfft // C.NSAMP_DF)
    n = np.arange(ndf * C.NSAMP_DF)
    tone = 100.0 * np.exp(2j * np.pi * k0 * n / nfft)
    block = np.zeros((ndf, 1, C.NSAMP_DF, C.NCHAN_CHK, 2, 2), np.int16)
    block[:, 0, :, 3, 1, 0] = np.round(tone.real).reshape(ndf, -1)
    block[:, 0, :, 3, 1, 1] = np.round(tone.imag).reshape(ndf, -1)
    out = P.pfb_power(_wire(block), nfft, 2).numpy().reshape(C.NCHAN_CHK,
                                                              nfft)
    hot = out[3]
    assert int(hot.argmax()) == (k0 + nfft // 2) % nfft
    assert out.sum() - hot.sum() < 1e-5 * hot.sum()


@pytest.mark.parametrize("layout", ["wire", "rows"])
@pytest.mark.parametrize("nfft,ntap,nout,stokes", [(32, 4, 2, False),
                                                   (64, 8, 1, True),
                                                   (128, 3, 4, True),
                                                   (16, 1, 2, False)])
def test_two_blocks_with_carry_match_one_shot(nfft, ntap, nout, stokes,
                                              layout):
    """Streaming over two blocks == the golden over their concatenation,
    spectrum by spectrum (the end-row grouping puts the carry's boundary
    windows into each block's spectrum 0)."""
    b1, b2 = _block(50), _block(51)
    step = P.make_streaming_spectra(nfft, ntap, nout=nout, stokes=stokes,
                                    layout=layout, dtype=torch.float64,
                                    mean=True)
    conv = _wire if layout == "wire" else _rows
    o1, h1 = step(conv(b1), None)
    o2, h2 = step(conv(b2), h1)
    want = J.pfb_spectra_golden(np.concatenate([b1, b2]), nfft, ntap,
                                nout=2 * nout, stokes=stokes)
    # golden means over a 2-block stream differ only in spectrum 0 of block
    # 2 (it has its boundary windows); compare sums instead
    s1 = P.pfb_spectra(conv(b1), nfft, ntap, nout=nout, stokes=stokes,
                       layout=layout, dtype=torch.float64)
    s2 = P.pfb_spectra(conv(b2), nfft, ntap, nout=nout, stokes=stokes,
                       layout=layout, history=h1, dtype=torch.float64)
    assert _err(torch.cat([s1, s2]), want) < 1e-10
    wpg = NDF * C.NSAMP_DF // nfft // nout
    div = torch.tensor(P.mean_divisors(nout, wpg, ntap, stokes, True),
                       dtype=torch.float64)
    shape = (-1,) + (1,) * (s2.ndim - 1)
    assert _err(o2, s2.double() / div.reshape(shape)) < 1e-7
    assert o1.shape == o2.shape == want[:nout].shape
    assert torch.equal(h2, P.pfb_history(conv(b2), nfft, ntap, layout))


def _jax_carries(block, nfft, ntap):
    """The JAX package's two carry formats after ``block``: complex from
    the XLA step, int16 rows from the fused kernel (interpret mode)."""
    step = J.make_streaming_spectra(nfft, ntap, nout=1)
    _, complex_h = step(jnp.asarray(block), None)
    _, rows_h = pfb_spectra_fused(jnp.asarray(block), nfft, ntap,
                                  return_history=True, interpret=True)
    return {"complex": np.asarray(complex_h), "rows": np.asarray(rows_h)}


@pytest.mark.parametrize("fmt", ["complex", "rows"])
@pytest.mark.parametrize("nfft,ntap", [(128, 4), (256, 2)])
def test_jax_carry_continues_port_stream_exactly(nfft, ntap, fmt):
    b1, b2 = _block(60, 16, 1), _block(61, 16, 1)
    own = P.pfb_history(_wire(b1), nfft, ntap)
    jax_h = _jax_carries(b1, nfft, ntap)[fmt]
    assert torch.equal(P.history_from_jax(jax_h, ntap, nfft), own)
    assert torch.equal(P.history_as_complex(own, ntap, nfft),
                       torch.from_numpy(np.asarray(
                           J.history_as_complex(jnp.asarray(jax_h), ntap,
                                                nfft))))
    step = P.make_streaming_spectra(nfft, ntap, nout=2, stokes=True)
    want, _ = step(_wire(b2), own)
    got, _ = step(_wire(b2), jax_h)
    assert torch.equal(got, want)
    # and the other way: the port's carry continues the JAX XLA step
    xla = J.pfb_spectra(jnp.asarray(b2), nfft, ntap, nout=2, stokes=True,
                        history=jnp.asarray(
                            P.history_as_complex(own, ntap, nfft).numpy()))
    assert_close(got.numpy(), np.asarray(xla))


def test_history_is_never_a_view_of_the_block():
    block = _wire(_block(62, 4, 1))
    h = P.pfb_history(block, 128, 5)            # the whole 4-frame block
    assert h.shape == (14, 512, 2)
    assert h.untyped_storage().data_ptr() != \
        block.untyped_storage().data_ptr()
    assert P.pfb_history(block, 128, 1).shape == (14, 0, 2)


@pytest.mark.parametrize("case", ["nout", "wpg", "window", "nfft",
                                  "layout", "carry"])
def test_validation_errors_mirror_golden(case):
    block = _block(63)
    x = _wire(block)
    calls = {
        "nout": (lambda: J.pfb_spectra_golden(block, 32, 4, nout=3),
                 lambda: P.pfb_spectra(x, 32, 4, nout=3), "must divide"),
        "wpg": (lambda: J.pfb_spectra_golden(block, 32, 4, nout=32),
                lambda: P.pfb_spectra(x, 32, 4, nout=32), "ntap-1=3"),
        "window": (lambda: J.pfb_coeffs(32, 4, "kaiser"),
                   lambda: P.pfb_spectra(x, 32, 4, window="kaiser"),
                   "unknown window"),
        "nfft": (None, lambda: P.pfb_spectra(x, 3000, 1), "must divide"),
        "layout": (None, lambda: P.pfb_spectra(x, 32, layout="planes"),
                   "unknown layout"),
        "carry": (None, lambda: P.pfb_spectra(
            x, 32, 4, history=torch.zeros((28, 95, 2), dtype=torch.int16)),
            "does not hold"),
    }
    golden, port, match = calls[case]
    if golden is not None:
        with pytest.raises(ValueError, match=match):
            golden()
    with pytest.raises(ValueError, match=match):
        port()


def test_rows_nfft_set_and_message_match_jax():
    from paf_baseband2power_tpu.runtime.pipeline import PowerPipeline

    for nfft in P.ROWS_NFFTS:
        P.check_rows_nfft(nfft)
    for nfft in (64, 192, 2048):
        with pytest.raises(ValueError) as want:
            PowerPipeline(device_layout=True, pfb_nfft=nfft)
        with pytest.raises(ValueError) as got:
            P.check_rows_nfft(nfft)
        assert str(got.value) == str(want.value)


WRAPPERS = {
    "pfb_spectra_cuda": lambda x, **kw: CF.pfb_spectra_cuda(
        x, 32, 4, nout=2, stokes=True, **kw),
    "pfb_power_cuda": lambda x, **kw: CF.pfb_power_cuda(x, 32, 4, **kw),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrappers_take_plain_path_on_cpu(name):
    block = _wire(_block(64))
    before = sum(CP.launches.values())
    got, carry = WRAPPERS[name](block, mean=True, return_history=True)
    plain = (P.pfb_spectra(block, 32, 4, nout=2, stokes=True, mean=True)
             if name == "pfb_spectra_cuda"
             else P.pfb_power(block, 32, 4, mean=True))
    assert torch.equal(got, plain)
    assert torch.equal(carry, P.pfb_history(block, 32, 4))
    assert sum(CP.launches.values()) == before


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrappers_reject_other_devices(name):
    x = torch.empty((NDF, NCHK * 3584), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        WRAPPERS[name](x)


def _fake_cuda_block(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    return torch.empty((NDF, NCHK * 3584), dtype=torch.int16, device="cuda")


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_cuda_tensor_without_cuda_raises(name, monkeypatch, tmp_path):
    """A CUDA tensor goes to the kernel, whose build fails here: the
    wrapper raises and does not fall back to the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the kernel would run")
    from torch._subclasses.fake_tensor import FakeTensorMode

    before = sum(CP.launches.values())
    with FakeTensorMode():
        x = _fake_cuda_block(monkeypatch, tmp_path)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            WRAPPERS[name](x)
    assert sum(CP.launches.values()) == before


@pytest.mark.parametrize("nfft,ntap", [(96, 4), (2048, 2), (32, 9)])
def test_kernel_shape_limits_raise_on_cuda(nfft, ntap, monkeypatch,
                                           tmp_path):
    """A non-power-of-two nfft (or one past 1024, or ntap > 8) on a CUDA
    tensor raises naming what the kernel takes; the plain version still
    takes it on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from torch._subclasses.fake_tensor import FakeTensorMode

    ndf = 2 * nfft * ntap // C.NSAMP_DF + 32
    ndf -= ndf % 8
    if (ndf * C.NSAMP_DF) % nfft:
        ndf = 3 * 32          # 12288 samples: a multiple of 96
    with FakeTensorMode():
        monkeypatch.setattr(_build, "_lib", None)
        x = torch.empty((ndf, 3584), dtype=torch.int16, device="cuda")
        with pytest.raises(ValueError, match="CUDA PFB kernel takes"):
            CF.pfb_spectra_cuda(x, nfft, ntap)
    cpu = _wire(_block(65, ndf, 1))
    assert P.pfb_spectra(cpu, nfft, ntap).shape == (1, C.NCHAN_CHK * nfft)


@pytest.mark.parametrize("nfft", [32, 64])
def test_rows_kernel_takes_rows_nffts_only(nfft, monkeypatch):
    """Series rows go through the kernel at nfft 128-1024 only (the JAX
    package's rows rule): a smaller nfft on a CUDA tensor raises with its
    message; the plain version still takes it on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        monkeypatch.setattr(_build, "_lib", None)
        x = torch.empty((14, 32, 256), dtype=torch.int16, device="cuda")
        with pytest.raises(ValueError, match="device-layout PFB supports"):
            CF.pfb_spectra_cuda(x, nfft, 4, layout="rows")
    rows = _rows(_block(67, 32, 1))
    assert CF.pfb_spectra_cuda(rows, nfft, 4, layout="rows").shape == (
        1, C.NCHAN_CHK * nfft)


ROUTE_TORCH = {(2048, 4): "nfft 2048 is outside the CUDA kernel's 2..1024",
               (96, 4): "nfft 96 is not a power of two",
               (128, 12): "ntap 12 is outside the CUDA kernel's 1..8"}


def test_kernel_takes_matches_the_kernel_shape_check():
    for nfft in list(range(1, 1100)) + [2048, 4096]:
        for ntap in range(0, 14):
            takes = nfft in CF.CUDA_NFFTS and 1 <= ntap <= CF.CUDA_MAX_NTAP
            assert CF.kernel_takes(nfft, ntap) == takes
            if takes:
                CF._check_kernel_shape(nfft, ntap)
            else:
                with pytest.raises(ValueError, match="CUDA PFB kernel takes"):
                    CF._check_kernel_shape(nfft, ntap)
    for (nfft, ntap), why in ROUTE_TORCH.items():
        assert CF.kernel_refuses(nfft, ntap) == why


@pytest.mark.parametrize("nout,stokes", [(1, False), (2, False), (1, True)])
def test_pipeline_routes_pfb_by_shape_on_cuda(nout, stokes, monkeypatch):
    """For a CUDA device the executor sends every (nfft, ntap) the kernel
    takes to its CUDA wrapper, and nfft 2048, 96 and ntap 12 to the
    torch.fft route, chosen by shape alone and named in its description."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from torch._subclasses.fake_tensor import FakeTensorMode

    from paf_baseband2power_tpu_torch.runtime.pipeline import PowerPipeline

    called = []
    for name in ("pfb_power_cuda", "pfb_spectra_cuda", "pfb_power_torch",
                 "pfb_spectra_torch"):
        monkeypatch.setattr(CF, name, lambda x, *a, _n=name, **kw: (
            called.append((_n, a[:2])), (x, None))[1])
    fn = "power" if nout == 1 and not stokes else "spectra"
    shapes = [(n, t) for n in CF.CUDA_NFFTS
              for t in range(1, CF.CUDA_MAX_NTAP + 1)] + list(ROUTE_TORCH)
    with FakeTensorMode():
        x = torch.empty((NDF, NCHK * 3584), dtype=torch.int16, device="cuda")
        for nfft, ntap in shapes:
            called.clear()
            pipe = PowerPipeline("cuda", nout=nout, stokes=stokes,
                                 pfb_nfft=nfft, pfb_ntap=ntap)
            assert pipe.power(x) is x
            takes = CF.kernel_takes(nfft, ntap)
            route = "cuda" if takes else "torch"
            assert called == [(f"pfb_{fn}_{route}", (nfft, ntap))]
            assert pipe._mode().endswith(
                "(CUDA kernel)" if takes
                else f"(torch.fft: {ROUTE_TORCH[nfft, ntap]})")


@pytest.mark.parametrize("fn", ["pfb_power", "pfb_spectra"])
def test_torch_route_counts_runs_on_cuda(fn, monkeypatch):
    """The torch.fft route runs the plain version on the tensor's own
    device; a CUDA tensor counts one ``pfb_torch``, a CPU tensor none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from torch._subclasses.fake_tensor import FakeTensorMode

    seen = []
    monkeypatch.setattr(CF.PF, fn, lambda x, nfft, ntap, **kw: (
        seen.append((x.device.type, nfft, ntap, kw)), x)[1])
    route = getattr(CF, f"{fn}_torch")
    before = CP.launches["pfb_torch"]
    with FakeTensorMode():
        x = torch.empty((64, 3584), dtype=torch.int16, device="cuda")
        assert route(x, 2048, 4, mean=True) is x
    assert CP.launches["pfb_torch"] == before + 1
    cpu = _wire(_block(66, 64, 1))
    assert route(cpu, 128, 12) is cpu
    assert CP.launches["pfb_torch"] == before + 1
    assert seen == [("cuda", 2048, 4, {"mean": True}), ("cpu", 128, 12, {})]


def test_kernel_coeffs_and_partials_are_cached():
    """Repeated calls reuse the coefficients on the card and the partials
    buffer while their key and shape hold."""
    dev = torch.device("cpu")     # the caches are keyed by device only
    a = CF._device_coeffs(128, 4, "hamming", dev)
    assert CF._device_coeffs(128, 4, "hamming", dev) is a
    assert CF._device_coeffs(128, 4, "rect", dev) is not a
    np.testing.assert_array_equal(a.numpy(), P.pfb_coeffs(128, 4))
    p = CF._device_partials((2, 3, 1, 8), dev)
    assert CF._device_partials((2, 3, 1, 8), dev) is p
    q = CF._device_partials((2, 3, 4, 8), dev)
    assert q is not p and q.dtype == torch.float64


def _brev(x: int, bits: int) -> int:
    return int(format(x, f"0{bits}b")[::-1], 2) if bits else 0


def _warp_fft_model(x):
    """numpy model of one FFT of ``csrc/pfb.cu:pfb_kernel``: lane p of P =
    min(nfft, 32) holds points p + P j, j < m = nfft / P; an m-point
    radix-2 DIF in its registers (bit-reversed out), the twiddles
    W_nfft^(p k1), a P-point DIF across lanes whose stage h pairs lanes
    p and p ^ h. Returns the FFT as the kernel writes it (position i P + p
    holds lane p's register i) and the bin of each position."""
    nfft = x.shape[-1]
    P = min(nfft, 32)
    m = nfft // P
    lp, lm = P.bit_length() - 1, m.bit_length() - 1
    a = x.reshape(m, P).T.astype(np.complex128)          # a[p, j]
    for s in range(lm):
        half = m >> (s + 1)
        for b in range(0, m, 2 * half):
            for i in range(half):
                u, v = a[:, b + i].copy(), a[:, b + i + half].copy()
                a[:, b + i] = u + v
                a[:, b + i + half] = (u - v) * np.exp(-2j * np.pi * (i << s)
                                                      / m)
    k1 = np.array([_brev(i, lm) for i in range(m)])
    lanes = np.arange(P)
    a *= np.exp(-2j * np.pi * np.outer(lanes, k1) / nfft)
    h = P // 2
    while h >= 1:
        other = a[lanes ^ h]
        low = (lanes & h) != 0
        w = np.exp(-2j * np.pi * (lanes & (h - 1)) / (2 * h))
        a = np.where(low[:, None], (other - a) * w[:, None], a + other)
        h //= 2
    written = a.T.reshape(-1)                            # position i P + p
    bins = np.array([_brev(pos // P, lm) + m * _brev(pos % P, lp)
                     for pos in range(nfft)])
    return written, bins


@pytest.mark.parametrize("nfft", CF.CUDA_NFFTS)
def test_warp_fft_index_map_matches_numpy_fft(nfft):
    """The kernel's register/lane decomposition, and the bin it assigns to
    each written position, give ``np.fft.fft``."""
    rng = np.random.default_rng(nfft)
    x = rng.standard_normal(nfft) + 1j * rng.standard_normal(nfft)
    written, bins = _warp_fft_model(x)
    assert sorted(bins) == list(range(nfft))
    want = np.fft.fft(x)
    np.testing.assert_allclose(written, want[bins], rtol=0,
                               atol=1e-12 * np.abs(want).max())


def test_tile_slots_cover_whole_steps():
    for nfft in CF.CUDA_NFFTS:
        ts, w = CF.tile_slots(nfft), CF.step_windows(nfft)
        assert ts % w == 0 and ts * nfft >= 32 * 256
        # every warp (8) has one FFT (window, pol) per step, or 32 / nfft
        assert 2 * w % 8 == 0 and 2 * w * nfft % (8 * 32) == 0
