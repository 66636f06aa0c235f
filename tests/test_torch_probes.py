"""The port's spectrometer probes (``paf_baseband2power_tpu_torch/probes``)
on the CPU, held against the JAX probes' Pallas kernels run in interpret
mode (``benchmarks/probe_wide_reshape.py``, ``probe_karatsuba.py``, loaded
from their files and left as they are):

* K11, ``micro``: the plain version equals JAX ``micro`` exactly (integer
  sums below 2^24 are exact in float32), both ``widen`` values, 1 tile and
  4 tiles.
* K12, ``planes``: within 2e-5, peak-normalized, of ``planes_call`` for
  every ``stage_a`` that applies (the JAX side splits its float32 products
  into three bf16 passes, about 3e-6 here), and of the float64 golden
  ``pfb_power_golden(shift=False)`` for ``full``.
* K13, ``karatsuba_planar``: route 1 of two, the JAX kernel's own output.
  ``run_planar`` is a closure inside the JAX probe's ``main``, so the test
  wraps ``pl.pallas_call`` to run in interpret mode and hand its input and
  result out through ``jax.debug.callback`` while ``main(--check)`` runs,
  then feeds the port's plain version that same input: within 2e-5. The
  port is also held against the probe's numpy golden.

The planes and Karatsuba kernels run their 128-point DFTs on the tensor
cores in split precision (``csrc/tc_dft.cuh``). Their arithmetic is
emulated here (``_common.round_tf32``/``round_bf16``/``split_matmul``,
``planes_split``, ``karatsuba_planar_split``) and held within half the
bound of the float64 goldens at the check sizes, for the kernels' 3xBF16
and for 3xTF32; plain TF32, reported in each message, is over the bound.

The CUDA wrappers take the plain versions for CPU tensors; on a CUDA tensor
they build the kernel or raise. The kernels themselves run on the card only
(``chip_smoke.py``).
"""

import functools
import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from paf_baseband2power_tpu.ops import frame as JF
from paf_baseband2power_tpu.ops.pfb import pfb_power_golden
from paf_baseband2power_tpu_torch.ops import _build
from paf_baseband2power_tpu_torch.ops import cuda_power as CP
from paf_baseband2power_tpu_torch.probes import _common
from paf_baseband2power_tpu_torch.probes import karatsuba as K
from paf_baseband2power_tpu_torch.probes import wide_reshape as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUND = 2e-5      # peak-normalized, the JAX sweep's BOUND_PFB


def _load_probe(name):
    """A JAX probe module from ``benchmarks/``, by file path."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(REPO, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_wide():
    return _load_probe("probe_wide_reshape")


@pytest.fixture
def interpret(monkeypatch):
    """Every ``pl.pallas_call`` in interpret mode (the probes do not take
    ``interpret`` themselves)."""
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _err(got, want) -> float:
    """Peak-normalized error, by the probes' own ``peak_err``."""
    return _common.peak_err(got, want)[1]


def _rows(seed, nseries, ndf, lo=-256, hi=256):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, (nseries, ndf, 256)).astype(np.int16)


# --- K11: micro ----------------------------------------------------------


@pytest.mark.parametrize("ntiles", [1, 4])
@pytest.mark.parametrize("widen", [False, True])
@pytest.mark.parametrize("n1,R", [(2, 8), (8, 2)])
def test_micro_equals_jax_interpret(jax_wide, interpret, n1, R, widen,
                                    ntiles):
    nseries, ndf = 3, ntiles * R * n1
    rows = _rows(11, nseries, ndf)
    want = np.asarray(jax_wide.micro(nseries, ndf, n1, R, widen)(
        jax.numpy.asarray(rows)))
    got = W.micro_cuda(torch.from_numpy(rows), n1, R, widen)
    assert got.shape == want.shape == (nseries, 1, 256)
    np.testing.assert_array_equal(got.numpy(), want)
    # the last tile alone: with more tiles the full sums differ
    last = rows[:, -R * n1:].astype(np.int64).sum(axis=1)
    np.testing.assert_array_equal(got.numpy()[:, 0], last)
    if ntiles > 1:
        assert not np.array_equal(last, rows.astype(np.int64).sum(axis=1))


def test_micro_is_exact_at_full_int16_range():
    rows = _rows(12, 2, 64, -32768, 32768)
    got = W.micro(torch.from_numpy(rows), 8, 8)
    want = rows.astype(np.int64).sum(axis=1).astype(np.float32)
    np.testing.assert_array_equal(got.numpy()[:, 0], want)


@pytest.mark.parametrize("kw,match", [
    (dict(n1=2, R=5), "must divide"),
    (dict(n1=0, R=8), "must divide")])
def test_micro_rejects_tiles_that_do_not_divide(kw, match):
    with pytest.raises(ValueError, match=match):
        W.micro(torch.zeros((2, 64, 256), dtype=torch.int16), **kw)


# --- K12: planes ---------------------------------------------------------


PLANES_CASES = [(128, "full"), (128, "noswap"), (128, "none"),
                (256, "full"), (256, "noswap"), (256, "none"),
                (512, "noswap"), (1024, "full"), (1024, "fft8"),
                (1024, "noswap"), (1024, "none")]


@pytest.mark.parametrize("nfft,stage_a", PLANES_CASES)
def test_planes_matches_jax_interpret(jax_wide, interpret, nfft, stage_a):
    n1 = nfft // 128
    nseries, ndf = 6, 16 * n1
    rows = torch.from_numpy(_rows(20 + n1, nseries, ndf))
    xp = W.to_planes(rows, n1)
    R = 8
    want = np.asarray(jax_wide.planes_call(nseries, ndf // n1, nfft, 4, R,
                                           stage_a)(
        jax.numpy.asarray(xp.numpy())))
    got = W.planes_cuda(xp, nfft, 4, R, stage_a)
    assert got.shape == want.shape == (nseries, nfft)
    assert got.dtype == torch.float32
    assert _err(got, want) < BOUND


def test_planes_ablations_differ_from_full():
    """noswap differs from full once the stage-A twiddles are not +-1
    (n1 >= 4); none differs at any n1 > 1; fft8 is full."""
    xp = W.to_planes(torch.from_numpy(_rows(31, 2, 64)), 8)
    full = W.planes(xp, 1024, 4, 8, "full", dtype=torch.float64)
    assert _err(W.planes(xp, 1024, 4, 8, "fft8", dtype=torch.float64),
                full) < 1e-12
    for sa in ("noswap", "none"):
        assert _err(W.planes(xp, 1024, 4, 8, sa, dtype=torch.float64),
                    full) > 1e-2
    xp2 = W.to_planes(torch.from_numpy(_rows(32, 2, 32)), 2)
    assert _err(W.planes(xp2, 256, 4, 8, "noswap", dtype=torch.float64),
                W.planes(xp2, 256, 4, 8, "full", dtype=torch.float64)) < 1e-12


@pytest.mark.parametrize("nfft", [128, 256, 1024])
def test_planes_full_matches_golden(nfft):
    """Lanes put in order and pols folded, ``full`` is the one-shot PFB
    power spectrum, not fftshifted (the JAX probe's own parity check)."""
    n1 = nfft // 128
    blk = JF.synthetic_block(rng=7, ndf=64, nchk=2)
    rows = torch.from_numpy(JF.block_to_rows(blk))
    got = W.planes_cuda(W.to_planes(rows, n1), nfft, 4, 8)
    got = W.bins_in_order(got, nfft).reshape(14, 2, nfft).sum(dim=1)
    want = pfb_power_golden(blk, nfft, 4, shift=False).reshape(14, nfft)
    assert _err(got, want) < BOUND


@pytest.mark.parametrize("nfft", [256, 1024])
def test_planes_parity_entry_point(nfft):
    assert W.planes_parity(nfft, "full", torch.device("cpu")) < BOUND


@pytest.mark.parametrize("kw,match", [
    (dict(nfft=384), "planes take nfft"),
    (dict(nfft=256, stage_a="fft8"), "fft8"),
    (dict(nfft=256, stage_a="twiddle"), "stage_a must be"),
    (dict(nfft=256, R=5), "must divide"),
    (dict(nfft=1024), "are \\(nseries, 8")])
def test_planes_rejects_bad_shapes(kw, match):
    xp = torch.zeros((2, 2, 24, 256), dtype=torch.int16)
    with pytest.raises(ValueError, match=match):
        W.planes_cuda(xp, **kw)


def test_to_planes_and_bins_in_order():
    rows = torch.arange(2 * 8 * 256, dtype=torch.int16).reshape(2, 8, 256)
    xp = W.to_planes(rows, 4)
    assert xp.shape == (2, 4, 2, 256) and xp.is_contiguous()
    assert torch.equal(xp[1, 3, 1], rows[1, 1 * 4 + 3])
    lanes = torch.arange(512.0)        # lane k1 * 128 + k2 at nfft 512
    k = W.bins_in_order(lanes, 512)
    assert k[4 * 5 + 3] == 3 * 128 + 5     # bin n1 k2 + k1 <- lane k1, k2


# --- K13: Karatsuba --------------------------------------------------------


def test_karatsuba_matches_jax_kernel_output(monkeypatch, capsys):
    """Route 1: the JAX kernel's own input and output, captured while its
    probe's ``--check`` runs in interpret mode."""
    from jax.experimental import pallas as pl

    real = pl.pallas_call
    seen = []

    def spy(kernel, **kw):
        call = real(kernel, **dict(kw, interpret=True))

        def run(*args):
            out = call(*args)
            jax.debug.callback(
                lambda x, o: seen.append((np.array(x), np.array(o))),
                args[0], out)
            return out

        return run

    jax_kar = _load_probe("probe_karatsuba")
    monkeypatch.setattr(pl, "pallas_call", spy)
    monkeypatch.setattr(sys, "argv", ["probe_karatsuba.py", "--check"])
    jax_kar.main()
    jax.effects_barrier()
    check = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert check["check_err"] < BOUND
    assert len(seen) == 1
    rows, part = seen[0]
    np.testing.assert_array_equal(rows, K.check_rows())
    want = part.sum(axis=1)                    # (S, 8, 128) partials
    for dtype in (torch.float32, torch.float64):
        got = K.karatsuba_planar(torch.from_numpy(rows), R=rows.shape[1],
                                 dtype=dtype)
        assert got.shape == want.shape == (4, 128)
        assert _err(got, want) < BOUND


@pytest.mark.parametrize("R", [64, 32, 16])
def test_karatsuba_matches_numpy_golden(R):
    rows = K.check_rows()
    got = K.karatsuba_planar_cuda(torch.from_numpy(rows), R)
    assert _err(got, K.planar_golden(rows)) < BOUND


def test_karatsuba_planar_ops_match_jax_probe():
    cv, c1, c2, c3 = K.planar_ops()
    w = np.exp(-2j * np.pi * np.outer(np.arange(128), np.arange(128)) / 128)
    np.testing.assert_array_equal(c1, w.real.astype(np.float32))
    np.testing.assert_array_equal(c2, (w.real + w.imag).astype(np.float32))
    np.testing.assert_array_equal(c3, (w.real - w.imag).astype(np.float32))
    assert cv.shape == (4, 256)
    np.testing.assert_array_equal(cv[:, :128], cv[:, 128:])


def test_karatsuba_rejects_bad_shapes():
    with pytest.raises(ValueError, match="must divide"):
        K.karatsuba_planar_cuda(torch.zeros((1, 64, 256), dtype=torch.int16),
                                R=48)
    with pytest.raises(ValueError, match="planar rows"):
        K.karatsuba_planar_cuda(torch.zeros((1, 64, 128), dtype=torch.int16))


# --- the tensor-core DFT's split precision (csrc/tc_dft.cuh), emulated ------


def _f32(*bits):
    return np.array(bits, np.uint32).view(np.float32)


def test_round_tf32_is_cvt_rna():
    """10 stored mantissa bits, nearest, ties away from zero."""
    x = np.float32(1.0)
    ulp = 2.0 ** -10
    got = _common.round_tf32(np.array(
        [1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4, 1 + 3 * ulp / 4,
         1 + ulp + ulp / 2, x], np.float32))
    want = np.array([1 + ulp, -(1 + ulp), 1, 1 + ulp, 1 + 2 * ulp, 1],
                    np.float32)
    np.testing.assert_array_equal(got, want)
    r = _common.round_tf32(np.random.default_rng(0).standard_normal(
        1000).astype(np.float32))
    assert not (r.view(np.uint32) & np.uint32(0x1FFF)).any()


def test_round_bf16_is_round_to_nearest_even():
    ulp = 2.0 ** -7
    got = _common.round_bf16(np.array(
        [1 + ulp / 2, 1 + 3 * ulp / 2, -(1 + 3 * ulp / 2), 1 + ulp / 4],
        np.float32))
    want = np.array([1, 1 + 2 * ulp, -(1 + 2 * ulp), 1], np.float32)
    np.testing.assert_array_equal(got, want)
    assert _common.round_bf16(_f32(0x3F808000))[0] == 1.0     # tie, even


@pytest.mark.parametrize("split,rel", [("3xbf16", 1e-4), ("3xtf32", 1e-6),
                                       ("tf32", 2e-3)])
def test_split_matmul_is_near_the_float64_product(split, rel):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((16, 128)).astype(np.float32)
    m = rng.standard_normal((128, 8)).astype(np.float32)
    want = x.astype(np.float64) @ m.astype(np.float64)
    got = _common.split_matmul(x, m, split)
    assert np.abs(got - want).max() < rel * np.abs(want).max()


def test_dft_matrices_are_karatsubas():
    c1, c2, c3 = _common.dft_matrices()
    w = np.exp(-2j * np.pi * np.outer(np.arange(128), np.arange(128)) / 128)
    np.testing.assert_array_equal(c1, w.real.astype(np.float32))
    np.testing.assert_array_equal(c2, (w.real + w.imag).astype(np.float32))
    np.testing.assert_array_equal(c3, (w.real - w.imag).astype(np.float32))
    z = np.random.default_rng(2).standard_normal((3, 256))
    want = np.abs(np.fft.fft(z[:, :128] + 1j * z[:, 128:], axis=-1)) ** 2
    got = _common.split_dft_power(z[:, :128], z[:, 128:], c1, c2, c3,
                                  "3xtf32")
    assert _err(got, want) < 1e-6


KARATSUBA_INPUTS = {"check": K.check_rows,
                    "6 x 64": lambda: _rows(41, 6, 64),
                    "28 x 128": lambda: _rows(42, 28, 128)}


@pytest.mark.parametrize("split", [_common.KERNEL_SPLIT, "3xtf32"])
@pytest.mark.parametrize("name", sorted(KARATSUBA_INPUTS))
def test_karatsuba_split_plan_within_bound(name, split):
    """K13's arithmetic under the kernel's split, and under 3xTF32, against
    the float64 golden: the kernel's split with at least 2x margin. Plain
    TF32, reported in the message, is over the bound."""
    rows = KARATSUBA_INPUTS[name]()
    want = K.planar_golden(rows)
    err = _err(K.karatsuba_planar_split(torch.from_numpy(rows), split), want)
    tf32 = _err(K.karatsuba_planar_split(torch.from_numpy(rows), "tf32"),
                want)
    assert err < BOUND / 2, f"{split} {err:.3e} (plain TF32 {tf32:.3e})"
    assert tf32 > BOUND, f"plain TF32 {tf32:.3e} is inside the bound"


def _planes_golden_case(nfft):
    n1 = nfft // 128
    blk = JF.synthetic_block(rng=7, ndf=64, nchk=2)
    xp = W.to_planes(torch.from_numpy(JF.block_to_rows(blk)), n1)
    want = pfb_power_golden(blk, nfft, 4, shift=False).reshape(14, nfft)
    return xp, want


@pytest.mark.parametrize("split", [_common.KERNEL_SPLIT, "3xtf32"])
@pytest.mark.parametrize("nfft,stage_a", [(128, "full"), (256, "full"),
                                          (512, "full"), (1024, "full"),
                                          (1024, "fft8")])
def test_planes_split_plan_within_bound(nfft, stage_a, split):
    """K12's arithmetic (FIR, stage A, twiddle in float32; the 128-point
    DFT under the split) at every n1, lanes put in order and pols folded,
    against the float64 golden: the kernel's split with at least 2x
    margin. Plain TF32, reported in the message, is over the bound."""
    xp, want = _planes_golden_case(nfft)

    def folded(sp):
        got = torch.from_numpy(W.planes_split(xp, nfft, 4, stage_a, sp))
        return W.bins_in_order(got, nfft).reshape(14, 2, nfft).sum(dim=1)

    err, tf32 = _err(folded(split), want), _err(folded("tf32"), want)
    assert err < BOUND / 2, f"{split} {err:.3e} (plain TF32 {tf32:.3e})"
    assert tf32 > BOUND, f"plain TF32 {tf32:.3e} is inside the bound"


@pytest.mark.parametrize("stage_a", ["noswap", "none"])
def test_planes_split_keeps_the_ablations(stage_a):
    """The emulation computes the same function as the plain version for
    the ablations too (their numbers, not their correctness)."""
    xp = W.to_planes(torch.from_numpy(_rows(43, 3, 64)), 8)
    want = W.planes(xp, 1024, 4, 8, stage_a, dtype=torch.float64)
    got = W.planes_split(xp, 1024, 4, stage_a, _common.KERNEL_SPLIT)
    assert _err(got, want) < BOUND / 2


# --- wrappers and entry points ---------------------------------------------


WRAPPERS = {
    "micro_cuda": lambda x: W.micro_cuda(x, 2, 8),
    "planes_cuda": lambda x: W.planes_cuda(x.reshape(2, 2, 16, 256), 256),
    "karatsuba_planar_cuda": lambda x: K.karatsuba_planar_cuda(x, 32),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_probe_cuda_tensor_without_cuda_raises(name, monkeypatch, tmp_path):
    """A CUDA tensor goes to the kernel, whose build fails without nvcc:
    the wrapper raises and does not fall back to the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the kernel would run")
    from torch._subclasses.fake_tensor import FakeTensorMode

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    before = sum(CP.launches.values())
    with FakeTensorMode():
        x = torch.empty((2, 32, 256), dtype=torch.int16, device="cuda")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            WRAPPERS[name](x)
    assert sum(CP.launches.values()) == before


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_probe_wrappers_take_plain_version_on_cpu(name):
    before = sum(CP.launches.values())
    out = WRAPPERS[name](torch.from_numpy(_rows(3, 2, 32)))
    assert torch.isfinite(out).all()
    assert sum(CP.launches.values()) == before


@pytest.mark.parametrize("argv", [
    ["--nfft", "256", "--ndf", "64", "--nchk", "1", "--iters", "3"],
    ["--nfft", "1024", "--ndf", "128", "--nchk", "1", "--iters", "3"]])
def test_wide_reshape_main_on_cpu(argv, capsys):
    assert W.main(argv + ["--platform", "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    res = rep["results"]
    assert rep["device"] == {"platform": "cpu", "kind": "cpu"}
    assert {"production rows", "micro narrow", "micro widen"} <= set(res)
    labels = [k for k in res if k.startswith("planes R=")]
    assert [k.split("=")[-1] for k in labels] == list(W.STAGE_A)
    if argv[1] == "1024":
        assert all(isinstance(res[k], float) for k in labels)
        assert rep["parity_ok_fft8"] and rep["parity_err_fft8"] < BOUND
    else:
        assert res["planes R=32 stage_a=fft8"].startswith("ValueError")
        assert "parity_err_fft8" not in rep
    assert rep["parity_ok_full"] and rep["parity_err_full"] < BOUND


def test_karatsuba_main_on_cpu(monkeypatch, capsys):
    assert K.main(["--check", "--platform", "cpu"]) == 0
    check = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert check["check_err"] < BOUND
    monkeypatch.setattr(K, "NSERIES", 14)
    assert K.main(["--ndf", "2048", "--iters", "3", "--platform", "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rep["ms"]) == {"karatsuba R=1024", "karatsuba R=2048",
                              "interleaved production"}
    assert all(v > 0 for v in rep["ms"].values())


@pytest.mark.parametrize("costs", [
    [9.0, 10.0, 9.5, 17.0, 18.0, 17.5],    # 5 s + 1 s per call: slope 1 s
    [9.0, 9.5, 9.0, 8.0, 8.5, 8.0]])       # no positive slope: mean at n2
def test_slope_is_the_jax_probes_timing(jax_wide, costs):
    """``_common.slope`` gives what the JAX probe's ``_slope`` gives on the
    same readings (best of ``repeats`` at ``n1`` and at ``n2`` calls)."""
    def run_from(readings):
        it = iter(readings)
        return lambda n: next(it)

    got = _common.slope(run_from(costs), 4, 12, 3)
    assert got == jax_wide._slope(run_from(costs), 4, 12, 3)
    assert got == (1.0 if costs[0] < costs[3] else 8.0 / 12)


def test_peak_err_takes_tensors_and_arrays():
    want = np.array([[4.0, -8.0], [2.0, 1.0]])
    got = torch.tensor([[4.0, -8.0], [2.0, 1.5]], dtype=torch.float32)
    assert _common.peak_err(got, want) == (0.5, 0.5 / 8)
    assert _common.peak_err(want, torch.from_numpy(want)) == (0.0, 0.0)


@pytest.mark.parametrize("main", [W.main, K.main])
def test_probe_mains_need_a_gpu_for_cuda(main, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        main([])
    assert e.value.code != 0
    assert "no CUDA device" in capsys.readouterr().err
