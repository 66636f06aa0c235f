"""The port's power ops on the CPU: the plain PyTorch versions against the
float64 golden model (bit-equal), the JAX XLA twins and the Pallas kernels
they stand in for (interpret mode), and the CUDA bindings' dispatch and
build rules.

Tolerance against JAX: rtol 1e-5, the bound ``tests/test_pallas.py`` uses;
it comes from float32 accumulation on the JAX side. The port sums in int64
and is exact, hence bit-equal to the golden.
"""

import os
import stat

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
    baseband2power_scrunch_golden,
)
from paf_baseband2power_tpu_torch.ops import _build
from paf_baseband2power_tpu_torch.ops import cuda_power as CP
from paf_baseband2power_tpu_torch.ops import power as P

RTOL = 1e-5


def _block(ndf, nchk, seed=0):
    return F.synthetic_block(rng=seed, ndf=ndf, nchk=nchk)


def _wire(block):
    return torch.from_numpy(block.reshape(block.shape[0], -1))


def _rows(block, two_d=False):
    r = F.block_to_rows(block)
    return torch.from_numpy(r.reshape(r.shape[0], -1) if two_d else r)


def _bytes(block):
    return torch.from_numpy(np.frombuffer(F.block_to_bytes(block),
                                          np.uint8).copy())


# --- plain versions vs the float64 golden: bit-equal ----------------------


@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("nchk", [48, 4])
@pytest.mark.parametrize("form", ["2d", "6d", "bytes"])
def test_power_bit_equal_golden(form, nchk, mean):
    block = _block(32, nchk, seed=nchk)
    if form == "2d":
        got = P.baseband2power_2d(_wire(block), mean=mean)
    elif form == "6d":
        got = P.baseband2power(torch.from_numpy(block), mean=mean)
    else:
        got = P.baseband2power_bytes(_bytes(block), 32, nchk, mean=mean)
    want = baseband2power_golden(block, mean=mean)
    assert got.dtype == torch.float32 and got.shape == (nchk * 7,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("nout", [1, 4, 32])
@pytest.mark.parametrize("nchk", [48, 4])
def test_scrunch_2d_bit_equal_golden(nchk, nout, mean):
    block = _block(32, nchk, seed=7)
    got = P.baseband2power_scrunch_2d(_wire(block), nout, mean=mean)
    want = baseband2power_scrunch_golden(block, nout, mean=mean)
    assert got.shape == (nout, nchk * 7)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("nout", [1, 8])
@pytest.mark.parametrize("two_d", [False, True])
@pytest.mark.parametrize("nchk", [48, 4])
def test_scrunch_rows_bit_equal_golden(nchk, two_d, nout, mean):
    block = _block(32, nchk, seed=9)
    got = P.baseband2power_scrunch_rows(_rows(block, two_d), nout, mean=mean)
    want = baseband2power_scrunch_golden(block, nout, mean=mean)
    assert got.shape == (nout, nchk * 7)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("layout", ["wire", "rows"])
@pytest.mark.parametrize("nout", [1, 3])
def test_mean_divides_in_float64(layout, nout):
    """24-frame blocks give windows whose divisor is not a power of two,
    so dividing in float32 would round differently from the golden."""
    block = _block(24, 48, seed=12)
    if layout == "wire":
        got = P.baseband2power_scrunch_2d(_wire(block), nout, mean=True)
    else:
        got = P.baseband2power_scrunch_rows(_rows(block), nout, mean=True)
    np.testing.assert_array_equal(
        got.numpy(), baseband2power_scrunch_golden(block, nout, mean=True))


def test_extreme_values_exact():
    """All -32768: every square is 2^30, the largest term; sums stay
    exact in int64 where a 32-bit accumulator would wrap."""
    block = np.full((16, 4, 128, 7, 2, 2), -32768, np.int16)
    want = baseband2power_golden(block)
    assert want[0] == 16 * 128 * 4 * 2.0 ** 30
    np.testing.assert_array_equal(P.baseband2power_2d(_wire(block)).numpy(),
                                  want)
    np.testing.assert_array_equal(
        P.baseband2power_scrunch_rows(_rows(block))[0].numpy(), want)


def test_power_step_forms():
    block = _block(16, 4, seed=3)
    want = baseband2power_golden(block)
    np.testing.assert_array_equal(P.power_step(_wire(block)).numpy(), want)
    np.testing.assert_array_equal(
        P.power_step(torch.from_numpy(block)).numpy(), want)


def test_slabs_cover_every_frame(monkeypatch):
    """Slabs smaller than the block (as at 8192 x 48) still add up."""
    monkeypatch.setattr(P, "_SLAB_ELEMS", 3 * 4 * P.LANES_PER_CHUNK)
    block = _block(32, 4, seed=4)
    np.testing.assert_array_equal(
        P.baseband2power_scrunch_2d(_wire(block), 4).numpy(),
        baseband2power_scrunch_golden(block, 4))
    np.testing.assert_array_equal(
        P.baseband2power_scrunch_rows(_rows(block), 4).numpy(),
        baseband2power_scrunch_golden(block, 4))


# --- plain versions vs the JAX XLA twins ----------------------------------


@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("nchk", [48, 4])
@pytest.mark.parametrize("fn", ["2d", "scrunch_2d", "rows3d", "rows2d",
                                "bytes", "6d"])
def test_matches_jax_xla_twin(fn, nchk, mean):
    ndf, nout = 64, 4
    block = _block(ndf, nchk, seed=21)
    if fn == "2d":
        got = P.baseband2power_2d(_wire(block), mean=mean)
        want = JP.baseband2power_2d(jnp.asarray(block.reshape(ndf, -1)),
                                    mean=mean)
    elif fn == "scrunch_2d":
        got = P.baseband2power_scrunch_2d(_wire(block), nout, mean=mean)
        want = JP.baseband2power_scrunch_2d(
            jnp.asarray(block.reshape(ndf, -1)), nout, mean=mean)
    elif fn in ("rows3d", "rows2d"):
        rows = _rows(block, two_d=fn == "rows2d")
        got = P.baseband2power_scrunch_rows(rows, nout, mean=mean)
        want = JP.baseband2power_scrunch_rows(jnp.asarray(rows.numpy()),
                                              nout, mean=mean)
    elif fn == "bytes":
        got = P.baseband2power_bytes(_bytes(block), ndf, nchk, mean=mean)
        want = JP.baseband2power_bytes(jnp.asarray(_bytes(block).numpy()),
                                       ndf=ndf, nchk=nchk, mean=mean)
    else:
        got = P.baseband2power(torch.from_numpy(block), mean=mean)
        want = JP.baseband2power(jnp.asarray(block), mean=mean)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


# --- plain versions vs the Pallas kernels they stand in for ---------------


@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("nchk", [48, 4])
def test_matches_pallas_k1_power(nchk, mean):
    block = _block(64, nchk, seed=31)
    want = np.asarray(PP.baseband2power_pallas(
        jnp.asarray(PP.pack_block_2d(block)), mean=mean, interpret=True))
    got = CP.baseband2power_cuda(_wire(block), mean=mean)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


# K2 (_scrunch_fused_kernel) is the branch taken at ndf=64, nout=8 (whole
# 8-frame windows per tile); K3 (_make_scrunch_kernel) at nout=2.
@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("nout", [8, 2], ids=["K2", "K3"])
def test_matches_pallas_k2_k3_scrunch(nout, mean):
    block = _block(64, 48, seed=32)
    want = np.asarray(PP.baseband2power_scrunch_pallas(
        jnp.asarray(PP.pack_block_2d(block)), nout, mean=mean,
        interpret=True))
    got = CP.baseband2power_scrunch_cuda(_wire(block), nout, mean=mean)
    assert got.shape == want.shape == (nout, C.NCHAN)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("nout", [1, 8])
@pytest.mark.parametrize("nchk", [48, 4])
def test_matches_pallas_k4_rows(nchk, nout, mean):
    block = _block(64, nchk, seed=33)
    rows = F.block_to_rows(block)
    want = np.asarray(PP.baseband2power_scrunch_rows_pallas(
        jnp.asarray(rows), nout, mean=mean, interpret=True))
    got = CP.baseband2power_scrunch_rows_cuda(torch.from_numpy(rows), nout,
                                              mean=mean)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


# --- shape errors, as in JAX ------------------------------------------------


BAD_SHAPES = {
    "lanes": ("2d", (16, 100), None),
    "nout": ("scrunch_2d", (12, P.LANES_PER_CHUNK), 5),
    "rows_nout": ("rows", (14, 12, 256), 5),
    "bytes": ("bytes", (1000,), None),
}


@pytest.mark.parametrize("case", sorted(BAD_SHAPES))
def test_shape_errors_match_jax(case):
    kind, shape, nout = BAD_SHAPES[case]
    dtype = np.uint8 if kind == "bytes" else np.int16
    x = np.zeros(shape, dtype)
    t = torch.from_numpy(x)
    calls = {
        "2d": [lambda: JP.baseband2power_2d(jnp.asarray(x)),
               lambda: P.baseband2power_2d(t),
               lambda: CP.baseband2power_cuda(t)],
        "scrunch_2d": [
            lambda: JP.baseband2power_scrunch_2d(jnp.asarray(x), nout),
            lambda: P.baseband2power_scrunch_2d(t, nout),
            lambda: CP.baseband2power_scrunch_cuda(t, nout)],
        "rows": [
            lambda: JP.baseband2power_scrunch_rows(jnp.asarray(x), nout),
            lambda: P.baseband2power_scrunch_rows(t, nout),
            lambda: CP.baseband2power_scrunch_rows_cuda(t, nout)],
        "bytes": [
            lambda: JP.baseband2power_bytes(jnp.asarray(x), ndf=2, nchk=1),
            lambda: P.baseband2power_bytes(t, 2, 1),
            lambda: CP.baseband2power_cuda_bytes(t, 2, 1)],
    }[kind]
    for call in calls:
        with pytest.raises(ValueError):
            call()


# --- the CUDA bindings -------------------------------------------------------


WRAPPERS = {
    "baseband2power_cuda": lambda x: CP.baseband2power_cuda(x, mean=True),
    "baseband2power_scrunch_cuda":
        lambda x: CP.baseband2power_scrunch_cuda(x, 4),
    "baseband2power_scrunch_rows_cuda":
        lambda x: CP.baseband2power_scrunch_rows_cuda(
            x.reshape(4 * 14, 32, 256), 2),
    "baseband2power_cuda_bytes":
        lambda x: CP.baseband2power_cuda_bytes(
            x.reshape(-1).view(torch.uint8), 32, 4),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrappers_take_plain_path_on_cpu(name):
    """A CPU tensor runs the plain version and launches nothing."""
    block = _block(32, 4, seed=41)
    before = sum(CP.launches.values())
    got = WRAPPERS[name](_wire(block))
    ref = {
        "baseband2power_cuda": lambda: P.baseband2power_2d(_wire(block),
                                                           mean=True),
        "baseband2power_scrunch_cuda": lambda: P.baseband2power_scrunch_2d(
            _wire(block), 4),
        "baseband2power_scrunch_rows_cuda":
            lambda: P.baseband2power_scrunch_rows(
                _wire(block).reshape(4 * 14, 32, 256), 2),
        "baseband2power_cuda_bytes": lambda: P.baseband2power_2d(
            _wire(block)),
    }[name]()
    assert torch.equal(got, ref)
    assert sum(CP.launches.values()) == before


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrappers_reject_other_devices(name):
    """Neither CPU nor CUDA: raise, never fall back."""
    x = torch.empty((32, 4 * P.LANES_PER_CHUNK), dtype=torch.int16,
                    device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        WRAPPERS[name](x)


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_cuda_tensor_without_cuda_raises(name, monkeypatch, tmp_path):
    """On a host without CUDA a CUDA tensor goes to the kernel, whose build
    fails: the wrapper raises and does not fall back to the plain path."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the kernel would run")
    from torch._subclasses.fake_tensor import FakeTensorMode

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    before = sum(CP.launches.values())
    with FakeTensorMode():
        x = torch.empty((32, 4 * P.LANES_PER_CHUNK), dtype=torch.int16,
                        device="cuda")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            WRAPPERS[name](x)
    assert sum(CP.launches.values()) == before


def test_pack_block_2d_is_view():
    block = torch.from_numpy(_block(8, 4))
    b2 = CP.pack_block_2d(block)
    assert b2.shape == (8, 4 * P.LANES_PER_CHUNK)
    assert b2.data_ptr() == block.data_ptr()


# --- building the kernels ----------------------------------------------------


def _fake_nvcc(path, body):
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_package_sources_are_found():
    names = [os.path.basename(s) for s in _build.sources(_build.CSRC_DIR)]
    assert "power.cu" in names and "stokes.cu" in names
    assert [os.path.basename(h) for h in _build.headers(_build.CSRC_DIR)] \
        == ["geometry.cuh", "tc_dft.cuh"]


def test_source_hash_follows_sources(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    h1 = _build.source_hash([str(src)])
    src.write_text("// two\n")
    assert _build.source_hash([str(src)]) != h1


def test_build_without_nvcc_raises(tmp_path):
    (tmp_path / "k.cu").write_text("// k\n")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(str(tmp_path), str(tmp_path / "b"),
                     nvcc=str(tmp_path / "no-nvcc"))


def test_build_failure_reports_nvcc_output(tmp_path):
    (tmp_path / "k.cu").write_text("// k\n")
    nvcc = _fake_nvcc(tmp_path / "nvcc", 'echo "error: boom" >&2\nexit 1\n')
    with pytest.raises(RuntimeError, match="boom"):
        _build.build(str(tmp_path), str(tmp_path / "b"), nvcc=nvcc)
    assert os.listdir(tmp_path / "b") == []


def test_build_names_library_by_source_hash(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    out = tmp_path / "b"
    good = _fake_nvcc(tmp_path / "nvcc",
                      'while [ "$1" != "-o" ]; do shift; done\n'
                      'echo lib > "$2"\n')
    bad = _fake_nvcc(tmp_path / "nvcc-bad", "exit 1\n")
    lib = _build.build(str(tmp_path), str(out), nvcc=good)
    assert _build.source_hash([str(src)]) in os.path.basename(lib)
    assert os.listdir(out) == [os.path.basename(lib)]   # no temporaries
    # same sources: the library is reused, nvcc is not run
    assert _build.build(str(tmp_path), str(out), nvcc=bad) == lib
    # an edited source never loads the stale library
    src.write_text("// v2\n")
    with pytest.raises(RuntimeError):
        _build.build(str(tmp_path), str(out), nvcc=bad)


def test_build_compiles_sources_in_parallel_then_links(tmp_path):
    """One ``nvcc -c`` per source, all running at once (each compile waits
    until every compile has started, so a serial build would fail), then
    one ``-shared`` link of all the objects."""
    src = tmp_path / "src"
    src.mkdir()
    for name in ("a.cu", "b.cu"):
        (src / name).write_text(f"// {name}\n")
    log, started = tmp_path / "log", tmp_path / "started"
    started.mkdir()
    nvcc = _fake_nvcc(tmp_path / "nvcc", f"""echo "$@" >> {log}
case " $* " in *" -c "*)
  for a; do last=$a; done
  touch {started}/$(basename $last)
  i=0
  while [ $(ls {started} | wc -l) -lt 2 ]; do
    i=$((i + 1)); [ $i -gt 100 ] && exit 1; sleep 0.1
  done;;
esac
while [ "$1" != "-o" ]; do shift; done
echo lib > "$2"
""")
    lib = _build.build(str(src), str(tmp_path / "b"), nvcc=nvcc)
    calls = log.read_text().splitlines()
    compiles = [c for c in calls if " -c " in c]
    assert sorted(c.split()[-1] for c in compiles) == [
        str(src / "a.cu"), str(src / "b.cu")]
    assert "-shared" in calls[-1] and len(calls) == 3
    assert calls[-1].count(".o") == 2
    assert os.listdir(tmp_path / "b") == [os.path.basename(lib)]


def test_build_keeps_ptxas_report_beside_library(tmp_path):
    """The compiles run with ``-Xptxas -v`` and what they print is kept as
    ``<library>.ptxas``, one ``== <source>`` section per source."""
    src = tmp_path / "src"
    src.mkdir()
    for name in ("a.cu", "b.cu"):
        (src / name).write_text(f"// {name}\n")
    nvcc = _fake_nvcc(tmp_path / "nvcc", """case " $* " in *" -Xptxas -v "*)
  for a; do last=$a; done
  echo "ptxas info    : Used 32 registers for $(basename $last)" >&2;;
esac
while [ "$1" != "-o" ]; do shift; done
echo lib > "$2"
""")
    out = tmp_path / "b"
    lib = _build.build(str(src), str(out), nvcc=nvcc)
    assert sorted(os.listdir(out)) == sorted(
        [os.path.basename(lib), os.path.basename(lib) + ".ptxas"])
    assert _build.ptxas_report(lib) == (
        "== a.cu\nptxas info    : Used 32 registers for a.cu\n"
        "== b.cu\nptxas info    : Used 32 registers for b.cu\n")
    assert _build.ptxas_report(str(tmp_path / "none.so")) == ""


def test_build_hash_follows_headers(tmp_path):
    (tmp_path / "k.cu").write_text('#include "g.cuh"\n')
    (tmp_path / "g.cuh").write_text("// v1\n")
    nvcc = _fake_nvcc(tmp_path / "nvcc",
                      'while [ "$1" != "-o" ]; do shift; done\n'
                      'echo lib > "$2"\n')
    lib1 = _build.build(str(tmp_path), str(tmp_path / "b"), nvcc=nvcc)
    (tmp_path / "g.cuh").write_text("// v2\n")
    lib2 = _build.build(str(tmp_path), str(tmp_path / "b"), nvcc=nvcc)
    assert lib1 != lib2
