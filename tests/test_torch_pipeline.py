"""The port's executor and CLI on the CPU (``--platform cpu``): power and
full-Stokes records bit-equal to the float64 golden model and within
tolerance of the JAX CLI on the same input (power: rtol 1e-5; Stokes:
``assert_close`` of ``tests/test_torch_stokes.py``; both from float32
accumulation on the JAX side); PFB records within 2e-5 (peak-normalized)
of the golden over the whole stream and within that ``assert_close`` of
the JAX CLI; ring input and staging. That the port imports neither jax nor
the JAX package is held by ``tests/test_torch_standalone.py``."""

import json
import os
import subprocess
import sys
import uuid

import numpy as np
import pytest
import torch

from paf_baseband2power_tpu import constants as C
from paf_baseband2power_tpu.cli import paf_baseband2power as jax_cli
from paf_baseband2power_tpu.cli import paf_gen
from paf_baseband2power_tpu.io import ringbuffer as rb
from paf_baseband2power_tpu.io.dada import DadaFileReader
from paf_baseband2power_tpu.ops import frame as F
from paf_baseband2power_tpu.ops.golden import (
    baseband2power_golden,
    baseband2power_scrunch_golden,
    baseband2stokes_scrunch_golden,
)
from paf_baseband2power_tpu.ops.pfb import pfb_spectra_golden
from paf_baseband2power_tpu_torch.cli import paf_baseband2power as cli
from paf_baseband2power_tpu_torch.runtime import debug
from paf_baseband2power_tpu_torch.runtime import pipeline as RP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NDF, NCHK = 32, 48
RTOL = 1e-5


def _gen(path, layout="wire", nblocks=2, seed=9, ndf=NDF, nchk=NCHK):
    args = ["-o", str(path), "-n", str(nblocks), "--ndf", str(ndf),
            "--nchk", str(nchk), "--seed", str(seed)]
    if layout == "rows":
        args.append("--device-layout")
    assert paf_gen.main(args) == 0


def _records(path, nout=1, nchk=NCHK, stokes=False):
    shape = (nchk * C.NCHAN_CHK,)
    if stokes:
        shape = (4,) + shape
    if nout > 1:
        shape = (nout,) + shape
    with DadaFileReader(str(path)) as r:
        return r.header, [np.frombuffer(b, "<f4").reshape(shape)
                          for b in r.blocks(int(np.prod(shape)) * 4)]


def _golden(seed, nout, mean=False, ndf=NDF, nchk=NCHK):
    block = F.synthetic_block(rng=seed, ndf=ndf, nchk=nchk)
    if nout == 1:
        return baseband2power_golden(block, mean=mean)
    return baseband2power_scrunch_golden(block, nout, mean=mean)


@pytest.mark.parametrize("nspectra", [1, 4])
@pytest.mark.parametrize("source", ["wire", "rows", "synthetic"])
def test_cli_matches_golden_and_jax_cli(tmp_path, source, nspectra):
    if source == "synthetic":
        inp, seed = "synthetic:2", 0
    else:
        inp, seed = str(tmp_path / "bb.dada"), 9
        _gen(inp, layout=source, seed=seed)
    common = ["-a", inp, "--ndf", str(NDF), "--nchk", str(NCHK),
              "--nspectra", str(nspectra)]
    port_out, jax_out = tmp_path / "port.dada", tmp_path / "jax.dada"
    assert cli.main(common + ["-b", str(port_out), "--platform", "cpu"]) == 0
    assert jax_cli.main(common + ["-b", str(jax_out)]) == 0
    hdr, got = _records(port_out, nspectra)
    jhdr, want_jax = _records(jax_out, nspectra)
    assert len(got) == len(want_jax) == 2
    assert hdr == jhdr
    for i, rec in enumerate(got):
        np.testing.assert_array_equal(rec, _golden(seed + i, nspectra))
        np.testing.assert_allclose(rec, want_jax[i], rtol=RTOL)


@pytest.mark.parametrize("layout", ["wire", "rows"])
def test_diskdb_ring_to_port_cli(tmp_path, layout):
    """paf_diskdb replays a recording into a ring; the port's CLI reads
    the ring (ORDER SERIES detected from the ring header)."""
    ndf, nchk = 32, 4
    key = uuid.uuid4().hex[:8]
    bb = tmp_path / "bb.dada"
    _gen(bb, layout=layout, seed=3, ndf=ndf, nchk=nchk)
    rb.create(key, ndf * nchk * C.DT_SIZE, 4)
    try:
        r = subprocess.run(
            [sys.executable, "-m", "paf_baseband2power_tpu.cli.paf_diskdb",
             "-a", key, "-c", str(bb), "-b", str(tmp_path)],
            env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
            text=True, timeout=180)
        assert r.returncode == 0, r.stderr
        out = tmp_path / "pw.dada"
        assert cli.main(["-a", key, "-b", str(out), "--ndf", str(ndf),
                         "--nchk", str(nchk), "--platform", "cpu"]) == 0
    finally:
        if rb.exists(key):
            rb.destroy(key)
    _, recs = _records(out, nchk=nchk)
    assert len(recs) == 2
    for i, rec in enumerate(recs):
        np.testing.assert_array_equal(
            rec, _golden(3 + i, 1, ndf=ndf, nchk=nchk))


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_pipeline_depths_and_stats(depth):
    src = RP.SyntheticSource(4, ndf=NDF, nchk=4, seed=5)
    sink = RP.MemorySink()
    stats = RP.PowerPipeline("cpu", depth=depth).run(src, sink)
    assert stats.nblocks == len(sink.records) == 4
    assert stats.ndf == NDF
    assert stats.nbytes_in == 4 * NDF * 4 * C.DT_SIZE
    assert sum(r.size for r in sink.records) * 4 == 4 * 4 * C.NCHAN_CHK * 4
    assert len(stats.block_seconds) == 4 and stats.elapsed > 0
    assert stats.kernel_launches == 0          # the CPU runs no kernel
    assert stats.realtime_fraction > 0 and stats.samples_per_sec > 0
    for i, rec in enumerate(sink.records):
        np.testing.assert_array_equal(rec, _golden(5 + i, 1, nchk=4))


@pytest.mark.parametrize("mean", [False, True])
def test_pipeline_rows_blocks_arrive_2d(mean):
    """FileSource and RingSource yield rows blocks 2-D; the executor
    views them (nseries, ndf, 256) before staging."""
    blocks = [F.synthetic_block(rng=60 + i, ndf=NDF, nchk=4)
              for i in range(3)]
    src = [F.block_to_rows(b).reshape(4 * 14, -1) for b in blocks]
    sink = RP.MemorySink()
    pipe = RP.PowerPipeline("cpu", mean=mean, nout=2, device_layout=True)
    pipe.run(src, sink)
    for b, rec in zip(blocks, sink.records):
        np.testing.assert_array_equal(
            rec, baseband2power_scrunch_golden(b, 2, mean=mean))


def test_pipeline_copies_read_only_blocks():
    """Blocks may be read-only views of file bytes (FileSource)."""
    block = F.synthetic_block(rng=2, ndf=NDF, nchk=4).reshape(NDF, -1)
    view = np.frombuffer(block.tobytes(), "<i2").reshape(block.shape)
    assert not view.flags.writeable
    sink = RP.MemorySink()
    RP.PowerPipeline("cpu").run([view, view], sink)
    assert len(sink.records) == 2
    np.testing.assert_array_equal(sink.records[1],
                                  _golden(2, 1, nchk=4))


def test_staging_rejects_shape_change():
    staging = RP._Staging((4, 8), torch.device("cpu"), 2,
                          RP.PipelineStats())
    staging.put(np.zeros((4, 8), np.int16))
    with pytest.raises(ValueError, match="changed"):
        staging.put(np.zeros((4, 16), np.int16))


@pytest.mark.parametrize("kw,item", [({"stokes": True, "pfb_nfft": 64},
                                      "64"),
                                     ({"pfb_nfft": 2048}, "2048"),
                                     ({"pfb_nfft": 128, "pfb_ntap": 9}, "9")])
def test_pipeline_unported_modes_raise(kw, item):
    """Series-row blocks take the PFB at nfft 128-1024 and 1-8 taps only,
    as in the JAX package (its fused kernel's sizes)."""
    with pytest.raises(ValueError, match=f"device-layout PFB .* got {item}"):
        RP.PowerPipeline("cpu", device_layout=True, **kw)


@pytest.mark.parametrize("stokes", [False, True])
@pytest.mark.parametrize("layout", [False, True])
def test_warmup_runs_on_device_zeros(layout, stokes):
    pipe = RP.PowerPipeline("cpu", device_layout=layout, nout=4,
                            stokes=stokes)
    assert pipe.warmup(NDF, 4) >= 0


@pytest.mark.parametrize("nout", [1, 4])
@pytest.mark.parametrize("layout", ["wire", "rows"])
def test_pipeline_stokes_bit_equal_golden(layout, nout, monkeypatch):
    """Stokes records, ``(4, nchan)`` or ``(nout, 4, nchan)``, with the
    per-block check on: Q, U and V are negative and must pass it."""
    monkeypatch.setattr(debug, "_DEBUG", True)
    blocks = [F.synthetic_block(rng=70 + i, ndf=NDF, nchk=4)
              for i in range(2)]
    if layout == "rows":
        src = [F.block_to_rows(b).reshape(4 * 14, -1) for b in blocks]
    else:
        src = [b.reshape(NDF, -1) for b in blocks]
    sink = RP.MemorySink()
    stats = RP.PowerPipeline("cpu", nout=nout, stokes=True,
                             device_layout=layout == "rows").run(src, sink)
    assert stats.nblocks == 2
    assert (sum(r.size for r in sink.records) * 4
            == 2 * nout * 4 * 4 * C.NCHAN_CHK * 4)
    for b, rec in zip(blocks, sink.records):
        want = baseband2stokes_scrunch_golden(b, nout)
        assert (want[:, 1:] < 0).any()
        np.testing.assert_array_equal(rec, want[0] if nout == 1 else want)


@pytest.mark.parametrize("nspectra", [1, 4])
@pytest.mark.parametrize("layout", ["wire", "rows"])
def test_cli_stokes_matches_golden_and_jax_cli(tmp_path, layout, nspectra):
    nchk = 4
    inp = str(tmp_path / "bb.dada")
    _gen(inp, layout=layout, seed=11, nchk=nchk)
    common = ["-a", inp, "--ndf", str(NDF), "--nchk", str(nchk),
              "--nspectra", str(nspectra), "--stokes"]
    port_out, jax_out = tmp_path / "port.dada", tmp_path / "jax.dada"
    assert cli.main(common + ["-b", str(port_out), "--platform", "cpu"]) == 0
    assert jax_cli.main(common + ["-b", str(jax_out)]) == 0
    hdr, got = _records(port_out, nspectra, nchk=nchk, stokes=True)
    jhdr, want_jax = _records(jax_out, nspectra, nchk=nchk, stokes=True)
    assert hdr == jhdr
    assert hdr["NPOL"] == "4" and hdr["STOKES"] == "IQUV"
    assert len(got) == len(want_jax) == 2
    for i, rec in enumerate(got):
        want = baseband2stokes_scrunch_golden(
            F.synthetic_block(rng=11 + i, ndf=NDF, nchk=nchk), nspectra)
        np.testing.assert_array_equal(rec, want[0] if nspectra == 1
                                      else want)
        atol = 1e-5 * float(np.abs(want_jax[i]).max())
        np.testing.assert_allclose(rec, want_jax[i], rtol=2e-4, atol=atol)


@pytest.mark.parametrize("flags", [["--stokes", "--pfb", "64"],
                                   ["--pfb", "2048"],
                                   ["--pfb", "128", "--ntap", "12"]])
def test_cli_unported_flags_exit(tmp_path, flags, capsys):
    """ORDER SERIES input with an nfft or ntap the rows path does not take:
    a usage error (the JAX package's message for nfft), before any output
    is written."""
    bb, out = tmp_path / "bb.dada", tmp_path / "x.dada"
    _gen(bb, layout="rows", nblocks=1, nchk=4)
    capsys.readouterr()
    with pytest.raises(SystemExit) as e:
        cli.main(["-a", str(bb), "-b", str(out), "--ndf", str(NDF),
                  "--nchk", "4", "--platform", "cpu"] + flags)
    assert e.value.code != 0
    err = capsys.readouterr().err
    assert ("device-layout PFB supports 1 <= ntap <= 8" if "--ntap" in flags
            else "device-layout PFB supports nfft in (128, 256, 512, 1024)"
            ) in err
    assert "usage:" in err and "Traceback" not in err
    assert not out.exists()


def test_cli_cuda_platform_without_gpu_fails(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = tmp_path / "x.dada"
    with pytest.raises(SystemExit) as e:
        cli.main(["-a", "synthetic:1", "-b", str(out), "--ndf", "8",
                  "--nchk", "4"])
    assert e.value.code != 0
    assert "no CUDA device" in capsys.readouterr().err
    assert not out.exists()


def test_cli_synthetic_rejects_device_layout(tmp_path):
    with pytest.raises(SystemExit):
        cli.main(["-a", "synthetic:1", "-b", str(tmp_path / "x.dada"),
                  "--device-layout", "--platform", "cpu"])


def test_cli_stats_mean_header_log_profile(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(debug, "_DEBUG", debug.debug_enabled())
    bb, pw = tmp_path / "bb.dada", tmp_path / "pw.dada"
    _gen(bb, seed=4, nchk=4)
    capsys.readouterr()
    assert cli.main(["-a", str(bb), "-b", str(pw), "--ndf", str(NDF),
                     "--nchk", "4", "--mean", "--nspectra", "2",
                     "--platform", "cpu", "--stats-json", "--debug",
                     "--no-warmup", "-c", str(tmp_path / "logs"),
                     "--profile", str(tmp_path / "prof")]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["nblocks"] == 2 and stats["kernel_launches"] == 0
    assert stats["partial_bytes"] == 0         # no PFB kernel on the CPU
    assert stats["pfb_stage_depths"] == {}
    assert stats["pfb_fft_lane_stages"] == {}
    assert stats["device"] == "cpu" and stats["samples_per_sec"] > 0
    # no event on the CPU, so nothing waits
    assert stats["slot_waits"] == 0 and stats["record_waits"] == 0
    assert stats["direct_h2d"] == 0            # the CPU copies every block
    hdr, recs = _records(pw, nout=2, nchk=4)
    assert hdr["UTC_START"] == "2026-01-01-00:00:00"
    assert hdr.get_int("NCHAN") == 4 * C.NCHAN_CHK
    assert hdr.get_int("NSBLK") == 2
    for i, rec in enumerate(recs):
        np.testing.assert_array_equal(rec, _golden(4 + i, 2, mean=True,
                                                   nchk=4))
    assert (tmp_path / "logs" / "baseband2power.log").exists()
    trace = (tmp_path / "prof" / "trace.json").read_text()
    assert '"pafb2p.step"' in trace and '"pafb2p.sink"' in trace


def test_file_source_layouts(tmp_path):
    wire, rows = tmp_path / "w.dada", tmp_path / "r.dada"
    _gen(wire, nblocks=1, nchk=4)
    _gen(rows, layout="rows", nblocks=1, nchk=4)
    assert RP.FileSource(str(wire), ndf=NDF, nchk=4).layout == "wire"
    src = RP.FileSource(str(rows), ndf=NDF, nchk=4)
    assert src.layout == "rows"
    assert [b.shape for b in src] == [(4 * 14, NDF * 256)]
    with pytest.raises(ValueError, match="unknown layout"):
        RP.FileSource(str(wire), ndf=NDF, nchk=4, layout="planes")


def _pfb_golden_stream(seed, nblocks, nfft, nout, stokes, ndf=NDF,
                       nchk=NCHK, ntap=4):
    """The float64 golden over the whole stream of ``paf_gen`` blocks,
    ``nout`` spectra per block: the records a carried stream must give."""
    blocks = [F.synthetic_block(rng=seed + i, ndf=ndf, nchk=nchk)
              for i in range(nblocks)]
    want = pfb_spectra_golden(np.concatenate(blocks), nfft, ntap,
                              nout=nblocks * nout, stokes=stokes)
    return [want[i * nout:(i + 1) * nout] for i in range(nblocks)]


def _pfb_err(got, want) -> float:
    return float(np.abs(got.astype(np.float64) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("layout,flags", [
    ("wire", ["--pfb", "32"]),
    ("wire", ["--pfb", "128", "--stokes", "--nspectra", "2"]),
    ("rows", ["--pfb", "128"]),
    # the shapes the CUDA kernel does not take (the torch.fft route on the
    # card): the smallest inputs of both, from the synthetic source
    ("synthetic", ["--pfb", "2048", "--ndf", "64", "--nchk", "1"]),
    ("synthetic", ["--pfb", "128", "--ntap", "12", "--ndf", "64",
                   "--nchk", "1"])])
def test_cli_pfb_matches_golden_stream_and_jax_cli(tmp_path, layout, flags):
    opt = dict(zip(flags[::2], flags[1::2]))
    nchk, nfft = int(opt.get("--nchk", 2)), int(opt["--pfb"])
    ndf, ntap = int(opt.get("--ndf", NDF)), int(opt.get("--ntap", 4))
    stokes, nout = "--stokes" in flags, 2 if "--nspectra" in flags else 1
    if layout == "synthetic":
        inp, nblocks, seed = "synthetic:2", 2, 0
        common = ["-a", inp] + flags
    else:
        inp, nblocks, seed = str(tmp_path / "bb.dada"), 3, 21
        _gen(inp, layout=layout, nblocks=3, seed=seed, nchk=nchk)
        common = ["-a", inp, "--ndf", str(ndf), "--nchk", str(nchk)] + flags
    port_out, jax_out = tmp_path / "port.dada", tmp_path / "jax.dada"
    assert cli.main(common + ["-b", str(port_out), "--platform", "cpu"]) == 0
    # the JAX CLI in a process of its own, on the CPU
    r = subprocess.run(
        [sys.executable, "-m", "paf_baseband2power_tpu.cli.paf_baseband2power"]
        + common + ["-b", str(jax_out)],
        env=dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    shape = (nout,) + ((4,) if stokes else ()) + (nchk * C.NCHAN_CHK * nfft,)
    with DadaFileReader(str(port_out)) as r, \
            DadaFileReader(str(jax_out)) as q:
        nbytes = int(np.prod(shape)) * 4
        got = [np.frombuffer(b, "<f4").reshape(shape)
               for b in r.blocks(nbytes)]
        want_jax = [np.frombuffer(b, "<f4").reshape(shape)
                    for b in q.blocks(nbytes)]
        assert r.header == q.header
        hdr = r.header
    assert hdr.get_int("NCHAN") == nchk * C.NCHAN_CHK * nfft
    assert hdr["PFB_NFFT"] == str(nfft) and hdr["PFB_NTAP"] == str(ntap)
    assert hdr["PFB_WINDOW"] == "hamming"
    assert hdr["NPOL"] == ("4" if stokes else "1")
    assert len(got) == len(want_jax) == nblocks
    golden = _pfb_golden_stream(seed, nblocks, nfft, nout, stokes, ndf=ndf,
                                nchk=nchk, ntap=ntap)
    for rec, jrec, want in zip(got, want_jax, golden):
        assert _pfb_err(rec, want) < 2e-5
        assert _pfb_err(rec, jrec.astype(np.float64)) < 2e-5
        atol = 1e-5 * float(np.abs(jrec).max())
        np.testing.assert_allclose(rec, jrec, rtol=2e-4, atol=atol)


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("layout", ["wire", "rows"])
def test_pipeline_pfb_carry_across_blocks(layout, depth):
    """The carry is a tensor of its own: at depth 1 the next block is
    staged into the same slot before the carry is read, and the stream
    still equals the golden over all its blocks."""
    blocks = [F.synthetic_block(rng=80 + i, ndf=NDF, nchk=4)
              for i in range(3)]
    if layout == "rows":
        src = [F.block_to_rows(b).reshape(4 * 14, -1) for b in blocks]
    else:
        src = [b.reshape(NDF, -1) for b in blocks]
    sink = RP.MemorySink()
    pipe = RP.PowerPipeline("cpu", depth=depth, pfb_nfft=128,
                            device_layout=layout == "rows")
    pipe.warmup(NDF, 4)
    stats = pipe.run(src, sink)
    assert stats.nblocks == 3
    assert (sum(r.size for r in sink.records) * 4
            == 3 * 4 * C.NCHAN_CHK * 128 * 4)
    want = pfb_spectra_golden(np.concatenate(blocks), 128, 4, nout=3)
    for rec, w in zip(sink.records, want):
        assert rec.shape == (4 * C.NCHAN_CHK * 128,)
        assert _pfb_err(rec, w) < 2e-5


@pytest.mark.parametrize("stokes", [False, True])
def test_pipeline_pfb_record_shapes_and_warmup(stokes, monkeypatch):
    """Stokes keeps its spectra axis at nout 1 (as the JAX package's
    streaming step does); the per-block check passes signed Q, U, V."""
    monkeypatch.setattr(debug, "_DEBUG", True)
    pipe = RP.PowerPipeline("cpu", pfb_nfft=64, pfb_ntap=2,
                            pfb_window="rect", stokes=stokes, mean=True)
    assert pipe.warmup(NDF, 4) >= 0
    sink = RP.MemorySink()
    pipe.run(RP.SyntheticSource(2, ndf=NDF, nchk=4, seed=3), sink)
    shape = (1, 4, 4 * C.NCHAN_CHK * 64) if stokes else (4 * C.NCHAN_CHK
                                                          * 64,)
    assert [r.shape for r in sink.records] == [shape, shape]


def test_pipeline_power_fn_replaces_the_step():
    """``power_fn`` (the JAX package's argument): the pipeline calls it on
    each staged block in place of its own step."""
    from paf_baseband2power_tpu_torch.ops import power as P

    seen = []

    def power_fn(x):
        seen.append(tuple(x.shape))
        return P.baseband2power_2d(x, mean=True)

    sink = RP.MemorySink()
    stats = RP.PowerPipeline("cpu", power_fn=power_fn).run(
        RP.SyntheticSource(2, ndf=NDF, nchk=4, seed=5), sink)
    assert stats.nblocks == 2 and seen == [(NDF, 4 * 3584)] * 2
    for i, rec in enumerate(sink.records):
        np.testing.assert_array_equal(rec, baseband2power_golden(
            F.synthetic_block(rng=5 + i, ndf=NDF, nchk=4), mean=True))


def test_pipeline_streaming_power_fn_carries_its_state():
    """With ``pfb_nfft`` a ``power_fn(x, carry) -> (record, carry)``
    streams: each block gets the carry the previous one returned, the
    first none."""
    from paf_baseband2power_tpu_torch.ops import pfb as PF

    carries = []

    def step(x, carry):
        carries.append(carry)
        return PF.pfb_spectra(x, 128, 4, history=carry, return_history=True)

    blocks = [F.synthetic_block(rng=90 + i, ndf=NDF, nchk=4)
              for i in range(3)]
    sink = RP.MemorySink()
    RP.PowerPipeline("cpu", power_fn=step, pfb_nfft=128).run(
        [b.reshape(NDF, -1) for b in blocks], sink)
    assert carries[0] is None and all(c is not None for c in carries[1:])
    want = pfb_spectra_golden(np.concatenate(blocks), 128, 4, nout=3)
    for rec, w in zip(sink.records, want):
        assert _pfb_err(rec.reshape(-1), w) < 2e-5
