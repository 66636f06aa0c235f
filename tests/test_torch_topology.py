"""The port's process topology on the CPU (``--platform cpu``): the INI
config, ``paf_diskdb`` -> ring -> compute -> ring -> ``paf_dbdisk`` run by
the port's launcher, ``paf_db`` and ``paf_monitor``.

Tolerances: power records equal the float64 golden exactly and the JAX
launcher's records at ``RTOL`` (1e-5, float32 accumulation on the JAX side,
as ``tests/test_torch_pipeline.py``); PFB records within ``BOUND_PFB``
(2e-5, peak-normalized) of the golden stream and of the JAX launcher's;
headers equal. Every stage runs in a process of its own, as the launcher
starts it; ring keys are uuids written into an INI, never the defaults.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import uuid

import numpy as np
import pytest
import torch

from paf_baseband2power_tpu import config as JCONF
from paf_baseband2power_tpu.ops import frame as JF
from paf_baseband2power_tpu.ops.golden import baseband2power_golden
from paf_baseband2power_tpu.ops.pfb import pfb_spectra_golden
from paf_baseband2power_tpu_torch import config as PCONF
from paf_baseband2power_tpu_torch import constants as C
from paf_baseband2power_tpu_torch.cli import launcher, paf_gen
from paf_baseband2power_tpu_torch.cli import paf_baseband2power as cli
from paf_baseband2power_tpu_torch.io import ringbuffer as rb
from paf_baseband2power_tpu_torch.io.dada import (
    DadaFileReader,
    baseband_header,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NDF, NCHK = 32, 8
RTOL = 1e-5
BOUND_PFB = 2e-5
PORT, JAX = "paf_baseband2power_tpu_torch", "paf_baseband2power_tpu"
ENV = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")


def run(pkg, module, *args, timeout=180):
    """``python -m <pkg>.cli.<module> args`` in a process of its own."""
    return subprocess.run(
        [sys.executable, "-m", f"{pkg}.cli.{module}", *args], env=ENV,
        capture_output=True, text=True, timeout=timeout)


def ok(r):
    assert r.returncode == 0, r.stdout + r.stderr
    return r


@pytest.fixture
def keys():
    k = uuid.uuid4().hex[:8], uuid.uuid4().hex[:8]
    yield k
    for key in k:
        if rb.exists(key):
            rb.destroy(key)


def write_conf(path, key_in, key_out, nblk_in=3, nblk_out=2):
    path.write_text(
        f"[BasicConf]\nNCHK_NIC: {NCHK}\n"
        f"[DiskdbConf]\nNDF: {NDF}\nNBLK: {nblk_in}\nKEY: {key_in}\n"
        f"[Baseband2powerConf]\nKEY: {key_out}\nNCHAN: {NCHK * 7}\n"
        f"NBLK: {nblk_out}\n")
    return str(path)


def gen(path, nblocks=2, seed=3, layout="wire"):
    args = ["-o", str(path), "-n", str(nblocks), "--ndf", str(NDF),
            "--nchk", str(NCHK), "--seed", str(seed)]
    assert paf_gen.main(args + (["--device-layout"] if layout == "rows"
                                else [])) == 0
    return str(path)


def records(path, nfloats):
    with DadaFileReader(str(path)) as r:
        return r.header, [np.frombuffer(b, "<f4")
                          for b in r.blocks(nfloats * 4)]


def power_golden(seed):
    return baseband2power_golden(JF.synthetic_block(rng=seed, ndf=NDF,
                                                    nchk=NCHK))


def pfb_err(got, want) -> float:
    return float(np.abs(got.astype(np.float64) - want).max()
                 / np.abs(want).max())


# --- config ---------------------------------------------------------------


@pytest.mark.parametrize("section", ["basic", "diskdb", "baseband2power"])
def test_config_defaults_equal_jax_name_by_name(section):
    p = getattr(PCONF.load_config(), section)
    j = getattr(JCONF.load_config(), section)
    assert [f.name for f in dataclasses.fields(p)] == \
        [f.name for f in dataclasses.fields(j)]
    for f in dataclasses.fields(j):
        assert getattr(p, f.name) == getattr(j, f.name), f.name
        assert type(getattr(p, f.name)) is type(getattr(j, f.name)), f.name


def test_config_buffer_math():
    """Block sizes as ``paf-baseband2power.py:67,79`` computes them."""
    p, j = PCONF.load_config(), JCONF.load_config()
    assert p.diskdb_rbufsz == j.diskdb_rbufsz == 2_818_572_288
    assert p.baseband2power_rbufsz == j.baseband2power_rbufsz == 1344
    assert (p.diskdb.key, p.baseband2power.key) == ("dada", "adad")
    assert (p.diskdb.nblk, p.baseband2power.nblk) == (8, 4)


INIS = [
    # the reference's dialect: tabs, trailing blanks, comments
    "[BasicConf]\nNSAMP_DF:                       128\n"
    "NCHK_NIC:                       4\n\n[DiskdbConf]\n# comment about NDF\n"
    "NDF:      \t     \t     \t 64\nNBLK:   \t    \t    \t 8         \n"
    "KEY:\t\t\t\t dada\nHFNAME:\t\t\t\t header.txt\n\n"
    "[Baseband2powerConf]\nKEY:\t\t\t\tadad\nNCHAN:\t\t\t\t28\n",
    # every key, '=' delimiters, inline comments, an unknown key and section
    "[BasicConf]\nNSAMP_DF = 128\nNPOL_SAMP = 2\nNDIM_POL = 2\n"
    "NCHK_NIC = 2 # two chunks\n[DiskdbConf]\nNDF = 16\nNBLK = 3\n"
    "KEY = b00f\nKFNAME_PREFIX = replay\nNREADER = 2\nSOD = 0\n"
    "HFNAME = h.txt\nEXTRA = 1\n[Baseband2powerConf]\nKEY = f00b\n"
    "KFNAME_PREFIX = power\nNREADER = 1\nSOD = 1\nNCHAN = 14\nNBYTE = 4\n"
    "NBLK = 5\n[Other]\nX: 1\n",
]


@pytest.mark.parametrize("ini", INIS, ids=["reference", "every-key"])
def test_reference_format_ini_parsed_equal(tmp_path, ini):
    path = tmp_path / "p.conf"
    path.write_text(ini)
    p, j = PCONF.load_config(str(path)), JCONF.load_config(str(path))
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    assert (p.diskdb_rbufsz, p.baseband2power_rbufsz) == \
        (j.diskdb_rbufsz, j.baseband2power_rbufsz)
    assert p.diskdb_rbufsz == p.diskdb.ndf * p.basic.nchk_nic * C.DT_SIZE


# --- diskdb -> ring -> dbdisk ----------------------------------------------


@pytest.mark.parametrize("layout", ["wire", "rows"])
def test_diskdb_ring_dbdisk_round_trip(tmp_path, keys, layout):
    """The port's ``paf_diskdb`` replays a recording into a ring and its
    ``paf_dbdisk`` drains it: the same header and payload bytes."""
    key, _ = keys
    bb = gen(tmp_path / "bb.dada", nblocks=3, layout=layout)
    rb.create(key, NDF * NCHK * C.DT_SIZE, 4)
    r = ok(run(PORT, "paf_diskdb", "-a", key, "-c", bb, "-b", str(tmp_path)))
    assert "replayed 3 blocks" in r.stdout
    r = ok(run(PORT, "paf_dbdisk", "-k", key, "-D", str(tmp_path),
               "-o", "out.dada"))
    assert "wrote 3 blocks" in r.stdout
    with DadaFileReader(bb) as a, \
            DadaFileReader(str(tmp_path / "out.dada")) as b:
        assert a.header == b.header
        assert (a.header.get("ORDER") == "SERIES") == (layout == "rows")
        nbytes = NDF * NCHK * C.DT_SIZE
        assert list(a.blocks(nbytes)) == list(b.blocks(nbytes))
    # an existing output is kept without -W
    r = run(PORT, "paf_dbdisk", "-k", key, "-D", str(tmp_path),
            "-o", "out.dada")
    assert r.returncode == 1


@pytest.mark.parametrize("sod", [0, 1])
def test_diskdb_sod_flag(tmp_path, keys, sod):
    """``-e 1`` marks SOD at the first replayed block; ``-e 0`` replays
    without a mark (``paf_diskdb.cu -e``)."""
    key, _ = keys
    bb = gen(tmp_path / "bb.dada", nblocks=1, seed=5)
    rb.create(key, NDF * NCHK * C.DT_SIZE, 4)
    ok(run(PORT, "paf_diskdb", "-a", key, "-c", bb, "-e", str(sod)))
    with rb.RingBuffer(key) as ring:
        assert ring.sod_block == (0 if sod else -1)
        assert ring.blocks_written == 1


def test_dbdisk_wait_sod_spills_the_observation(tmp_path, keys):
    """A writer commits two pre-observation blocks, marks SOD, then writes
    the observation; ``paf_dbdisk --wait-sod`` spills exactly that."""
    key, _ = keys
    bufsz = NDF * NCHK * C.DT_SIZE
    rb.create(key, bufsz, 8)
    blocks = [JF.synthetic_block(rng=11 + i, ndf=NDF, nchk=NCHK)
              for i in range(2)]
    junk_done = threading.Event()

    def writer():
        with rb.RingBuffer(key) as w:
            w.lock_write()
            for _ in range(2):
                w.open_block_write()[:] = 0xEE
                w.close_block_write()
            junk_done.set()
            time.sleep(0.3)
            w.write_header(baseband_header(nchan=NCHK * C.NCHAN_CHK))
            w.set_sod()
            for b in blocks:
                w.open_block_write()[:] = np.frombuffer(b.tobytes(), np.uint8)
                w.close_block_write()
            w.set_eod()
            w.unlock_write()

    t = threading.Thread(target=writer)
    t.start()
    try:
        junk_done.wait(timeout=30)
        r = ok(run(PORT, "paf_dbdisk", "-k", key, "-D", str(tmp_path),
                   "-o", "obs.dada", "-W", "--wait-sod"))
    finally:
        t.join(timeout=60)
    assert "wrote 2 blocks" in r.stdout
    with DadaFileReader(str(tmp_path / "obs.dada")) as reader:
        got = list(reader.blocks(bufsz))
    assert got == [b.tobytes() for b in blocks]


def test_diskdb_skip_blocks_resumes(tmp_path, keys):
    key, _ = keys
    bb = gen(tmp_path / "bb.dada", nblocks=3, seed=50)
    rb.create(key, NDF * NCHK * C.DT_SIZE, 4)
    r = ok(run(PORT, "paf_diskdb", "-a", key, "-c", bb, "--skip-blocks",
               "2"))
    assert "replayed 1 blocks" in r.stdout
    with rb.RingBuffer(key) as ring:
        ring.lock_read()
        assert ring.read_header().get_int("OBS_OFFSET") == \
            2 * NDF * NCHK * C.DT_SIZE
        np.testing.assert_array_equal(
            ring.open_block_read().view("<i2"),
            JF.synthetic_block(rng=52, ndf=NDF, nchk=NCHK).reshape(-1))
        ring.close_block_read()
        assert ring.open_block_read() is None


def test_ring_size_mismatch_rejected(tmp_path, keys):
    """Attach-time size check (``capture.c:600-612``): the ring source
    refuses, and the compute CLI on such a ring fails."""
    key, _ = keys
    rb.create(key, 12345, 2)
    for attach in (
            lambda: rb.RingSource(key, ndf=NDF, nchk=NCHK),
            lambda: cli.main(["-a", f"ring:{key}", "-b",
                              str(tmp_path / "x.dada"), "--ndf", str(NDF),
                              "--nchk", str(NCHK), "--platform", "cpu"])):
        with pytest.raises(rb.RingBufferError, match="bufsz 12345"):
            attach()


def test_paf_db_create_status_sod_destroy(keys):
    key, _ = keys
    r = ok(run(PORT, "paf_db", "-k", key, "-b", "256", "-n", "4", "-r", "2"))
    assert "2 reader(s)" in r.stdout
    st = json.loads(ok(run(PORT, "paf_db", "-k", key, "--status"))
                    .stdout.splitlines()[-1])
    assert st == dict(key=key, bufsz=256, nbufs=4, nreaders=2,
                      blocks_written=0, blocks_read=0, sod_block=-1)
    with rb.RingBuffer(key) as w:
        w.lock_write()
        w.open_block_write()
        w.close_block_write()
        st = json.loads(ok(run(PORT, "paf_db", "-k", key, "--sod"))
                        .stdout.splitlines()[-1])
        assert st["sod_block"] == 1 and st["blocks_written"] == 1
        w.unlock_write()
    ok(run(PORT, "paf_db", "-k", key, "-d"))
    assert not rb.exists(key)
    assert run(PORT, "paf_db", "-k", key).returncode == 2   # no -b


def test_paf_monitor_reports_the_ring(keys):
    key, _ = keys
    rb.create(key, 512, 3)
    with rb.RingBuffer(key) as w:
        w.lock_write()
        w.write_header(baseband_header(nchan=14))
        for _ in range(2):
            w.open_block_write()
            w.close_block_write()
        w.set_eod()
        w.unlock_write()
    snap = json.loads(ok(run(PORT, "paf_monitor", key, "--json"))
                      .stdout.splitlines()[-1])
    assert snap == dict(key=key, bufsz=512, nbufs=3, nreaders=1, written=2,
                        read=0, full=2, at_eod=False)
    r = ok(run(PORT, "paf_monitor", key, "--header"))
    assert "2/3 blocks full" in r.stdout and "NCHAN" in r.stdout
    r = ok(run(PORT, "paf_monitor", uuid.uuid4().hex[:8]))
    assert "unavailable" in r.stderr


# --- the launcher ------------------------------------------------------------


MODES = {"power": [], "composed": ["--pfb", "64", "--stokes",
                                   "--nspectra", "4"]}


@pytest.mark.parametrize("mode", list(MODES))
def test_launcher_matches_jax_launcher(tmp_path, keys, mode):
    """Both launchers in ring mode on one ``paf_gen`` file: headers equal;
    power records equal the golden exactly and the JAX records at RTOL;
    composed PFB records within BOUND_PFB of the golden stream and of the
    JAX records. The rings are gone afterwards; the compute stage logs its
    launches."""
    key_in, key_out = keys
    bb = gen(tmp_path / "bb.dada", nblocks=2, seed=9)
    out = {}
    for pkg in (PORT, JAX):
        d = tmp_path / pkg
        conf = write_conf(tmp_path / f"{pkg}.conf", key_in, key_out)
        ok(run(pkg, "launcher", "-c", conf, "-a", bb, "-b", str(d),
               "-o", "out.dada", *MODES[mode],
               *(["--platform", "cpu"] if pkg == PORT else [])))
        assert not rb.exists(key_in) and not rb.exists(key_out)
        assert (d / "diskdb.key").read_text() == f"DADA INFO:\nkey {key_in}\n"
        nf = NCHK * 7 * (1 if mode == "power" else 64 * 4 * 4)
        out[pkg] = records(d / "out.dada", nf)
    (phdr, prec), (jhdr, jrec) = out[PORT], out[JAX]
    assert phdr == jhdr
    assert len(prec) == len(jrec) == 2
    log = (tmp_path / PORT / "baseband2power.log").read_text()
    assert "pipeline done: 2 blocks" in log and "0 kernel launches" in log
    if mode == "power":
        for i, (p, j) in enumerate(zip(prec, jrec)):
            np.testing.assert_array_equal(p, power_golden(9 + i))
            np.testing.assert_allclose(p, j, rtol=RTOL)
        return
    assert phdr["STOKES"] == "IQUV" and phdr["PFB_NFFT"] == "64"
    blocks = [JF.synthetic_block(rng=9 + i, ndf=NDF, nchk=NCHK)
              for i in range(2)]
    want = pfb_spectra_golden(np.concatenate(blocks), 64, 4, nout=8,
                              stokes=True).reshape(2, -1)
    for p, j, w in zip(prec, jrec, want):
        assert pfb_err(p, w) < BOUND_PFB
        assert pfb_err(p, j.astype(np.float64)) < BOUND_PFB


def test_launcher_raw_spill_and_synthetic_input(tmp_path, keys):
    """Four processes: the baseband ring has NREADER 2, the raw spill's
    payload is byte-equal to the generated input, and the power records
    equal the golden."""
    key_in, key_out = keys
    conf = write_conf(tmp_path / "p.conf", key_in, key_out, nblk_in=4)
    ok(run(PORT, "launcher", "-c", conf, "-a", "synthetic:2", "-b",
           str(tmp_path), "-o", "power.dada", "--raw-spill", "raw.dada",
           "--platform", "cpu"))
    _, recs = records(tmp_path / "power.dada", NCHK * 7)
    assert len(recs) == 2
    for i, rec in enumerate(recs):
        np.testing.assert_array_equal(rec, power_golden(i))
    nbytes = NDF * NCHK * C.DT_SIZE
    with DadaFileReader(str(tmp_path / "raw.dada")) as raw, \
            DadaFileReader(str(tmp_path / "synthetic_bb.dada")) as bb:
        assert raw.header == bb.header
        assert list(raw.blocks(nbytes)) == list(bb.blocks(nbytes))
    assert "launch rawspill" in (tmp_path / "pipeline.log").read_text()


@pytest.mark.parametrize("layout", ["wire", "rows"])
def test_launcher_file_mode(tmp_path, layout):
    """``--mode file`` runs the compute CLI on the file, no rings."""
    bb = gen(tmp_path / "bb.dada", seed=4, layout=layout)
    assert launcher.main(["-a", bb, "-b", str(tmp_path), "-o", "pw.dada",
                          "--mode", "file", "--ndf", str(NDF), "--nchk",
                          str(NCHK), "--platform", "cpu"]) == 0
    _, recs = records(tmp_path / "pw.dada", NCHK * 7)
    assert len(recs) == 2
    for i, rec in enumerate(recs):
        np.testing.assert_array_equal(rec, power_golden(4 + i))


def test_launcher_stops_every_stage_when_one_fails(tmp_path, keys):
    """A stage that fails (here the replay: no such file) stops the others,
    the launcher exits non-zero and the rings are destroyed."""
    key_in, key_out = keys
    conf = write_conf(tmp_path / "p.conf", key_in, key_out)
    t0 = time.monotonic()
    r = run(PORT, "launcher", "-c", conf, "-a", str(tmp_path / "none.dada"),
            "-b", str(tmp_path), "--platform", "cpu")
    assert r.returncode != 0
    assert time.monotonic() - t0 < 50     # not the stages' 60 s timeouts
    assert not rb.exists(key_in) and not rb.exists(key_out)
    assert "diskdb failed" in (tmp_path / "pipeline.log").read_text()


def test_launcher_cuda_exits_nonzero_without_gpu(tmp_path, keys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --platform cuda would run")
    key_in, key_out = keys
    conf = write_conf(tmp_path / "p.conf", key_in, key_out)
    r = run(PORT, "launcher", "-c", conf, "-a", "synthetic:1", "-b",
            str(tmp_path))
    assert r.returncode == 2 and "no CUDA device" in r.stderr
    assert not rb.exists(key_in) and not (tmp_path / "diskdb.key").exists()


# --- the two packages' stages in one topology --------------------------------


@pytest.mark.parametrize("layout", ["wire", "rows"])
def test_port_diskdb_feeds_jax_compute_stage(tmp_path, keys, layout):
    """The port's ``paf_diskdb`` writes the ring, the JAX package's compute
    stage (``JAX_PLATFORMS=cpu``) reads it: ORDER SERIES detected from the
    ring header, records within RTOL of the golden."""
    key_in, _ = keys
    bb = gen(tmp_path / "bb.dada", seed=7, layout=layout)
    rb.create(key_in, NDF * NCHK * C.DT_SIZE, 4)
    ok(run(PORT, "paf_diskdb", "-a", key_in, "-c", bb))
    out = tmp_path / "pw.dada"
    ok(run(JAX, "paf_baseband2power", "-a", f"ring:{key_in}", "-b",
           str(out), "--ndf", str(NDF), "--nchk", str(NCHK)))
    _, recs = records(out, NCHK * 7)
    assert len(recs) == 2
    for i, rec in enumerate(recs):
        np.testing.assert_allclose(rec, power_golden(7 + i), rtol=RTOL)
