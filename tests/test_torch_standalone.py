"""The port stands alone: it imports neither ``jax`` nor anything of the
JAX package, and its copies of that package's numpy/ctypes modules
(``constants``, ``config``, ``io/dada``, ``io/ringbuffer`` with
``native/ringbuf``, ``io/capture`` with ``native/capture``, ``io/sender``
with ``native/sender``, ``ops/frame``, ``ops/time_utils``, ``runtime/log``,
``runtime/debug``, ``cli/paf_gen``, ``cli/paf_diskdb``, ``cli/paf_dbdisk``,
``cli/paf_db``, ``cli/paf_monitor``, ``cli/paf_capture``) are held against
their originals here: equal constants, byte-equal headers, files and native
sources, equal arrays, the same options and structures, and rings that the
two packages read from each other. ``tests/test_torch_topology.py`` and
``tests/test_torch_capture.py`` hold the copies' results equal too."""

import os
import subprocess
import sys
import uuid

import numpy as np
import pytest

from paf_baseband2power_tpu import constants as JC
from paf_baseband2power_tpu.cli import paf_baseband2power as jax_cli
from paf_baseband2power_tpu.cli import paf_gen as jax_gen
from paf_baseband2power_tpu.io import dada as JD
from paf_baseband2power_tpu.io import ringbuffer as JR
from paf_baseband2power_tpu.ops import frame as JF
from paf_baseband2power_tpu.runtime import debug as JDBG
from paf_baseband2power_tpu_torch import constants as PC
from paf_baseband2power_tpu_torch.cli import paf_baseband2power as cli
from paf_baseband2power_tpu_torch.cli import paf_gen
from paf_baseband2power_tpu_torch.io import dada as PD
from paf_baseband2power_tpu_torch.io import ringbuffer as PR
from paf_baseband2power_tpu_torch.ops import _build
from paf_baseband2power_tpu_torch.ops import frame as PF
from paf_baseband2power_tpu_torch.runtime import debug as PDBG
from paf_baseband2power_tpu_torch.runtime.log import open_log

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_STANDALONE = r"""
import importlib.util, os, pkgutil, sys, threading, uuid
import numpy as np
import paf_baseband2power_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    __import__(m.name)
from paf_baseband2power_tpu_torch import constants as C
from paf_baseband2power_tpu_torch.cli import paf_baseband2power, paf_gen
from paf_baseband2power_tpu_torch.io import ringbuffer as rb
from paf_baseband2power_tpu_torch.io.dada import baseband_header
from paf_baseband2power_tpu_torch.probes import karatsuba
tmp = sys.argv[1]
bb = os.path.join(tmp, "bb.dada")
assert paf_gen.main(["-o", bb, "-n", "2", "--ndf", "16", "--nchk", "4"]) == 0
for flags in (["--nspectra", "2"], ["--stokes"],
              ["--pfb", "32", "--stokes", "--nspectra", "2"]):
    out = os.path.join(tmp, "out.dada")
    assert paf_baseband2power.main(["-a", bb, "-b", out, "--ndf", "16",
                                    "--nchk", "4", "--platform", "cpu"]
                                   + flags) == 0
# ring source and ring sink
ndf, nchk = 16, 4
kin, kout = uuid.uuid4().hex[:8], uuid.uuid4().hex[:8]
rb.create(kin, ndf * nchk * C.DT_SIZE, 4)
rb.create(kout, nchk * 7 * 4, 4)
try:
    w = rb.RingBuffer(kin)
    w.lock_write()
    w.write_header(baseband_header(nchan=nchk * 7))
    for i in range(2):
        v = w.open_block_write()
        v[:] = np.random.default_rng(i).integers(0, 256, v.size, np.uint8)
        w.close_block_write()
    w.set_eod()
    w.unlock_write()
    w.disconnect()
    assert paf_baseband2power.main(["-a", kin, "-b", kout, "--ndf", str(ndf),
                                    "--nchk", str(nchk), "--platform",
                                    "cpu"]) == 0
    r = rb.RingBuffer(kout)
    r.lock_read()
    n = 0
    while r.open_block_read(5_000_000) is not None:
        r.close_block_read()
        n += 1
    assert n == 2, n
    r.unlock_read()
    r.disconnect()
finally:
    rb.destroy(kin)
    rb.destroy(kout)
assert karatsuba.main(["--check", "--platform", "cpu"]) == 0
# the topology's modules, in this process: config, launcher (file mode),
# paf_db, paf_diskdb -> ring -> paf_dbdisk, paf_monitor, a short capture
# fed by the native sender, the frame header and time bookkeeping
import socket, threading
from paf_baseband2power_tpu_torch import config
from paf_baseband2power_tpu_torch.cli import (launcher, paf_db, paf_dbdisk,
                                              paf_diskdb, paf_monitor)
from paf_baseband2power_tpu_torch.io import capture, sender
from paf_baseband2power_tpu_torch.ops import frame, time_utils
assert config.load_config().diskdb_rbufsz == C.BLOCK_NBYTES
assert launcher.main(["-a", bb, "-b", tmp, "-o", "l.dada", "--mode", "file",
                      "--ndf", "16", "--nchk", "4", "--platform", "cpu"]) == 0
key = uuid.uuid4().hex[:8]
assert paf_db.main(["-k", key, "-b", str(16 * 4 * C.DT_SIZE), "-n", "4"]) == 0
assert paf_diskdb.main(["-a", key, "-c", bb]) == 0
assert paf_monitor.main([key, "--json"]) == 0
assert paf_dbdisk.main(["-k", key, "-D", tmp, "-o", "spill.dada"]) == 0
assert paf_db.main(["-k", key, "-d"]) == 0
rb.create(key, 16 * 2 * C.DT_SIZE, 4)
try:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    eng = capture.CaptureEngine(capture.CaptureConf(
        ip="127.0.0.1", port_base=port, nports=1, ring_key=key, ndf_blk=16,
        nchk=2, tbuf_ndf=4, timeout_sec=1.0, ndf_check=4))
    done = threading.Event()
    def feed():
        while not done.is_set():
            sender.stream_frames(port_base=port, nports=1, nchk=2,
                                 nframes=4, pace_sec=0.0005)
    t = threading.Thread(target=feed)
    t.start()
    try:
        assert eng.probe() == 1
    finally:
        done.set()
        t.join()
    eng.start()
    assert sender.stream_frames_native(port_base=port, nports=1, nchk=2,
                                       idf0=eng.ref_idf, nframes=32,
                                       rate=0.05) == 64
    assert eng.wait() == 0 and eng.blocks_committed >= 2
    eng.close()
finally:
    rb.destroy(key)
h = frame.FrameHeader(valid=1, idf=7, sec=27, epoch=51, freq=1000.0)
assert frame.FrameHeader.unpack(h.pack()) == h
assert time_utils.start_time(51, 27, 7)[1] == 7 * C.TDF_PICOSECONDS
spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(sys.argv[2], "chip_smoke.py"))
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print("LOADED", sorted(m for m in sys.modules
                       if m.split(".")[0].startswith("jax")
                       or m.split(".")[0] == "paf_baseband2power_tpu"))
"""


def test_port_never_imports_jax(tmp_path):
    """Every module of the port, the CLI's CPU paths (power, Stokes, PFB;
    file and ring source and sink), a probe, the topology's modules (config,
    launcher, paf_db, paf_diskdb, paf_dbdisk, paf_monitor, capture and
    both senders) and ``chip_smoke`` (imported, not run) load neither jax
    nor any module of the JAX package."""
    r = subprocess.run([sys.executable, "-c", _STANDALONE, str(tmp_path),
                        REPO], env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "LOADED []"


def test_port_sources_name_no_jax_package():
    """No import statement of the port or of ``chip_smoke.py`` names the
    JAX package (its name appears in docstrings, comments and the paths
    of the Pallas kernels only)."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    port = os.path.join(REPO, "paf_baseband2power_tpu_torch")
    for root, _, names in os.walk(port):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = []
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                s = line.strip()
                if (s.startswith(("import ", "from "))
                        and ("jax" in s.split()[1]
                             or s.split()[1].split(".")[0]
                             == "paf_baseband2power_tpu")):
                    bad.append(f"{path}:{i}: {s}")
    assert bad == []


# --- the copies against their originals -------------------------------------


def _public(mod):
    return {k: getattr(mod, k) for k in dir(mod) if k.isupper()}


def test_constants_equal_name_by_name():
    jc, pc = _public(JC), _public(PC)
    assert sorted(jc) == sorted(pc)
    for name, value in jc.items():
        assert pc[name] == value and type(pc[name]) is type(value), name


HEADER_ARGS = [
    {},
    dict(utc_start="2026-01-01-00:00:00", picoseconds=12, freq=1340.5,
         bw=336, nchan=28, source="J0332+5434"),
    dict(nchan=336 * 1024, tint_sec=0.1, extra={"PFB_NFFT": 1024,
                                                "NPOL": 4}),
]


@pytest.mark.parametrize("kw", HEADER_ARGS)
def test_output_header_bytes_equal(kw):
    assert PD.output_header(**kw).serialize() == \
        JD.output_header(**kw).serialize()


@pytest.mark.parametrize("kw", [
    {}, dict(utc_start="2026-02-03-04:05:06", picoseconds=0, freq=1340.5,
             nchan=28, extra={"ORDER": "SERIES"})])
def test_baseband_header_bytes_equal(kw):
    p, j = PD.baseband_header(**kw), JD.baseband_header(**kw)
    assert p.serialize() == j.serialize()
    assert PD.DadaHeader.parse(j.serialize()) == p


@pytest.mark.parametrize("nblocks", [1, 3])
def test_dada_writer_files_byte_equal_and_read_back(tmp_path, nblocks):
    hdr = dict(utc_start="2026-01-01-00:00:00", freq=1340.5, nchan=28)
    recs = [np.random.default_rng(i).normal(size=28).astype("<f4")
            for i in range(nblocks)]
    for pkg, name in ((PD, "p.dada"), (JD, "j.dada")):
        with pkg.DadaFileWriter(str(tmp_path / name),
                                pkg.output_header(**hdr)) as w:
            for r in recs:
                w.write(r)
    assert (tmp_path / "p.dada").read_bytes() == \
        (tmp_path / "j.dada").read_bytes()
    with PD.DadaFileReader(str(tmp_path / "j.dada")) as r:
        assert r.header == JD.output_header(**hdr)
        got = [np.frombuffer(b, "<f4") for b in r.blocks(28 * 4)]
    assert all(np.array_equal(a, b) for a, b in zip(got, recs))
    assert len(got) == nblocks


@pytest.mark.parametrize("layout", ["wire", "rows"])
def test_paf_gen_recordings_byte_equal(tmp_path, layout, capsys):
    args = ["-n", "2", "--ndf", "8", "--nchk", "2", "--seed", "3"]
    if layout == "rows":
        args.append("--device-layout")
    assert paf_gen.main(["-o", str(tmp_path / "p.dada")] + args) == 0
    assert jax_gen.main(["-o", str(tmp_path / "j.dada")] + args) == 0
    assert (tmp_path / "p.dada").read_bytes() == \
        (tmp_path / "j.dada").read_bytes()


@pytest.mark.parametrize("kw", [dict(rng=0, ndf=4, nchk=2),
                                dict(rng=5, ndf=16, nchk=3, scale=3000.0),
                                dict(rng=9, ndf=2, nchk=1, scale=1e5)])
def test_frame_functions_equal(kw):
    p, j = PF.synthetic_block(**kw), JF.synthetic_block(**kw)
    np.testing.assert_array_equal(p, j)
    assert p.dtype == j.dtype and p.shape == j.shape
    raw = PF.block_to_bytes(p)
    assert raw == JF.block_to_bytes(j)
    np.testing.assert_array_equal(PF.bytes_to_block(raw, kw["ndf"],
                                                    kw["nchk"]),
                                  JF.bytes_to_block(raw, kw["ndf"],
                                                    kw["nchk"]))
    rows = PF.block_to_rows(p)
    np.testing.assert_array_equal(rows, JF.block_to_rows(j))
    np.testing.assert_array_equal(
        PF.rows_to_block(rows, kw["ndf"], kw["nchk"]),
        JF.rows_to_block(rows, kw["ndf"], kw["nchk"]))
    np.testing.assert_array_equal(
        PF.rows_to_block(rows, kw["ndf"], kw["nchk"]), p)


@pytest.mark.parametrize("s", ["dada", "adad", "1234", "beef01", "dadadadad",
                               "ring:dada", "xyz", "README.md"])
def test_looks_like_ring_key_matches_jax_cli(s):
    assert cli.looks_like_ring_key(s) == jax_cli.looks_like_ring_key(s)


@pytest.mark.parametrize("power,signed", [
    (np.ones(4), False), (np.array([1.0, -1.0]), False),
    (np.array([1.0, -1.0]), True), (np.array([np.nan, 1.0]), True),
    (np.array([np.inf]), False)])
def test_check_power_matches_jax(power, signed):
    def outcome(mod):
        try:
            mod.check_power(power, 3, signed=signed)
        except mod.PowerCheckError as e:
            return str(e)
        return None
    assert outcome(PDBG) == outcome(JDBG)


def test_debug_switch_and_log(tmp_path, monkeypatch):
    monkeypatch.setattr(PDBG, "_DEBUG", False)
    PDBG.set_debug(True)
    assert PDBG.debug_enabled() and not hasattr(PDBG, "profile_trace")
    log = open_log("standalone-test", str(tmp_path))
    log.info("hello")
    for h in log.handlers:
        h.flush()
    assert "hello" in (tmp_path / "standalone-test.log").read_text()


# --- the ring: the two packages read each other's rings ---------------------


def _writer_and_reader(direction):
    """(ring module that writes, its DADA module, ring module that reads)."""
    return (JR, JD, PR) if direction == "jax->port" else (PR, PD, JR)


@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
def test_ring_blocks_cross_packages(direction):
    """RingSink of one package -> RingSource of the other: the header, every
    block after SOD (one pre-SOD block is skipped) and EOD."""
    wpkg, wdada, rpkg = _writer_and_reader(direction)
    ndf, nchk = 4, 2
    key = uuid.uuid4().hex[:8]
    blocks = [PF.synthetic_block(rng=40 + i, ndf=ndf, nchk=nchk,
                                 scale=4000.0).reshape(ndf, -1)
              for i in range(3)]
    hdr = wdada.baseband_header(nchan=nchk * 7, extra={"ORDER": "TFP"})
    wpkg.create(key, ndf * nchk * PC.DT_SIZE, 4)
    try:
        sink = wpkg.RingSink(key, header=hdr)
        sink.write(blocks[0].view("<f4"))        # pre-observation data
        sink._rb.set_sod()
        for b in blocks[1:]:
            sink.write(b.view("<f4"))            # the bytes, unconverted
        sink.close()
        src = rpkg.RingSource(key, ndf=ndf, nchk=nchk, timeout_us=5_000_000,
                              wait_sod=True)
        assert src.start_block == 1
        assert src.header == hdr
        got = list(src)                            # ends at EOD
    finally:
        wpkg.destroy(key)
    assert len(got) == 2
    for g, b in zip(got, blocks[1:]):
        np.testing.assert_array_equal(g, b)


@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
def test_ring_records_cross_packages(direction):
    """Power records written by one package's RingSink and read back, block
    by block with their byte counts, by the other's reader."""
    wpkg, wdada, rpkg = _writer_and_reader(direction)
    key = uuid.uuid4().hex[:8]
    recs = [np.arange(14, dtype="<f4") * (i + 1) for i in range(3)]
    wpkg.create(key, 1024, 4)
    try:
        sink = wpkg.RingSink(key, header=wdada.output_header(nchan=14))
        for r in recs:
            sink.write(r)
        sink.close()
        rd = rpkg.RingBuffer(key)
        assert (rd.bufsz, rd.nbufs, rd.blocks_written) == (1024, 4, 3)
        rd.lock_read()
        assert rd.read_header(5_000_000) == PD.output_header(nchan=14)
        got = []
        while (v := rd.open_block_read(5_000_000)) is not None:
            got.append(np.frombuffer(v.tobytes(), "<f4"))
            rd.close_block_read()
        assert rd.at_eod()
        rd.unlock_read()
        rd.disconnect()
    finally:
        rpkg.destroy(key)
        assert not wpkg.exists(key)
    assert len(got) == 3
    for g, r in zip(got, recs):
        np.testing.assert_array_equal(g, r)


def test_ring_library_is_the_ports_own_build():
    """The port's host library (ring, capture engine, sender: one library,
    as the JAX package's ``native/Makefile`` builds) is built from its own
    ``native/`` copy into ``.build/``, named after the sources' hash; its
    sources equal the JAX package's byte for byte."""
    lib = PR.load_library()
    assert os.path.basename(lib._name).startswith("libpafb2p-")
    assert os.path.dirname(lib._name) == _build.BUILD_DIR
    for fn in ("pafb2p_rb_connect", "pafb2p_capture_create",
               "pafb2p_sender_run"):
        assert hasattr(lib, fn), fn
    jax_native = os.path.join(REPO, "paf_baseband2power_tpu", "native")
    names = [f"{n}.{ext}" for n in PR.NATIVE_SOURCES for ext in ("cpp", "h")]
    assert sorted(names) == sorted(os.listdir(PR.NATIVE_DIR))
    for name in names:
        with open(os.path.join(PR.NATIVE_DIR, name), "rb") as a, \
                open(os.path.join(jax_native, name), "rb") as b:
            assert a.read() == b.read(), name


def _fake_cxx(path, body):
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(0o755)
    return str(path)


def test_host_library_named_by_hash_and_reused(tmp_path):
    src = tmp_path / "r.cpp"
    src.write_text("// v1\n")
    good = _fake_cxx(tmp_path / "cxx",
                     'while [ "$1" != "-o" ]; do shift; done\n'
                     'echo lib > "$2"\n')
    bad = _fake_cxx(tmp_path / "cxx-bad", 'echo "error: nope" >&2\nexit 1\n')
    out = str(tmp_path / "b")
    lib = _build.build_host_library("libx", [str(src)], [], out, cxx=good)
    assert os.path.basename(lib).startswith("libx-")
    assert os.listdir(out) == [os.path.basename(lib)]
    assert _build.build_host_library("libx", [str(src)], [], out,
                                     cxx=bad) == lib
    src.write_text("// v2\n")
    with pytest.raises(RuntimeError, match="nope"):
        _build.build_host_library("libx", [str(src)], [], out, cxx=bad)
    assert os.listdir(out) == [os.path.basename(lib)]


# --- the topology's copies: the same options and structures -----------------


class _Parsed(Exception):
    pass


def _options(main):
    """Each option of a CLI's parser: (flags, default, type, choices, nargs,
    required, action class)."""
    import argparse

    seen = []

    def grab(self, *a, **k):
        seen.append(self)
        raise _Parsed

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(_Parsed):
            main([])
    finally:
        argparse.ArgumentParser.parse_args = orig
    return {tuple(a.option_strings) or (a.dest,):
            (a.default, a.type, a.choices, a.nargs, a.required,
             type(a).__name__) for a in seen[0]._actions}


COPIED_CLIS = ["paf_diskdb", "paf_dbdisk", "paf_db", "paf_monitor",
               "paf_capture", "paf_gen"]


@pytest.mark.parametrize("name", COPIED_CLIS)
def test_copied_cli_options_equal(name):
    import importlib

    port = importlib.import_module(f"paf_baseband2power_tpu_torch.cli.{name}")
    jax = importlib.import_module(f"paf_baseband2power_tpu.cli.{name}")
    assert _options(port.main) == _options(jax.main)


@pytest.mark.parametrize("name,added,removed", [
    ("launcher", {("--platform",)}, set()),
    ("paf_soak", {("--platform",)}, {("--fetch-every",),
                                     ("--sharded-rows",)})])
def test_ported_cli_options(name, added, removed):
    """The launcher and the soak keep every option of the JAX package's
    but those the port leaves out, and add ``--platform`` (default cuda)."""
    import importlib

    port = _options(importlib.import_module(
        f"paf_baseband2power_tpu_torch.cli.{name}").main)
    jax = _options(importlib.import_module(
        f"paf_baseband2power_tpu.cli.{name}").main)
    assert set(port) - set(jax) == added
    assert set(jax) - set(port) == removed
    assert {k: v for k, v in jax.items() if k not in removed} == \
        {k: v for k, v in port.items() if k not in added}
    assert port[("--platform",)][:3] == ("cuda", None, ["cuda", "cpu"])


def test_capture_and_sender_structures_equal():
    """The ctypes structures passed to the native library, the capture
    configuration's defaults, and the senders' signatures."""
    import dataclasses
    import inspect

    from paf_baseband2power_tpu.io import capture as JCAP
    from paf_baseband2power_tpu.io import sender as JS
    from paf_baseband2power_tpu_torch.io import capture as PCAP
    from paf_baseband2power_tpu_torch.io import sender as PS

    assert PCAP._ConfStruct._fields_ == JCAP._ConfStruct._fields_
    assert PS._SenderConfStruct._fields_ == JS._SenderConfStruct._fields_
    for cls in ("CaptureConf", "PortStats"):
        p, j = getattr(PCAP, cls), getattr(JCAP, cls)
        assert [(f.name, f.default) for f in dataclasses.fields(p)] == \
            [(f.name, f.default) for f in dataclasses.fields(j)]
    assert bytes(PCAP.CaptureConf().to_struct()) == \
        bytes(JCAP.CaptureConf().to_struct())
    for fn in ("stream_frames", "stream_frames_native"):
        assert inspect.signature(getattr(PS, fn)) == \
            inspect.signature(getattr(JS, fn))
    assert [m for m in dir(PCAP.CaptureEngine) if not m.startswith("__")] \
        == [m for m in dir(JCAP.CaptureEngine) if not m.startswith("__")]
