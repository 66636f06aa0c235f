"""The port's UDP capture engine, sender, frame-header codec and time
bookkeeping on the CPU, over localhost loopback.

The port's copies are held against the JAX package's: the same frame
stream, captured once by each engine, gives byte-equal ring blocks;
``FrameHeader`` and the ``time_utils`` functions give equal results on
seeded inputs. The engine's own behaviour (placement, reordering, loss
accounting, force switch, beam filter, the ``--device-layout`` corner turn,
the native sender) is checked as ``tests/test_capture.py`` checks the JAX
engine's, and the port's ``paf_capture`` CLI feeds the port's compute
stage. Ring keys are uuids and UDP ports are probed free in a range of
their own, so the file runs beside the JAX capture tests.
"""

import datetime
import os
import socket
import subprocess
import sys
import threading
import time
import uuid

import numpy as np
import pytest

from paf_baseband2power_tpu.io import capture as JCAP
from paf_baseband2power_tpu.io import ringbuffer as JR
from paf_baseband2power_tpu.io import sender as JS
from paf_baseband2power_tpu.ops import frame as JF
from paf_baseband2power_tpu.ops import time_utils as JT
from paf_baseband2power_tpu_torch import constants as C
from paf_baseband2power_tpu_torch.cli import paf_baseband2power as cli
from paf_baseband2power_tpu_torch.io import capture as PCAP
from paf_baseband2power_tpu_torch.io import ringbuffer as rb
from paf_baseband2power_tpu_torch.io import sender as PS
from paf_baseband2power_tpu_torch.io.dada import DadaFileReader
from paf_baseband2power_tpu_torch.ops import frame as PF
from paf_baseband2power_tpu_torch.ops import power as P
from paf_baseband2power_tpu_torch.ops import time_utils as PT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NDF = 32          # frames per block
NCHK = 8          # chunks
NPORTS = 2
FREQ0 = 1000.0
PORT = dict(cap=PCAP, rb=rb, send=PS)       # the port's modules
JAX = dict(cap=JCAP, rb=JR, send=JS)        # the JAX package's


def expected_payload(k, ichk):
    """The sender's default ramp payload of global frame ``k``."""
    base = (k * 131 + ichk * 17) % 251
    return (np.arange(C.DT_SIZE // 2, dtype=np.int16) % 199) + base


def free_ports(n=NPORTS, lo=33100, hi=33900):
    """A base port with ``n`` consecutive free UDP ports (a range no other
    test file probes). The search starts in a slice of the range of this
    xdist worker's own, so that two workers never probe the same base
    while one of them has yet to bind it (an engine, or the CLI's
    process, binds only after the probe's sockets are closed)."""
    bases = range(lo, hi, 10)
    slot = int(os.environ.get("PYTEST_XDIST_WORKER", "gw0")[2:] or 0)
    first = (slot % 8) * (len(bases) // 8)
    for base in (bases[(first + i) % len(bases)] for i in range(len(bases))):
        socks = []
        try:
            for i in range(n):
                s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                s.bind(("127.0.0.1", base + i))
                socks.append(s)
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no free ports")


@pytest.fixture
def ring_key():
    key = uuid.uuid4().hex[:8]
    rb.create(key, NDF * NCHK * C.DT_SIZE, 4)
    yield key
    if rb.exists(key):
        rb.destroy(key)


def sender_kw(port_base, **kw):
    return dict(dict(host="127.0.0.1", port_base=port_base, nports=NPORTS,
                     nchk=NCHK, freq_base=FREQ0, chunk_bw=7.0, epoch=51,
                     sec0=27), **kw)


def start_engine(pkg, ring_key, port_base, probe_kw=None, **conf_kw):
    """Create ``pkg``'s engine, probe it with a repeated frame window
    (identical idfs keep the reference frame deterministic) and start it;
    returns the engine."""
    conf = pkg["cap"].CaptureConf(**dict(dict(
        ip="127.0.0.1", port_base=port_base, nports=NPORTS,
        ring_key=ring_key, ndf_blk=NDF, nchk=NCHK, freq_base=FREQ0,
        chunk_bw=7.0, tbuf_ndf=16, timeout_sec=1.5, ndf_check=NCHK * 2,
        zero_blocks=True), **conf_kw))
    eng = pkg["cap"].CaptureEngine(conf)
    kw = sender_kw(port_base, **(probe_kw or {}))
    done = threading.Event()

    def probe_feed():
        while not done.is_set():
            pkg["send"].stream_frames(**dict(kw, idf0=0, nframes=NCHK * 2,
                                             pace_sec=0.0005))

    tx = threading.Thread(target=probe_feed)
    tx.start()
    try:
        assert eng.probe() == NPORTS
    finally:
        done.set()
        tx.join()
    eng.start()
    return eng


def run_capture(ring_key, nframes, port_base, pkg=PORT, sender=None,
                **conf_kw):
    """Start ``pkg``'s engine, stream ``nframes`` frame-times from its
    reference frame on, wait for 1.5 s of silence; returns (engine, rc,
    reference idf)."""
    eng = start_engine(pkg, ring_key, port_base, **conf_kw)
    idf0 = eng.ref_idf
    pkg["send"].stream_frames(**sender_kw(port_base, idf0=idf0,
                                          nframes=nframes, pace_sec=0.0005,
                                          **(sender or {})))
    return eng, eng.wait(), idf0


def read_blocks(ring_key, ring=rb):
    blocks = []
    with ring.RingBuffer(ring_key) as r:
        r.lock_read()
        while (view := r.open_block_read(timeout_us=2_000_000)) is not None:
            blocks.append(view.copy())
            r.close_block_read()
        r.unlock_read()
    return blocks


def wire_block(bi, idf0):
    return np.stack([np.stack([expected_payload(idf0 + bi * NDF + t, c)
                               for c in range(NCHK)]) for t in range(NDF)])


# --- the engine -------------------------------------------------------------


def test_clean_stream_lands_at_every_slot(ring_key):
    eng, rc, idf0 = run_capture(ring_key, 2 * NDF, free_ports())
    assert rc == 0
    assert eng.active_ports == NPORTS and eng.active_chunks == NCHK
    assert eng.blocks_committed >= 2 and eng.force_switches == 0
    stats = eng.port_stats()
    assert [s.port for s in stats] == [stats[0].port, stats[0].port + 1]
    assert sum(s.received for s in stats) >= 2 * NDF * NCHK
    assert all(s.elapsed > 0 and s.invalid == 0 for s in stats)
    assert eng.epoch == 51 and eng.ref_sec == 27
    assert 0 < idf0 <= NCHK * 2
    assert eng.freq_center == pytest.approx(FREQ0 + 7.0 * (NCHK - 1) / 2)
    eng.close()
    blocks = read_blocks(ring_key)
    assert len(blocks) >= 2
    for bi in range(2):
        np.testing.assert_array_equal(
            blocks[bi].view("<i2").reshape(NDF, NCHK, -1),
            wire_block(bi, idf0))


def test_reordered_stream_through_temp_buffer(ring_key):
    eng, rc, idf0 = run_capture(ring_key, 2 * NDF, free_ports(),
                                sender=dict(shuffle_window=8, seed=3))
    assert rc == 0
    eng.close()
    blocks = read_blocks(ring_key)
    assert len(blocks) >= 2
    np.testing.assert_array_equal(
        blocks[0].view("<i2").reshape(NDF, NCHK, -1), wire_block(0, idf0))


@pytest.mark.parametrize("impair", ["drop", "invalid"])
def test_lossy_stream_zero_slots_and_statistics(ring_key, impair):
    """Dropped frames and frames with a cleared valid bit leave zero slots;
    the invalid ones are counted per port; every other slot is exact."""
    kw = (dict(drop_prob=0.2, seed=7) if impair == "drop"
          else dict(invalid_prob=0.25, seed=11))
    eng, rc, idf0 = run_capture(ring_key, 2 * NDF, free_ports(), sender=kw)
    assert rc == 0
    stats = eng.port_stats()
    assert sum(s.expected for s in stats) > 0
    assert (sum(s.invalid for s in stats) > 0) == (impair == "invalid")
    assert all(0.0 <= s.loss_rate <= 1.0 for s in stats)
    eng.close()
    blocks = read_blocks(ring_key)
    assert len(blocks) >= 2
    lost = 0
    for bi in range(2):
        got = blocks[bi].view("<i2").reshape(NDF, NCHK, -1)
        want = wire_block(bi, idf0)
        for t in range(NDF):
            for c in range(NCHK):
                if got[t, c, 1] == 0:     # element 1 of a payload is never 0
                    lost += 1
                    assert not got[t, c].any()
                else:
                    np.testing.assert_array_equal(got[t, c], want[t, c])
    assert 0.05 < lost / (2 * NDF * NCHK) < 0.4


def test_force_switch_is_not_fatal(ring_key):
    """A frame too far ahead for the temp buffer forces a block switch
    (``capture.c:510-524``); later frames land in the next block."""
    port_base = free_ports()
    eng = start_engine(PORT, ring_key, port_base)
    idf0 = eng.ref_idf
    send = lambda i, n: PS.stream_frames(**sender_kw(  # noqa: E731
        port_base, idf0=i, nframes=n, pace_sec=0.0005))
    send(idf0, 4)
    send(idf0 + NDF + 16 + 4, 2)          # in [ndf + tbuf, 2 ndf)
    send(idf0 + NDF, 4)
    assert eng.wait() == 0
    assert eng.force_switches >= 1 and eng.blocks_committed >= 2
    eng.close()
    blocks = read_blocks(ring_key)
    assert len(blocks) >= 2
    got = blocks[1].view("<i2").reshape(NDF, NCHK, -1)
    for t in range(2):
        np.testing.assert_array_equal(got[t], wire_block(1, idf0)[t])


def test_fall_behind_quits_and_ends_the_ring(ring_key):
    """A frame a whole extra block ahead quits the engine (wait() is 1,
    ``capture.c:491-509``) and EOD still reaches the readers."""
    port_base = free_ports()
    eng = start_engine(PORT, ring_key, port_base)
    idf0 = eng.ref_idf
    PS.stream_frames(**sender_kw(port_base, idf0=idf0, nframes=2,
                                 pace_sec=0.0005))
    PS.stream_frames(**sender_kw(port_base, idf0=idf0 + 2 * NDF + 1,
                                 nframes=1, pace_sec=0.0005))
    assert eng.wait() == 1
    eng.close()
    assert isinstance(read_blocks(ring_key), list)


def test_beam_filter_rejects_other_beams(ring_key):
    port_base = free_ports()
    eng = start_engine(PORT, ring_key, port_base, probe_kw=dict(beam=3),
                       beam=3)
    idf0 = eng.ref_idf
    for beam in (3, 5):
        PS.stream_frames(**sender_kw(port_base, idf0=idf0, nframes=NDF,
                                     beam=beam, pace_sec=0.0005))
    assert eng.wait() == 0
    assert sum(s.dropped for s in eng.port_stats()) >= NDF * NCHK
    eng.close()
    blocks = read_blocks(ring_key)
    np.testing.assert_array_equal(
        blocks[0].view("<i2").reshape(NDF, NCHK, -1), wire_block(0, idf0))


def test_device_layout_writes_series_rows(ring_key):
    """The host corner turn places each frame as 14 series segments: the
    block equals ``ops/frame.py:block_to_rows`` of the wire block."""
    eng, rc, idf0 = run_capture(ring_key, NDF, free_ports(),
                                device_layout=True)
    assert rc == 0
    eng.close()
    blocks = read_blocks(ring_key)
    want = PF.block_to_rows(wire_block(0, idf0).reshape(
        NDF, NCHK, C.NSAMP_DF, C.NCHAN_CHK, C.NPOL_SAMP, C.NDIM_POL))
    np.testing.assert_array_equal(blocks[0].view("<i2"), want.reshape(-1))


def test_native_sender_places_like_the_python_sender(ring_key):
    port_base = free_ports()
    eng = start_engine(PORT, ring_key, port_base)
    idf0 = eng.ref_idf
    sent = PS.stream_frames_native(**sender_kw(port_base, idf0=idf0,
                                               nframes=2 * NDF, rate=0.02))
    assert sent == 2 * NDF * NCHK
    assert eng.wait() == 0
    eng.close()
    blocks = read_blocks(ring_key)
    for bi in range(2):
        np.testing.assert_array_equal(
            blocks[bi].view("<i2").reshape(NDF, NCHK, -1),
            wire_block(bi, idf0))


@pytest.mark.parametrize("kw", [dict(nports=0), dict(nchk=0)])
def test_native_sender_rejects_a_bad_configuration(kw):
    with pytest.raises(OSError):
        PS.stream_frames_native(**dict(dict(nframes=1, nchk=1, nports=1),
                                       **kw))


def test_engine_rejects_a_bad_configuration():
    with pytest.raises(PCAP.CaptureError):
        PCAP.CaptureEngine(PCAP.CaptureConf(nports=0, ring_key="none"))


# --- the same stream through the JAX engine and the port's -----------------


@pytest.mark.parametrize("device_layout", [False, True])
def test_ring_blocks_equal_to_the_jax_engines(device_layout):
    """One frame stream, its payloads keyed by the frame's distance from the
    engine's reference, captured by each engine into a ring of its own
    package: byte-equal blocks."""
    def capture(pkg):
        key = uuid.uuid4().hex[:8]
        pkg["rb"].create(key, NDF * NCHK * C.DT_SIZE, 4)
        try:
            port_base = free_ports()
            eng = start_engine(pkg, key, port_base,
                               device_layout=device_layout)
            ref = eng.ref_idf
            pkg["send"].stream_frames(**sender_kw(
                port_base, idf0=ref, nframes=2 * NDF, pace_sec=0.0005,
                payload_fn=lambda idf, c: expected_payload(idf - ref, c)))
            assert eng.wait() == 0
            eng.close()
            return read_blocks(key, pkg["rb"])[:2]
        finally:
            pkg["rb"].destroy(key)

    port, jax = capture(PORT), capture(JAX)
    assert len(port) == len(jax) == 2
    for p, j in zip(port, jax):
        assert p.tobytes() == j.tobytes()


# --- the CLI: paf_capture into a ring, the compute stage reads it ----------


def test_capture_cli_feeds_the_compute_stage(tmp_path):
    """``paf_capture --create-ring --device-layout`` writes ORDER SERIES
    blocks and its header; the port's compute CLI reads that ring and its
    power records equal the plain version of the frames sent."""
    key = uuid.uuid4().hex[:8]
    port_base = free_ports()
    proc = subprocess.Popen(
        [sys.executable, "-m", "paf_baseband2power_tpu_torch.cli.paf_capture",
         "-a", key, "-c", str(NDF), "--ip", "127.0.0.1", "-p",
         str(port_base), "-n", str(NPORTS), "--nchk", str(NCHK),
         "--timeout", "1.5", "--ndf-check", str(NCHK * 2), "--tbuf-ndf", "16",
         "--create-ring", "4", "--device-layout", "-k", str(tmp_path)],
        env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        hdr = None
        deadline = time.monotonic() + 60
        while hdr is None and time.monotonic() < deadline:
            PS.stream_frames(**sender_kw(port_base, idf0=0,
                                         nframes=NCHK * 2, pace_sec=0.0005))
            if rb.exists(key):
                with rb.RingBuffer(key) as r:
                    try:
                        hdr = r.read_header(timeout_us=1000)
                    except OSError:
                        pass
        assert hdr is not None, proc.communicate(timeout=30)
        assert hdr["ORDER"] == "SERIES"
        # sec 27, epoch 51: the start's picoseconds are idf x 108 us
        idf0 = hdr.get_int("PICOSECONDS") // C.TDF_PICOSECONDS
        assert (hdr["UTC_START"], hdr.get_int("PICOSECONDS")) == \
            PT.start_time(51, 27, idf0)
        PS.stream_frames(**sender_kw(port_base, idf0=idf0, nframes=2 * NDF,
                                     pace_sec=0.0005))
        out, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err
        assert "expected" in out.splitlines()[0]
        pw = tmp_path / "pw.dada"
        assert cli.main(["-a", key, "-b", str(pw), "--ndf", str(NDF),
                         "--nchk", str(NCHK), "--platform", "cpu"]) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
        if rb.exists(key):
            rb.destroy(key)
    with DadaFileReader(str(pw)) as r:
        recs = [np.frombuffer(b, "<f4") for b in r.blocks(NCHK * 7 * 4)]
    assert len(recs) >= 2
    import torch

    for bi in range(2):
        want = P.baseband2power_2d(torch.from_numpy(
            wire_block(bi, idf0).reshape(NDF, -1))).numpy()
        np.testing.assert_array_equal(recs[bi], want)


# --- the frame-header codec and the time bookkeeping against JAX -----------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frame_header_equal_to_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        f = dict(valid=int(rng.integers(0, 2)),
                 idf=int(rng.integers(0, 2**32)),
                 sec=int(rng.integers(0, 2**30)),
                 epoch=int(rng.integers(0, 64)),
                 beam=int(rng.integers(0, 2**16)),
                 freq=float(rng.integers(0, 2**16)))
        p, j = PF.FrameHeader(**f), JF.FrameHeader(**f)
        raw = p.pack()
        assert raw == j.pack()
        assert PF.FrameHeader.unpack(raw) == p
        assert PF.FrameHeader.unpack(raw).__dict__ == \
            JF.FrameHeader.unpack(raw).__dict__
        assert PF.header_idf(raw) == JF.header_idf(raw) == f["idf"]
        assert PF.header_sec(raw) == JF.header_sec(raw) == f["sec"]
        ref = dict(idf=int(rng.integers(0, C.NDF_PRD)),
                   sec=27 * int(rng.integers(0, 100)))
        hdr = dict(idf=int(rng.integers(0, C.NDF_PRD)),
                   sec=ref["sec"] + 27 * int(rng.integers(-2, 3)))
        assert PF.frame_distance(PF.FrameHeader(**hdr),
                                 PF.FrameHeader(**ref)) == \
            JF.frame_distance(JF.FrameHeader(**hdr), JF.FrameHeader(**ref))
        n = int(rng.integers(0, 3 * C.NDF_PRD))
        assert PF.advance_ref(PF.FrameHeader(**ref), n).__dict__ == \
            JF.advance_ref(JF.FrameHeader(**ref), n).__dict__
        payload = rng.integers(-32768, 32768, PF.FRAME_PAYLOAD_SHAPE,
                               dtype=np.int16)
        frame = PF.build_frame(p, payload)
        assert frame == JF.build_frame(j, payload)
        ph, pp = PF.split_frame(frame)
        jh, jp = JF.split_frame(frame)
        assert ph.__dict__ == jh.__dict__
        np.testing.assert_array_equal(pp, jp)


def test_frame_codec_rejects_wrong_sizes():
    with pytest.raises(ValueError):
        PF.build_frame(PF.FrameHeader(), np.zeros(10, np.int16))
    with pytest.raises(ValueError):
        PF.split_frame(b"\0" * (C.DF_SIZE - 1))


@pytest.mark.parametrize("seed", [0, 1])
def test_time_utils_equal_to_jax(seed, tmp_path):
    rng = np.random.default_rng(seed)
    for epoch in rng.integers(0, 64, 20):
        assert PT.epoch_to_mjd(int(epoch)) == JT.epoch_to_mjd(int(epoch))
    for _ in range(50):
        args = (int(rng.integers(0, 64)), 27 * int(rng.integers(0, 10**6)),
                int(rng.integers(0, C.NDF_PRD)))
        assert PT.start_time(*args) == JT.start_time(*args)
        utc, ps = PT.start_time(*args)
        blk = (int(rng.integers(0, 10**4)), int(C.TINT * 10**12))
        assert PT.block_timestamp(utc, ps, *blk) == \
            JT.block_timestamp(utc, ps, *blk)
    path = tmp_path / "epoch.dat"
    path.write_text("# epoch mjd\n51544 51544.0 x\n\n60 60310.5\n")
    table = PT.load_epoch_table(str(path))
    assert table == JT.load_epoch_table(str(path)) == {51544: 51544.0,
                                                       60: 60310.5}
    assert PT.start_time(60, 27, 9260, table) == \
        JT.start_time(60, 27, 9260, table)


def test_start_time_known_points():
    """The reference's semantics (``capture.c:791-843``) in exact integer
    picoseconds: epoch 0 is 2000-01-01; 9260 frames are 1.00008 s."""
    assert PT.epoch_to_mjd(0) == 51544.0
    assert PT.start_time(0, 0, 9260) == ("2000-01-01-00:00:01", 80_000_000)
    assert PT.start_time(0, 0, C.NDF_PRD) == ("2000-01-01-00:00:27", 0)
    utc, _ = PT.start_time(51, 27, 0)
    assert datetime.datetime.strptime(utc, PT.DADA_TIMESTR).year == 2025
