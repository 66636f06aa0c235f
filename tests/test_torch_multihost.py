"""The port's multi-rank runtime (``runtime/multihost.py``,
``runtime/multibeam.py``, ``cli/paf_multihost.py``) held against the JAX
package's single-process runner on the same global blocks.

``paf_multihost --platform cpu`` runs in two gloo processes (PAFB2P_*
bootstrap, a TCP port probed free in a range no other test file uses);
rank 0's records are compared with the records of the JAX package's
``MultihostRunner`` on its virtual CPU mesh, fed by its own synthetic
feeder (the same seeds). Tolerances: power and Stokes bit-equal to
``ops/golden.py`` and within 1e-6 relative of JAX; the PFB within 2e-5
peak-normalized of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import uuid

import numpy as np
import pytest
import torch

from paf_baseband2power_tpu import constants as C
from paf_baseband2power_tpu.ops import golden as G
from paf_baseband2power_tpu.runtime import multihost as JMH
from paf_baseband2power_tpu.runtime.pipeline import MemorySink as JSink
from paf_baseband2power_tpu_torch.io.dada import DadaFileReader
from paf_baseband2power_tpu_torch.ops import frame as F
from test_torch_parallel import free_port, rank_results

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORTS = (35000, 35999)
NDF, NCHK, NBLOCKS = 64, 8, 3
BOUND_PFB = 2e-5


def launch(rank: int, nprocs: int, port: int, args, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1",
               PAFB2P_COORDINATOR=f"127.0.0.1:{port}",
               PAFB2P_NUM_PROCS=str(nprocs), PAFB2P_PROC_ID=str(rank))
    return subprocess.Popen(
        [sys.executable, "-m", "paf_baseband2power_tpu_torch.cli.paf_multihost",
         *args, "-c", str(tmp_path), "--platform", "cpu", "--stats-json"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def run_ranks(args, tmp_path, nprocs=2, timeout=240):
    """Run the CLI in ``nprocs`` gloo ranks; returns each rank's stats."""
    port = free_port(*PORTS)
    procs = [launch(r, nprocs, port, args, tmp_path) for r in range(nprocs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"rc={p.returncode}\n{out}\n{err[-3000:]}"
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]


def read_records(path, nfloat):
    with DadaFileReader(path) as r:
        return [np.frombuffer(b, "<f4") for b in r.blocks(nfloat * 4)]


def jax_records(nbeam, ndf=NDF, nchk=NCHK, nblocks=NBLOCKS, **kw):
    """The JAX package's single-process runner on the same global blocks
    (rows kernels in interpret mode on the CPU mesh)."""
    runner = JMH.MultihostRunner(nbeam_total=nbeam, ndf=ndf, nchk=nchk,
                                 **kw)
    sink = JSink()
    runner.run(JMH.synthetic_local_source(runner, nblocks), sink)
    return [np.asarray(r, np.float32).reshape(-1) for r in sink.records]


def peak_err(got, want):
    return float(np.abs(got.astype(np.float64) - want).max()
                 / np.abs(want).max())


# mode: (CLI flags, nbeam, ndf, nchk, JAX runner kwargs, exact golden or None)
MODES = {
    "time_sharded_power": ([], 1, NDF, NCHK, {},
                           lambda b, i: G.baseband2power_golden(
                               F.synthetic_block(rng=1000 * b + i, ndf=NDF,
                                                 nchk=NCHK))),
    "beam_sharded_power": (["--mean"], 2, NDF, NCHK, {"mean": True},
                           lambda b, i: G.baseband2power_golden(
                               F.synthetic_block(rng=1000 * b + i, ndf=NDF,
                                                 nchk=NCHK), mean=True)),
    "stokes": (["--stokes"], 1, NDF, NCHK, {"stokes": True},
               lambda b, i: G.baseband2stokes_golden(
                   F.synthetic_block(rng=1000 * b + i, ndf=NDF, nchk=NCHK))),
    "stokes_scrunch": (["--stokes", "--nspectra", "8"], 1, NDF, NCHK,
                       {"stokes": True, "nout": 8},
                       lambda b, i: G.baseband2stokes_scrunch_golden(
                           F.synthetic_block(rng=1000 * b + i, ndf=NDF,
                                             nchk=NCHK), 8)),
    "pfb_halo_streaming": (["--pfb", "16"], 1, NDF, NCHK, {"pfb_nfft": 16},
                           None),
    "composed_spectra": (["--pfb", "16", "--stokes", "--nspectra", "2"], 1,
                         NDF, NCHK, {"pfb_nfft": 16, "stokes": True,
                                     "nout": 2}, None),
    "composed_scatter_output": (["--pfb", "16", "--stokes", "--nspectra",
                                 "8", "--scatter-output"], 1, NDF, NCHK,
                                {"pfb_nfft": 16, "stokes": True, "nout": 8,
                                 "scatter_output": True}, None),
    "device_layout_power": (["--device-layout", "--nspectra", "2"], 1, NDF,
                            NCHK, {"device_layout": True, "nout": 2},
                            lambda b, i: G.baseband2power_scrunch_golden(
                                F.synthetic_block(rng=1000 * b + i, ndf=NDF,
                                                  nchk=NCHK), 2)),
    "device_layout_pfb_streaming": (["--device-layout", "--pfb", "128",
                                     "--stokes"], 2, 32, 2,
                                    {"device_layout": True, "pfb_nfft": 128,
                                     "stokes": True}, None),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_two_ranks_match_the_jax_runner(tmp_path, mode):
    flags, nbeam, ndf, nchk, jkw, golden = MODES[mode]
    out = str(tmp_path / "out.dada")
    stats = run_ranks(["-a", f"synthetic:{NBLOCKS}", "--nbeam", str(nbeam),
                       "--ndf", str(ndf), "--nchk", str(nchk), *flags,
                       "-b", out], tmp_path)
    assert [s["nprocs"] for s in stats] == [2, 2]
    assert {s["backend"] for s in stats} == {"gloo"}
    assert all(s["nblocks"] == NBLOCKS and s["kernel_launches"] == 0
               for s in stats)
    want = jax_records(nbeam, ndf, nchk, **jkw)
    got = read_records(out, want[0].size)
    assert len(got) == len(want) == NBLOCKS * nbeam
    for k, (g, w) in enumerate(zip(got, want)):
        if golden is None:
            assert peak_err(g, w) < BOUND_PFB, f"record {k}"
            continue
        np.testing.assert_allclose(g, w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max())
        i, b = divmod(k, nbeam)
        np.testing.assert_array_equal(
            g, np.asarray(golden(b, i), np.float32).reshape(-1))


def test_stats_report_the_mesh(tmp_path):
    stats = run_ranks(["-a", "synthetic:1", "--nbeam", "2", "--ndf", "16",
                       "--nchk", "2"], tmp_path)
    assert [s["process"] for s in stats] == [0, 1]
    assert all(s["mesh"] == {"beam": 2, "time": 1, "chunk": 1}
               for s in stats)
    assert all(s["device"] == "cpu" and s["launches"] == {} for s in stats)


@pytest.mark.parametrize("layout", ["wire", "rows"])
def test_recordings_feed_each_rank_its_slice(tmp_path, layout):
    """``-a`` recordings (one per beam): each rank reads only its bytes of
    each block; the records equal the synthetic feeder's."""
    from paf_baseband2power_tpu_torch.cli import paf_gen

    path = str(tmp_path / "in.dada")
    extra = ["--device-layout"] if layout == "rows" else []
    paf_gen.main(["-o", path, "-n", "2", "--ndf", "32", "--nchk", "4",
                  *extra])
    outs = {}
    for src in (f"{path},{path}", "synthetic:2"):
        out = str(tmp_path / f"out-{len(outs)}.dada")
        run_ranks(["-a", src, "--nbeam", "2", "--ndf", "32", "--nchk", "4",
                   "--nspectra", "2", *extra, "-b", out], tmp_path, nprocs=4)
        outs[src] = read_records(out, 2 * 4 * C.NCHAN_CHK)
    files, synth = outs.values()
    assert len(files) == len(synth) == 4
    # beam 0 of the synthetic feeder is the recording (seed 0 + block)
    for i in range(2):
        np.testing.assert_array_equal(files[2 * i], synth[2 * i])
        np.testing.assert_array_equal(files[2 * i + 1], synth[2 * i])


def test_ring_fed_ranks(tmp_path):
    """Each rank feeds its half of every block's frames from a ring of its
    own; records equal the golden."""
    from paf_baseband2power_tpu_torch.io import ringbuffer as rb
    from paf_baseband2power_tpu_torch.io.dada import baseband_header

    ndf_local = NDF // 2
    keys = [uuid.uuid4().hex[:8] for _ in range(2)]
    try:
        for rank, key in enumerate(keys):
            rb.create(key, ndf_local * NCHK * C.DT_SIZE, NBLOCKS + 1)
            ring = rb.RingBuffer(key)
            ring.lock_write()
            ring.write_header(baseband_header(nchan=NCHK * C.NCHAN_CHK))
            for i in range(NBLOCKS):
                blk = F.synthetic_block(rng=i, ndf=NDF, nchk=NCHK)
                local = blk.reshape(NDF, -1)[rank * ndf_local:
                                              (rank + 1) * ndf_local]
                view = ring.open_block_write()
                view[:] = np.frombuffer(local.tobytes(), np.uint8)
                ring.close_block_write()
            ring.set_eod()
            ring.unlock_write()
            ring.disconnect()
        out = str(tmp_path / "power.dada")
        port = free_port(*PORTS)
        procs = [launch(r, 2, port, ["-a", f"ring:{keys[r]}", "--ndf",
                                     str(NDF), "--nchk", str(NCHK),
                                     *(["-b", out] if r == 0 else [])],
                        tmp_path) for r in range(2)]
        for p in procs:
            o, e = p.communicate(timeout=240)
            assert p.returncode == 0, f"{o}\n{e}"
        recs = read_records(out, NCHK * C.NCHAN_CHK)
        assert len(recs) == NBLOCKS
        for i, rec in enumerate(recs):
            np.testing.assert_array_equal(rec, G.baseband2power_golden(
                F.synthetic_block(rng=i, ndf=NDF, nchk=NCHK)))
    finally:
        for key in keys:
            if rb.exists(key):
                rb.destroy(key)


# --- one process: MultihostRunner and run_multibeam in gloo ranks -------------

def rank_main(rank: int, world: int, port: int, out: str) -> None:
    """In-process runner and multibeam checks in ``world`` gloo ranks;
    rank 0 pickles what it saw."""
    import pickle

    import torch.distributed as dist

    from paf_baseband2power_tpu_torch.parallel.mesh import make_beam_mesh
    from paf_baseband2power_tpu_torch.runtime import multihost as MH
    from paf_baseband2power_tpu_torch.runtime.multibeam import run_multibeam
    from paf_baseband2power_tpu_torch.runtime.pipeline import (
        MemorySink,
        SyntheticSource,
    )

    os.environ.update(PAFB2P_COORDINATOR=f"127.0.0.1:{port}",
                      PAFB2P_NUM_PROCS=str(world), PAFB2P_PROC_ID=str(rank))
    torch.set_num_threads(1)
    res = {}
    runner = MH.MultihostRunner(nbeam_total=2, ndf=NDF, nchk=NCHK,
                                platform="cpu", backend="gloo")
    res["local_shape"] = runner.local_shape
    try:
        runner.assemble(np.zeros((1, NDF // 2, 8), np.int16))
    except ValueError as e:
        res["shape_error"] = str(e)
    sink = MemorySink()
    stats = runner.run(MH.synthetic_local_source(runner, 2), sink)
    res["runner"] = (stats.nblocks, sink.records)
    mesh = make_beam_mesh(n_beam=2, n_time=world // 2)
    sinks = [MemorySink(), MemorySink()]
    sources = [SyntheticSource(3, ndf=16, nchk=8, seed=100 * b)
               for b in range(2)]
    stats = run_multibeam(sources, mesh, sinks, device="cpu")
    res["multibeam"] = (stats.nblocks, [s.records for s in sinks])
    try:
        run_multibeam(sources[:1], mesh, sinks[:1], device="cpu")
    except ValueError as e:
        res["multibeam_error"] = str(e)
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def _spawn(world: int, out: str, timeout: float = 240.0) -> None:
    port = free_port(*PORTS)
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "import test_torch_multihost as T; "
            "T.rank_main(int(sys.argv[3]), int(sys.argv[4]), "
            "int(sys.argv[5]), sys.argv[6])")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, REPO, os.path.join(REPO, "tests"),
         str(r), str(world), str(port), out], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, log[-3000:])
           for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
    assert not bad, f"ranks failed: {bad}"


@pytest.fixture(scope="module")
def in_process(tmp_path_factory):
    return rank_results(4, tmp_path_factory, "torch-multihost", _spawn)


def test_runner_in_ranks_matches_the_jax_runner(in_process):
    """``MultihostRunner`` used as a library in 4 ranks (2 beams x 2 time
    shards) against the JAX runner (the JAX test's single-process case)."""
    assert in_process["local_shape"] == (1, NDF // 2, NCHK * C.DT_SIZE // 2)
    nblocks, records = in_process["runner"]
    want = jax_records(2, nblocks=2)
    assert nblocks == 2 and len(records) == len(want) == 4
    for k, (g, w) in enumerate(zip(records, want)):
        i, b = divmod(k, 2)
        np.testing.assert_allclose(g, w, rtol=1e-6)
        np.testing.assert_array_equal(g, G.baseband2power_golden(
            F.synthetic_block(rng=1000 * b + i, ndf=NDF, nchk=NCHK)))


def test_runner_rejects_a_wrong_slice(in_process):
    runner = JMH.MultihostRunner(nbeam_total=1, ndf=NDF, nchk=NCHK)
    with pytest.raises(ValueError):
        runner.assemble(np.zeros((1, NDF // 2, 8), np.int16))
    assert in_process["shape_error"].startswith("local block (1, 32, 8) != "
                                                "owned slice")


def test_run_multibeam_matches_the_jax_runtime(in_process):
    """Per-beam sinks on a (beam 2, time 2) mesh of ranks, against the JAX
    package's ``run_multibeam`` on the same sources."""
    from paf_baseband2power_tpu.parallel.mesh import make_beam_mesh
    from paf_baseband2power_tpu.runtime import pipeline as RP
    from paf_baseband2power_tpu.runtime.multibeam import run_multibeam

    import jax

    nblocks, records = in_process["multibeam"]
    jsinks = [RP.MemorySink(), RP.MemorySink()]
    run_multibeam([RP.SyntheticSource(3, ndf=16, nchk=8, seed=100 * b)
                   for b in range(2)],
                  make_beam_mesh(2, 2, 1, devices=jax.devices()[:4]), jsinks)
    assert nblocks == 3
    for b in range(2):
        assert len(records[b]) == len(jsinks[b].records) == 3
        for i, (g, w) in enumerate(zip(records[b], jsinks[b].records)):
            np.testing.assert_allclose(g, w, rtol=1e-6)
            np.testing.assert_array_equal(g, G.baseband2power_golden(
                F.synthetic_block(rng=100 * b + i, ndf=16, nchk=8)))
    assert in_process["multibeam_error"] == "1 sources != mesh beam axis 2"


def test_cuda_platform_exits_2_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --platform cuda would run")
    r = subprocess.run(
        [sys.executable, "-m", "paf_baseband2power_tpu_torch.cli.paf_multihost",
         "-a", "synthetic:1"], env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 2 and "no CUDA device" in r.stderr
    assert r.stdout == ""


def test_nccl_needs_the_cuda_platform(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "paf_baseband2power_tpu_torch.cli.paf_multihost",
         "-a", "synthetic:1", "--platform", "cpu", "--dist-backend", "nccl"],
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=120)
    assert r.returncode == 2 and "needs --platform cuda" in r.stderr
