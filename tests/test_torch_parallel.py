"""The port's multi-device steps (``paf_baseband2power_tpu_torch/parallel``)
held against the JAX package's ``shard_map`` steps.

Every factory runs in gloo ranks on the CPU, one process per rank, world
sizes 2 and 4; each rank takes its shard of the same numpy blocks (made
from a seed) and rank 0 gathers the global output. The JAX step runs the
same blocks on the virtual CPU mesh of ``tests/conftest.py`` (its rows
kernels in interpret mode), on a mesh of the same shape. Tolerances:
power and Stokes bit-equal to ``ops/golden.py`` and within 1e-6 relative
of JAX; the PFB within 2e-5 peak-normalized of JAX and of the float64
golden (``ops/pfb.py:pfb_*_golden``). Validation errors carry JAX's
messages.

One process group per world size runs every case of that size (a module
fixture); under xdist the first worker to need it runs it and the others
read its results.
"""

from __future__ import annotations

import fcntl
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paf_baseband2power_tpu.ops import golden as G
from paf_baseband2power_tpu.ops import pfb as JPF
from paf_baseband2power_tpu.parallel import distributed as JD
from paf_baseband2power_tpu.parallel import mesh as JM
from paf_baseband2power_tpu.parallel import sharded as JS
from paf_baseband2power_tpu_torch.ops import frame as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORTS = (34000, 34999)     # TCP ports of these ranks' stores
BOUND_PFB = 2e-5
NFFT, NTAP = 32, 4


def free_port(lo: int = PORTS[0], hi: int = PORTS[1]) -> int:
    """A free TCP port in ``[lo, hi]``, the search started at an offset
    of this xdist worker's so workers seldom probe the same port."""
    worker = os.environ.get("PYTEST_XDIST_WORKER", "gw0")
    start = lo + 97 * int(worker[2:] or 0) + os.getpid() % 50
    for i in range(hi - lo + 1):
        port = lo + (start - lo + i) % (hi - lo + 1)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    raise RuntimeError(f"no free TCP port in {lo}..{hi}")


# --- the cases ----------------------------------------------------------------
# name: (world, mesh, factory, kwargs, data, nblocks, golden)
#   mesh ("tc", n_time, n_chunk) or ("btc", n_beam, n_time, n_chunk)
#   data (kind, seed, ndf, nchk, nbeam): block6 / wire / rows for one beam,
#        beams6 / beams2d / beamrows stacked
#   nblocks > 1: a streaming step over that many blocks
#   golden(blocks6) -> the expected global output per block, from the
#        float64 golden models (blocks6: per block, the 6-D block or the
#        stack of beams' 6-D blocks)

def _each_beam(fn):
    return lambda blocks: [np.stack([fn(b) for b in blk]) for blk in blocks]


def _concat_spectra(nout, **kw):
    """Golden waterfall of the concatenated stream, split per block."""
    def ref(blocks):
        both = np.concatenate(blocks, axis=0)
        want = JPF.pfb_spectra_golden(both, kw.pop("nfft", NFFT), NTAP,
                                      nout=nout * len(blocks), **kw)
        return list(np.split(want, len(blocks)))
    return ref


def _concat_spectra_beams(nfft, nout, **kw):
    def ref(blocks):
        nbeam = blocks[0].shape[0]
        per_beam = [np.split(JPF.pfb_spectra_golden(
            np.concatenate([blk[b] for blk in blocks], axis=0), nfft, NTAP,
            nout=nout * len(blocks), **kw), len(blocks))
            for b in range(nbeam)]
        return [np.stack([per_beam[b][i] for b in range(nbeam)])
                for i in range(len(blocks))]
    return ref


CASES = {
    # world 2
    "power_time": (2, ("tc", 2, 1), "make_sharded_power_step", {},
                   ("block6", 21, 64, 4, 1), 1,
                   lambda bs: [G.baseband2power_golden(b) for b in bs]),
    "scrunch_time": (2, ("tc", 2, 1), "make_sharded_scrunch_step",
                     {"nout": 4}, ("wire", 81, 32, 4, 1), 1,
                     lambda bs: [G.baseband2power_scrunch_golden(b, 4)
                                 for b in bs]),
    "multibeam_power": (2, ("btc", 2, 1, 1), "make_multibeam_power_step",
                        {}, ("beams6", 60, 16, 4, 2), 1,
                        _each_beam(G.baseband2power_golden)),
    "pfb_stream_time": (2, ("tc", 2, 1), "make_sharded_pfb_step",
                        {"nfft": NFFT, "ntap": NTAP, "streaming": True},
                        ("block6", 100, 64, 2, 1), 3, None),
    "pfb_torch_route": (2, ("tc", 2, 1), "make_sharded_pfb_step",
                        {"nfft": 48, "ntap": NTAP, "mean": True},
                        ("block6", 43, 48, 2, 1), 1,
                        lambda bs: [JPF.pfb_power_golden(b, 48, NTAP,
                                                         mean=True)
                                    for b in bs]),
    "spectra_straddle": (2, ("tc", 2, 1), "make_sharded_spectra_step",
                         {"nfft": NFFT, "ntap": NTAP, "nout": 3},
                         ("block6", 44, 48, 2, 1), 1,
                         lambda bs: [JPF.pfb_spectra_golden(
                             b, NFFT, NTAP, nout=3) for b in bs]),
    "spectra_stream_mean": (2, ("tc", 2, 1), "make_sharded_spectra_step",
                            {"nfft": NFFT, "ntap": NTAP, "nout": 2,
                             "stokes": True, "mean": True,
                             "streaming": True},
                            ("block6", 130, 64, 2, 1), 3,
                            _concat_spectra(2, stokes=True, mean=True)),
    "spectra_scatter": (2, ("tc", 2, 1), "make_sharded_spectra_step",
                        {"nfft": NFFT, "ntap": NTAP, "nout": 4,
                         "stokes": True, "mean": True,
                         "scatter_output": True},
                        ("block6", 41, 64, 2, 1), 1,
                        lambda bs: [JPF.pfb_spectra_golden(
                            b, NFFT, NTAP, nout=4, stokes=True, mean=True)
                            for b in bs]),
    "spectra_scatter_stream": (2, ("tc", 2, 1), "make_sharded_spectra_step",
                               {"nfft": NFFT, "ntap": NTAP, "nout": 4,
                                "streaming": True, "scatter_output": True},
                               ("block6", 200, 64, 2, 1), 3,
                               _concat_spectra(4)),
    "rows_power": (2, ("tc", 1, 2), "make_sharded_rows_step", {"nout": 4},
                   ("rows", 90, 32, 4, 1), 1,
                   lambda bs: [G.baseband2power_scrunch_golden(b, 4)
                               for b in bs]),
    "rows_stokes_mean": (2, ("tc", 1, 2), "make_sharded_rows_step",
                         {"nout": 2, "stokes": True, "mean": True},
                         ("rows", 91, 32, 4, 1), 1,
                         lambda bs: [G.baseband2stokes_scrunch_golden(
                             b, 2, mean=True) for b in bs]),
    "rows_pfb_stream": (2, ("tc", 1, 2), "make_sharded_rows_step",
                        {"nfft": 128, "nout": 2, "streaming": True},
                        ("rows", 180, 32, 4, 1), 3,
                        _concat_spectra(2, nfft=128)),
    # world 4
    "power_2d_mean": (4, ("tc", 2, 2), "make_sharded_power_step",
                      {"mean": True}, ("block6", 21, 64, 4, 1), 1,
                      lambda bs: [G.baseband2power_golden(b, mean=True)
                                  for b in bs]),
    "power_chunk": (4, ("tc", 1, 4), "make_sharded_power_step", {},
                    ("block6", 22, 32, 4, 1), 1,
                    lambda bs: [G.baseband2power_golden(b) for b in bs]),
    "stokes_2d": (4, ("tc", 2, 2), "make_sharded_stokes_step", {},
                  ("wire", 80, 16, 4, 1), 1,
                  lambda bs: [G.baseband2stokes_golden(b) for b in bs]),
    "stokes_time_mean": (4, ("tc", 4, 1), "make_sharded_stokes_step",
                         {"mean": True}, ("wire", 82, 16, 2, 1), 1,
                         lambda bs: [G.baseband2stokes_golden(b, mean=True)
                                     for b in bs]),
    "stokes_scrunch_mean": (4, ("tc", 2, 2),
                            "make_sharded_stokes_scrunch_step",
                            {"nout": 4, "mean": True},
                            ("wire", 55, 32, 4, 1), 1,
                            lambda bs: [G.baseband2stokes_scrunch_golden(
                                b, 4, mean=True) for b in bs]),
    "pfb_2d_mean": (4, ("tc", 2, 2), "make_sharded_pfb_step",
                    {"nfft": NFFT, "ntap": NTAP, "mean": True},
                    ("block6", 41, 64, 4, 1), 1,
                    lambda bs: [JPF.pfb_power_golden(b, NFFT, NTAP,
                                                     mean=True)
                                for b in bs]),
    "spectra_time_4": (4, ("tc", 4, 1), "make_sharded_spectra_step",
                       {"nfft": NFFT, "ntap": NTAP, "nout": 4},
                       ("block6", 41, 64, 2, 1), 1,
                       lambda bs: [JPF.pfb_spectra_golden(
                           b, NFFT, NTAP, nout=4) for b in bs]),
    "spectra_time_stokes_1": (4, ("tc", 4, 1), "make_sharded_spectra_step",
                              {"nfft": NFFT, "ntap": NTAP, "stokes": True},
                              ("block6", 41, 64, 2, 1), 1,
                              lambda bs: [JPF.pfb_spectra_golden(
                                  b, NFFT, NTAP, stokes=True) for b in bs]),
    "spectra_groups_over_shards": (4, ("tc", 4, 1),
                                   "make_sharded_spectra_step",
                                   {"nfft": NFFT, "ntap": NTAP, "nout": 2,
                                    "stokes": True},
                                   ("block6", 42, 64, 2, 1), 1,
                                   lambda bs: [JPF.pfb_spectra_golden(
                                       b, NFFT, NTAP, nout=2, stokes=True)
                                       for b in bs]),
    "spectra_2d_mean": (4, ("tc", 2, 2), "make_sharded_spectra_step",
                        {"nfft": NFFT, "ntap": NTAP, "nout": 4,
                         "stokes": True, "mean": True},
                        ("block6", 41, 64, 4, 1), 1,
                        lambda bs: [JPF.pfb_spectra_golden(
                            b, NFFT, NTAP, nout=4, stokes=True, mean=True)
                            for b in bs]),
    "multibeam_power_2d": (4, ("btc", 2, 1, 2),
                           "make_multibeam_power_step_2d", {},
                           ("beams2d", 70, 16, 4, 2), 1,
                           _each_beam(G.baseband2power_golden)),
    "multibeam_power_2d_mean": (4, ("btc", 2, 2, 1),
                                "make_multibeam_power_step_2d",
                                {"mean": True}, ("beams2d", 71, 16, 4, 2), 1,
                                _each_beam(lambda b: G.baseband2power_golden(
                                    b, mean=True))),
    "multibeam_pfb_stream": (4, ("btc", 2, 2, 1),
                             "make_multibeam_pfb_step_2d",
                             {"nfft": NFFT, "ntap": NTAP, "streaming": True},
                             ("beams2d", 140, 64, 2, 2), 3, None),
    "composed_stream": (4, ("btc", 2, 2, 1),
                        "make_multibeam_composed_step_2d",
                        {"nfft": NFFT, "ntap": NTAP, "nout": 2,
                         "stokes": True, "streaming": True},
                        ("beams2d", 160, 64, 2, 2), 3,
                        _concat_spectra_beams(NFFT, 2, stokes=True)),
    "composed_scatter": (4, ("btc", 2, 2, 1),
                         "make_multibeam_composed_step_2d",
                         {"nfft": NFFT, "ntap": NTAP, "nout": 4,
                          "stokes": True, "scatter_output": True},
                         ("beams2d", 210, 64, 2, 2), 1,
                         _each_beam(lambda b: JPF.pfb_spectra_golden(
                             b, NFFT, NTAP, nout=4, stokes=True))),
    "composed_stokes": (4, ("btc", 2, 2, 1),
                        "make_multibeam_composed_step_2d", {"stokes": True},
                        ("beams2d", 220, 16, 4, 2), 1,
                        _each_beam(G.baseband2stokes_golden)),
    "composed_scrunch_mean": (4, ("btc", 2, 2, 1),
                              "make_multibeam_composed_step_2d",
                              {"nout": 4, "mean": True},
                              ("beams2d", 230, 32, 4, 2), 1,
                              _each_beam(lambda b:
                                         G.baseband2power_scrunch_golden(
                                             b, 4, mean=True))),
    "multibeam_rows_power": (4, ("btc", 2, 1, 2), "make_multibeam_rows_step",
                             {"nout": 4}, ("beamrows", 85, 32, 2, 2), 1,
                             _each_beam(lambda b:
                                        G.baseband2power_scrunch_golden(b, 4))),
    "multibeam_rows_stokes": (4, ("btc", 2, 1, 2),
                              "make_multibeam_rows_step",
                              {"nout": 2, "stokes": True},
                              ("beamrows", 80, 32, 2, 2), 1,
                              _each_beam(lambda b:
                                         G.baseband2stokes_scrunch_golden(
                                             b, 2))),
    "multibeam_rows_pfb_stream": (4, ("btc", 2, 1, 2),
                                  "make_multibeam_rows_step",
                                  {"nfft": 128, "nout": 2, "stokes": True,
                                   "streaming": True},
                                  ("beamrows", 190, 32, 2, 2), 3,
                                  _concat_spectra_beams(128, 2,
                                                        stokes=True)),
}
EXACT = {"power_time", "scrunch_time", "multibeam_power", "rows_power",
         "rows_stokes_mean", "power_2d_mean", "power_chunk", "stokes_2d",
         "stokes_time_mean", "stokes_scrunch_mean", "multibeam_power_2d",
         "multibeam_power_2d_mean", "composed_stokes",
         "composed_scrunch_mean", "multibeam_rows_power",
         "multibeam_rows_stokes"}
ROWS_FACTORIES = ("make_sharded_rows_step", "make_multibeam_rows_step")

# validation: (world, mesh, factory, kwargs, data or None). With data the
# step is called on its shard (the JAX package raises while tracing).
ERRORS = {
    "scrunch_misaligned": (2, ("tc", 2, 1), "make_sharded_scrunch_step",
                           {"nout": 3}, None),
    "stokes_scrunch_misaligned": (2, ("tc", 2, 1),
                                  "make_sharded_stokes_scrunch_step",
                                  {"nout": 3}, None),
    "spectra_scatter_misaligned": (2, ("tc", 2, 1),
                                   "make_sharded_spectra_step",
                                   {"nfft": NFFT, "nout": 3,
                                    "scatter_output": True}, None),
    "composed_stream_coarse": (2, ("btc", 1, 2, 1),
                               "make_multibeam_composed_step_2d",
                               {"nout": 2, "streaming": True}, None),
    "composed_scatter_coarse": (2, ("btc", 1, 2, 1),
                                "make_multibeam_composed_step_2d",
                                {"nout": 4, "stokes": True,
                                 "scatter_output": True}, None),
    "composed_plain_power": (2, ("btc", 1, 2, 1),
                             "make_multibeam_composed_step_2d", {}, None),
    "composed_scrunch_misaligned": (2, ("btc", 1, 2, 1),
                                    "make_multibeam_composed_step_2d",
                                    {"nout": 3}, None),
    "rows_stream_coarse": (2, ("tc", 1, 2), "make_sharded_rows_step",
                           {"nout": 2, "streaming": True}, None),
    "multibeam_rows_stream_coarse": (2, ("btc", 2, 1, 1),
                                     "make_multibeam_rows_step",
                                     {"streaming": True}, None),
    "rows_partial_chunk": (2, ("tc", 1, 2), "make_sharded_rows_step", {},
                           ("rows", 92, 32, 1, 1)),
    "spectra_nout_slots": (2, ("tc", 2, 1), "make_sharded_spectra_step",
                           {"nfft": NFFT, "nout": 5},
                           ("block6", 93, 32, 2, 1)),
}


def _data(kind, seed, ndf, nchk, nbeam, nblocks):
    """Per block: (the global input, its 6-D block or stack of them)."""
    out = []
    for i in range(nblocks):
        b6 = [F.synthetic_block(rng=seed + 10 * b + i, ndf=ndf, nchk=nchk)
              for b in range(nbeam)]
        if kind == "block6":
            out.append((b6[0], b6[0]))
        elif kind == "wire":
            out.append((b6[0].reshape(ndf, -1), b6[0]))
        elif kind == "rows":
            out.append((F.block_to_rows(b6[0]), b6[0]))
        elif kind == "beams6":
            out.append((np.stack(b6), np.stack(b6)))
        elif kind == "beams2d":
            out.append((np.stack([b.reshape(ndf, -1) for b in b6]),
                        np.stack(b6)))
        elif kind == "beamrows":
            out.append((np.stack([F.block_to_rows(b) for b in b6]),
                        np.stack(b6)))
    return out


# --- the rank side (gloo, CPU) ----------------------------------------------

def _port_mesh(spec, cache):
    from paf_baseband2power_tpu_torch.parallel import mesh as M

    if spec not in cache:
        cache[spec] = (M.make_mesh(*spec[1:]) if spec[0] == "tc"
                       else M.make_beam_mesh(*spec[1:]))
    return cache[spec]


def _port_case(mesh_spec, factory, kwargs, data, nblocks, cache):
    from paf_baseband2power_tpu_torch.parallel import sharded as S

    mesh = _port_mesh(mesh_spec, cache)
    step = getattr(S, factory)(mesh, **kwargs)
    outs, h = [], None
    for x, _ in _data(*data, nblocks):
        shard = torch.from_numpy(S.shard_block(x, mesh, step.in_spec))
        if kwargs.get("streaming"):
            o, h = step(shard, h)
        else:
            o = step(shard)
        g = S.gather(o, mesh, step.out_spec)
        outs.append(None if g is None else g.numpy())
    return outs


def _slices(mesh):
    import torch.distributed as dist

    from paf_baseband2power_tpu_torch.parallel import distributed as D

    mine = D.process_block_slice(mesh, 4, 64, 8)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return every


def rank_main(rank: int, world: int, port: int, out: str) -> None:
    """One rank: every case of this world size; rank 0 pickles the
    gathered outputs and the errors' messages."""
    os.environ.update(PAFB2P_COORDINATOR=f"127.0.0.1:{port}",
                      PAFB2P_NUM_PROCS=str(world), PAFB2P_PROC_ID=str(rank))
    torch.set_num_threads(1)
    import torch.distributed as dist

    from paf_baseband2power_tpu_torch.ops import cuda_power as CP
    from paf_baseband2power_tpu_torch.parallel import distributed as D
    from paf_baseband2power_tpu_torch.parallel import mesh as M
    from paf_baseband2power_tpu_torch.parallel import sharded as S

    D.init_distributed("gloo")
    res, cache = {"cases": {}, "errors": {}}, {}
    for name, (w, mesh, factory, kw, data, nblocks, _) in CASES.items():
        if w == world:
            res["cases"][name] = _port_case(mesh, factory, kw, data,
                                            nblocks, cache)
    for name, (w, mesh, factory, kw, data) in ERRORS.items():
        if w != world:
            continue
        try:
            if data:
                _port_case(mesh, factory, kw, data, 1, cache)
            else:
                getattr(S, factory)(_port_mesh(mesh, cache), **kw)
            res["errors"][name] = None
        except ValueError as e:
            res["errors"][name] = str(e)
    for shape in ((3, 3), (world + 1, 1)):
        try:
            M.make_mesh(*shape)
        except ValueError as e:
            res["errors"][f"mesh_{shape[0]}x{shape[1]}"] = str(e)
    if world == 4:
        res["slices"] = {
            "beam2": _slices(D.global_mesh(n_beam=2)),
            "chunk2": _slices(D.global_mesh(n_beam=1, n_chunk=2)),
            "time4": _slices(D.global_mesh()),
        }
        res["mesh_shapes"] = {
            "default": M.mesh_shape(M.make_mesh()),
            "chunk2": M.mesh_shape(M.make_mesh(n_chunk=2)),
            "beam2": M.mesh_shape(D.global_mesh(n_beam=2)),
        }
    res["launches"] = dict(CP.launches)     # CPU ranks launch no kernel
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def _spawn(world: int, out: str, timeout: float = 300.0) -> None:
    port = free_port()
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "import test_torch_parallel as T; "
            "T.rank_main(int(sys.argv[3]), int(sys.argv[4]), "
            "int(sys.argv[5]), sys.argv[6])")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, REPO, os.path.join(REPO, "tests"),
         str(r), str(world), str(port), out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
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
           for r, (p, log) in enumerate(zip(procs, logs))
           if p.returncode]
    assert not bad, f"ranks failed: {bad}"


def rank_results(world: int, tmp_path_factory, stem: str, spawn):
    """The ranks' results, computed once per test run: the first xdist
    worker to get here runs them, the others wait on the lock and read."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = os.path.join(str(root), f"{stem}-w{world}.pkl")
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(path):
            spawn(world, path + ".tmp")
            os.replace(path + ".tmp", path)
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return {w: rank_results(w, tmp_path_factory, "torch-parallel", _spawn)
            for w in (2, 4)}


# --- the JAX side -------------------------------------------------------------

def _jax_mesh(spec):
    n = int(np.prod(spec[1:]))
    devices = jax.devices()[:n]
    if spec[0] == "tc":
        return JM.make_mesh(*spec[1:], devices=devices)
    return JM.make_beam_mesh(*spec[1:], devices=devices)


def _jax_case(mesh_spec, factory, kwargs, data, nblocks, in_spec):
    mesh = _jax_mesh(mesh_spec)
    kw = dict(kwargs)
    if factory in ROWS_FACTORIES:
        kw["interpret"] = True
    step = getattr(JS, factory)(mesh, **kw)
    sharding = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(*in_spec))
    outs, h = [], None
    for x, _ in _data(*data, nblocks):
        xs = jax.device_put(jnp.asarray(x), sharding)
        if kwargs.get("streaming"):
            o, h = step(xs) if h is None else step(xs, h)
        else:
            o = step(xs)
        outs.append(np.asarray(o))
    return outs


def _in_spec(factory, kwargs):
    """The port step's input spec (the JAX factory's ``in_specs``)."""
    from paf_baseband2power_tpu_torch.parallel import sharded as S

    return getattr(S, factory)(_FakeMesh(), **kwargs).in_spec


class _FakeMesh:
    """A mesh of one rank on every axis, enough to build a step's specs
    without a process group."""
    mesh_dim_names = ("beam", "time", "chunk")
    shape = (1, 1, 1)

    def get_local_rank(self, axis):
        return 0


def _peak_err(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("name", list(CASES))
def test_factory_matches_jax(ranks, name):
    world, mesh, factory, kw, data, nblocks, golden = CASES[name]
    got = ranks[world]["cases"][name]
    want = _jax_case(mesh, factory, kw, data, nblocks, _in_spec(factory, kw))
    assert len(got) == len(want) == nblocks
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        if name in EXACT:
            np.testing.assert_allclose(g, w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max())
        else:
            assert _peak_err(g, w) < BOUND_PFB
    blocks6 = [b for _, b in _data(*data, nblocks)]
    if golden is not None:
        for g, w in zip(got, golden(blocks6)):
            if name in EXACT:
                np.testing.assert_array_equal(g, np.asarray(w, np.float32))
            else:
                assert _peak_err(g, w) < BOUND_PFB
    elif "pfb" in factory:
        # power streams: the blocks' sums are the one-shot golden over the
        # concatenated series, per beam
        beams = (lambda b6: [b6]) if data[0] == "block6" else list
        total = sum(got)
        per_beam = [JPF.pfb_power_golden(
            np.concatenate([beams(b)[i] for b in blocks6], axis=0), NFFT,
            NTAP) for i in range(data[4])]
        want = per_beam[0] if data[0] == "block6" else np.stack(per_beam)
        assert _peak_err(total, want) < BOUND_PFB


@pytest.mark.parametrize("name", list(ERRORS))
def test_validation_matches_jax(ranks, name):
    world, mesh, factory, kw, data = ERRORS[name]
    got = ranks[world]["errors"][name]
    assert got is not None, f"{name}: the port raised nothing"
    with pytest.raises(ValueError) as e:
        kwj = dict(kw)
        if factory in ROWS_FACTORIES:
            kwj["interpret"] = True
        if data is None:
            getattr(JS, factory)(_jax_mesh(mesh), **kwj)
        else:
            _jax_case(mesh, factory, kw, data, 1, _in_spec(factory, kw))
    assert got == str(e.value)


@pytest.mark.parametrize("world,shape", [(2, (3, 3)), (4, (3, 3)),
                                         (2, (3, 1)), (4, (5, 1))])
def test_mesh_validation_matches_jax(ranks, world, shape):
    got = ranks[world]["errors"][f"mesh_{shape[0]}x{shape[1]}"]
    with pytest.raises(ValueError) as e:
        JM.make_mesh(*shape, devices=jax.devices()[:world])
    assert got == str(e.value)


def test_mesh_shapes(ranks):
    shapes = ranks[4]["mesh_shapes"]
    assert shapes["default"] == {"time": 4, "chunk": 1}
    assert shapes["chunk2"] == {"time": 2, "chunk": 2}
    assert shapes["beam2"] == {"beam": 2, "time": 2, "chunk": 1}
    m = JM.make_mesh(n_chunk=2, devices=jax.devices()[:4])
    assert dict(m.shape) == shapes["chunk2"]


@pytest.mark.parametrize("kind", ["beam2", "chunk2", "time4"])
def test_process_slices_tile_the_jax_slice(ranks, kind):
    """The ranks' (beam, frame, chunk) slices tile the global block, and
    their union is the single process's slice of the JAX package."""
    slices = ranks[4]["slices"][kind]
    cells = set()
    for (b0, b1), (f0, f1), (c0, c1) in slices:
        for cell in [(b, f, c) for b in range(b0, b1)
                     for f in range(f0, f1, 16) for c in range(c0, c1)]:
            cells.add(cell)
    n_beam = 2 if kind == "beam2" else 1
    jmesh = JD.global_mesh(n_beam=n_beam)
    (jb0, jb1), (jf0, jf1) = JD.process_block_slice(jmesh, 4, 64)
    assert cells == {(b, f, c) for b in range(jb0, jb1)
                     for f in range(jf0, jf1, 16) for c in range(8)}
    sizes = {(b1 - b0, f1 - f0, c1 - c0)
             for (b0, b1), (f0, f1), (c0, c1) in slices}
    assert len(sizes) == 1        # equal shards


def test_cpu_ranks_launch_no_kernel(ranks):
    assert ranks[2]["launches"] == {} and ranks[4]["launches"] == {}


@pytest.mark.parametrize("ranks", [2, 4])
def test_selfcheck_on_cpu_ranks(ranks):
    """``parallel/selfcheck.py``, the check the cards run, in gloo ranks
    on the CPU at a small size: every case agrees with the single-device
    plain version (power and Stokes bit-equal, the PFB within 2e-5)."""
    import json

    r = subprocess.run(
        [sys.executable, "-m", "paf_baseband2power_tpu_torch.parallel."
         "selfcheck", "--ranks", str(ranks), "--platform", "cpu", "--ndf",
         "64", "--nchk", "4", "--nfft", "32", "--timeout", "240"],
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    report = json.loads(r.stdout.strip().splitlines()[-1])
    assert report["ranks"] == ranks and report["backend"] == "gloo"
    assert len(report["cases"]) == 8
    assert all(c["ok"] for c in report["cases"])


def test_selfcheck_needs_a_gpu_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --platform cuda would run")
    r = subprocess.run(
        [sys.executable, "-m", "paf_baseband2power_tpu_torch.parallel."
         "selfcheck"], env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 2 and "no CUDA device" in r.stderr
