"""Multi-host (multi-process) process group, mesh and collectives.

Counterpart of ``paf_baseband2power_tpu/parallel/distributed.py``. The
reference scales across hosts by running disconnected per-node pipelines,
partitioned by the UDP addressing scheme — there is no cross-node backend
at all (SURVEY.md section 5). The JAX package forms one SPMD program over
all hosts; this package runs one rank per device under
``torch.distributed``: every rank feeds its own slice of each block, runs
the CUDA kernels on its own card, and exchanges the small partial results
over the mesh's groups.

Bootstrap is env-driven for cluster launchers, as in the JAX package:
  PAFB2P_COORDINATOR  host:port of rank 0's store
  PAFB2P_NUM_PROCS    total processes (ranks)
  PAFB2P_PROC_ID      this process's rank
  PAFB2P_LOCAL_RANK   this rank's index on its host (else ``LOCAL_RANK``,
                      else the rank): the card it drives

The backend is always the caller's choice, never switched silently:
  * ``nccl`` when every rank owns a GPU of its own (NCCL refuses two ranks
    on one card, so asking for it then is an error that says so);
  * ``gloo`` for CPU ranks, and for several ranks that share one card:
    compute stays on the card, and only the collective payloads are staged
    through host memory (``AxisGroup``).
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys

import torch
import torch.distributed as dist

from .mesh import BEAM_AXIS, CHUNK_AXIS, TIME_AXIS, axis_index, axis_size

BACKENDS = ("nccl", "gloo")


def local_rank(process_id: int | None = None) -> int:
    """This rank's index on its host: ``PAFB2P_LOCAL_RANK``, else
    ``LOCAL_RANK`` (torchrun's), else ``process_id`` (all ranks on one
    host), else 0."""
    for var in ("PAFB2P_LOCAL_RANK", "LOCAL_RANK"):
        if os.environ.get(var) is not None:
            return int(os.environ[var])
    return process_id or 0


def check_backend(backend: str, process_id: int | None = None) -> None:
    """Reject a backend the ranks cannot use, with the reason."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend '{backend}' (one of {BACKENDS})")
    if backend != "nccl":
        return
    ndev = torch.cuda.device_count() if torch.cuda.is_available() else 0
    lr = local_rank(process_id)
    if lr >= ndev:
        raise ValueError(
            f"nccl needs a GPU of its own for every rank: local rank {lr} "
            f"but {ndev} GPU(s) on this host (NCCL refuses two ranks on one "
            "card); use the gloo backend for ranks that share a card")


def init_distributed(backend: str, coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     timeout_s: float = 600.0) -> None:
    """Start the process group (idempotent).

    A single process (no coordinator, one process) needs no rendezvous: it
    gets a one-rank group on an in-memory store, so the meshes and steps
    run unchanged at world size 1.
    """
    coordinator = coordinator or os.environ.get("PAFB2P_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("PAFB2P_NUM_PROCS", "0")) or None
    if process_id is None:
        pid = os.environ.get("PAFB2P_PROC_ID")
        process_id = int(pid) if pid is not None else None
    check_backend(backend, process_id)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"the process group runs {dist.get_backend()}, "
                             f"not {backend}")
        return
    if backend == "nccl":
        torch.cuda.set_device(local_rank(process_id))
    timeout = datetime.timedelta(seconds=timeout_s)
    if num_processes in (None, 1) and coordinator is None:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)
        return
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process group needs PAFB2P_COORDINATOR, "
                         "PAFB2P_NUM_PROCS and PAFB2P_PROC_ID")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            rank=process_id, world_size=num_processes,
                            timeout=timeout)


def rank_device(platform: str) -> torch.device:
    """The device this rank computes on: the CPU, or the card of its local
    rank (ranks beyond the card count share cards, round robin; only gloo
    allows that)."""
    if platform == "cpu":
        return torch.device("cpu")
    if platform != "cuda":
        raise ValueError(f"unknown platform '{platform}'")
    return torch.device("cuda", local_rank(dist.get_rank()
                                           if dist.is_initialized() else None)
                        % torch.cuda.device_count())


def global_mesh(n_beam: int = 1, n_chunk: int | None = None):
    """Build the production global mesh over every rank in the job.

    Rank boundaries land on the (beam, time) axes: each rank drives one
    device, so the chunk axis, which the JAX package keeps inside a host,
    has extent 1 unless ``n_chunk`` asks for more (a chunk shard needs no
    collectives at all).
    """
    from .mesh import make_beam_mesh

    n = dist.get_world_size()
    if n_chunk is None:
        n_chunk = 1
    while (n // n_beam) % n_chunk:
        n_chunk //= 2
    n_time = n // (n_beam * n_chunk)
    return make_beam_mesh(n_beam, n_time, n_chunk)


def process_block_slice(mesh, nbeam_total: int, ndf_total: int,
                        nchk_total: int):
    """Which (beam, frame, chunk) range this rank's feeder should produce:
    the shard its mesh coordinates own, so assembling the global block
    needs no data movement at all."""
    def span(axis, total):
        n, i = axis_size(mesh, axis), axis_index(mesh, axis)
        if total % n:
            raise ValueError(f"{total} does not split {n} ways over the "
                             f"'{axis}' axis")
        return i * (total // n), (i + 1) * (total // n)

    return (span(BEAM_AXIS, nbeam_total), span(TIME_AXIS, ndf_total),
            span(CHUNK_AXIS, nchk_total))


class AxisGroup:
    """Collectives over one mesh axis (``mesh.get_group(axis)``): the
    ``psum``, ``psum_scatter`` and ``ppermute`` of the JAX package's
    shard bodies. Every rank on the axis must call each one. On a gloo
    group a CUDA payload goes through host memory; an axis of extent 1
    needs no collective at all."""

    def __init__(self, mesh, axis: str):
        self.size = axis_size(mesh, axis)
        self.index = axis_index(mesh, axis)
        self.group = mesh.get_group(axis) if self.size > 1 else None
        self.ranks = (dist.get_process_group_ranks(self.group)
                      if self.group is not None else [])
        self.staged = (self.group is not None
                       and dist.get_backend(self.group) != "nccl")

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        return t.cpu() if self.staged else t

    def _bytes(self, t: torch.Tensor) -> torch.Tensor:
        """``t``'s bytes for a payload that is moved, not reduced (neither
        gloo nor NCCL has an int16 type)."""
        return self._wire(t).view(torch.uint8)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the axis; every rank gets the total."""
        if self.group is None:
            return t
        w = self._wire(t)
        dist.all_reduce(w, group=self.group)
        return w.to(t.device)

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the axis; rank ``i`` keeps the ``i``-th of ``size``
        equal pieces of dimension 0."""
        if self.group is None:
            return t
        w = self._wire(t)
        out = w.new_empty((w.shape[0] // self.size,) + tuple(w.shape[1:]))
        dist.reduce_scatter_tensor(out, w, group=self.group)
        return out.to(t.device)

    def shift_up(self, t: torch.Tensor | None) -> torch.Tensor | None:
        """Send ``t`` to the next rank on the axis and return what the
        previous one sent (None on the first); ``t`` has the same shape on
        every rank."""
        if self.group is None:
            return None
        w = self._bytes(t)
        ops = []
        if self.index + 1 < self.size:
            ops.append(dist.P2POp(dist.isend, w, self.ranks[self.index + 1],
                                  self.group))
        got = None
        if self.index > 0:
            got = torch.empty_like(w)
            ops.append(dist.P2POp(dist.irecv, got, self.ranks[self.index - 1],
                                  self.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return None if got is None else got.view(t.dtype).to(t.device)

    def broadcast_from_last(self, t: torch.Tensor) -> torch.Tensor:
        """The last rank's ``t`` on every rank of the axis."""
        if self.group is None:
            return t
        w = self._bytes(t)
        dist.broadcast(w, src=self.ranks[-1], group=self.group)
        return w.view(t.dtype).to(t.device)


def all_agree(flag: bool, device: torch.device) -> bool:
    """True on every rank when ``flag`` is true on every rank: the
    lockstep test of a stream whose sources may end at different blocks."""
    if dist.get_world_size() == 1:
        return flag
    dev = device if dist.get_backend() == "nccl" else torch.device("cpu")
    t = torch.tensor([int(flag)], dtype=torch.int32, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def _free_port() -> int:
    """A free TCP port on localhost (for rank 0's store)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(module: str, argv: list[str], ranks: int,
                timeout: float) -> list[tuple[int, str, str]]:
    """Run ``python -m module *argv --rank r`` for every rank ``r`` on this
    host, bootstrapped through ``PAFB2P_*`` on a free localhost port (rank
    ``r`` drives card ``r``); returns each rank's ``(returncode, stdout,
    stderr)``. Every rank still running after ``timeout`` seconds is
    killed."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    port = _free_port()
    procs = []
    for r in range(ranks):
        env = dict(os.environ, PYTHONPATH=root + os.pathsep
                   + os.environ.get("PYTHONPATH", ""),
                   PAFB2P_COORDINATOR=f"127.0.0.1:{port}",
                   PAFB2P_NUM_PROCS=str(ranks), PAFB2P_PROC_ID=str(r),
                   PAFB2P_LOCAL_RANK=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, *argv, "--rank", str(r)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]
