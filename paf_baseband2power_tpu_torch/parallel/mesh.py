"""Device-mesh construction for the baseband->power pipeline.

Counterpart of ``paf_baseband2power_tpu/parallel/mesh.py``. JAX runs one
controller over a mesh of devices; PyTorch runs one rank per device, so a
mesh here lays the ranks of the process group out on named axes
(``torch.distributed.device_mesh``), row-major as JAX reshapes its device
list, and each rank computes its own shard:

  * ``time``  — the 8192-frame block axis is split into sub-blocks; each
    rank integrates its partial window and the partials are all-reduced
    over the axis's group (the reduced payload is 336 sums per block).
  * ``chunk`` — the 48 frequency chunks (336 channels) are sharded; no
    communication is needed on this axis at all, mirroring the reference's
    frequency partitioning.
  * ``beam``  — beams, the pure data-parallel axis (``make_beam_mesh``).

``init_distributed`` (``parallel/distributed.py``) starts the process
group first; collectives take ``mesh.get_group(axis)``.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

TIME_AXIS = "time"
CHUNK_AXIS = "chunk"
BEAM_AXIS = "beam"


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "parallel.distributed.init_distributed first")
    return dist.get_world_size()


def _device_type() -> str:
    # the mesh's bookkeeping device: NCCL groups live on the card; gloo
    # ranks (CPU, or several sharing one card) stage their payloads
    # through host memory
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_time: int | None = None,
              n_chunk: int | None = None) -> DeviceMesh:
    """Build a ``(time, chunk)`` mesh over the ranks of the process group.

    With no sizes given, all ranks go on the time axis (always valid:
    chunk counts are 48-divisible only for 1/2/4/8/16-way sharding, while
    the 8192-frame axis divides by any power of two).
    """
    n = _world()
    if n_time is None and n_chunk is None:
        n_time, n_chunk = n, 1
    elif n_time is None:
        n_time = n // n_chunk
    elif n_chunk is None:
        n_chunk = n // n_time
    if n_time * n_chunk != n:
        raise ValueError(f"mesh {n_time}x{n_chunk} != {n} devices")
    return init_device_mesh(_device_type(), (n_time, n_chunk),
                            mesh_dim_names=(TIME_AXIS, CHUNK_AXIS))


def make_beam_mesh(n_beam: int, n_time: int = 1,
                   n_chunk: int = 1) -> DeviceMesh:
    """Build a ``(beam, time, chunk)`` mesh.

    Beams are the pure data-parallel axis — the analogue of the
    reference's one-pipeline-per-beam deployment (beam id in the frame
    header, ``hdr.c:25``; share-nothing across nodes). No collectives ever
    cross the beam axis.
    """
    n = _world()
    if n_beam * n_time * n_chunk != n:
        raise ValueError(
            f"mesh {n_beam}x{n_time}x{n_chunk} != {n} devices")
    return init_device_mesh(_device_type(), (n_beam, n_time, n_chunk),
                            mesh_dim_names=(BEAM_AXIS, TIME_AXIS,
                                            CHUNK_AXIS))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The extent of ``axis``; 1 for an axis the mesh does not have."""
    names = mesh.mesh_dim_names
    return mesh.shape[names.index(axis)] if axis in names else 1


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (0 for an axis the mesh does not
    have)."""
    return mesh.get_local_rank(axis) if axis in mesh.mesh_dim_names else 0


def mesh_shape(mesh: DeviceMesh) -> dict:
    """``{axis: extent}``, JAX's ``mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))
