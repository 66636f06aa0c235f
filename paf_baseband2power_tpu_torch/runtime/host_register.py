"""Host memory that the copy engines read in place: a source block whose
memory recurs is page-locked once (``cudaHostRegister``) and goes to the card
straight from the source's memory, with no copy into a pinned slot.

A block *recurs* when the same live owner comes back with the same address
and byte count; the owner is the block's root ``.base``, or the array
itself. Only C-contiguous, writeable int16 blocks whose owner is a numpy
array that owns its memory or a torch tensor are read in place: both drop
their weak references before they free their memory, so the owner's weak
reference can unregister the memory while it is still there. Any other
owner (a file's ``bytes``, which takes no weak reference; an ``mmap``, which
unmaps first) is copied, as before.

Of the port's callers, those that hand the executor the same arrays again
engage: the benchmark's pool of host blocks (``portbench``'s ``beams``
traffic) and ``bench --e2e``'s three host blocks. The port's sources make a
new array or ``bytes`` per block (``FileSource``, ``RingSource``, which
copies out of the ring, ``SyntheticSource``): their blocks never recur and
are copied.

An owner's life in the registry:

- first sighting: remembered by weak reference; the block is copied;
- second sighting: registered (span ``stage.register``); meanwhile other
  sightings copy. A refusal (memory registered elsewhere, a read-only
  mapping) marks the owner copy-only, never retried;
- later sightings: read in place, in every run, for as long as the owner
  lives;
- its death: its weak reference's callback unregisters its memory. The
  registry holds no owner, so the caller keeps a block alive until the H2D
  that reads it has finished.

CUDA page-locks memory for the whole process, so one registry,
``HOST_REGISTRY``, serves every pipeline on every thread.
"""

from __future__ import annotations

import functools
import threading
import weakref

import numpy as np
import torch

from ..ops._build import load_library
from .trace import span

_SEEN, _PENDING, _HELD, _COPY = range(4)


def _cuda_register(ptr: int, nbytes: int) -> bool:
    return load_library().pafb2p_host_register(ptr, nbytes) == 0


def _cuda_unregister(ptr: int) -> None:
    load_library().pafb2p_host_unregister(ptr)


def _owner(block: np.ndarray):
    o = block
    while isinstance(o, np.ndarray) and o.base is not None:
        o = o.base
    return o


class _Entry:
    __slots__ = ("ref", "state")

    def __init__(self, ref: weakref.ref):
        self.ref, self.state = ref, _SEEN


class HostRegistry:
    """Which recurring host blocks are page-locked. ``register(ptr, nbytes)
    -> bool`` and ``unregister(ptr)`` default to the CUDA runtime's, through
    the port's library."""

    def __init__(self, register=_cuda_register, unregister=_cuda_unregister):
        self._register, self._unregister = register, unregister
        # reentrant: an owner can die, and its callback run, on a thread
        # that holds the lock (a garbage collection inside ``take``)
        self._lock = threading.RLock()
        self._entries: dict[tuple, _Entry] = {}

    def take(self, block: np.ndarray) -> torch.Tensor | None:
        """``block`` as a tensor over its own page-locked memory; None when
        the block is to be copied."""
        flags = block.flags
        if (block.dtype != np.int16 or not flags.c_contiguous
                or not flags.writeable):
            return None
        owner = _owner(block)
        if not (isinstance(owner, torch.Tensor)
                or isinstance(owner, np.ndarray) and owner.flags.owndata):
            return None
        ptr = block.__array_interface__["data"][0]
        key = (id(owner), ptr, block.nbytes)
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self._entries[key] = _Entry(weakref.ref(
                    owner, functools.partial(self._forget, key)))
                return None
            if e.state == _HELD:
                return torch.from_numpy(block)
            if e.state != _SEEN:
                return None
            e.state = _PENDING
        ok = False
        try:
            with span("stage.register"):
                ok = self._register(ptr, block.nbytes)
        finally:
            with self._lock:
                e.state = _HELD if ok else _COPY
        return torch.from_numpy(block) if ok else None

    def _forget(self, key: tuple, ref: weakref.ref) -> None:
        # called from the owner's dealloc, before its memory is freed and
        # before anything else can take its id; never while it registers,
        # since the registering caller holds the block
        with self._lock:
            e = self._entries.get(key)
            if e is None or e.ref is not ref:
                return
            del self._entries[key]
        if e.state == _HELD:
            self._unregister(key[1])


HOST_REGISTRY = HostRegistry()
