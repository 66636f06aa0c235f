"""Recurring host blocks read in place (``runtime/host_register.py``).

On the CPU: the registry's rule, with ``cudaHostRegister`` and
``cudaHostUnregister`` replaced by fakes. On a card (marker ``cuda``;
``python -m pytest tests/test_torch_host_register.py -m cuda --noconftest``):
the executor's direct H2D against the golden. This file imports nothing of
JAX, so that it runs on the card.
"""

import mmap
import sys
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from paf_baseband2power_tpu_torch.cli import paf_gen
from paf_baseband2power_tpu_torch.ops.frame import synthetic_block
from paf_baseband2power_tpu_torch.ops.golden import baseband2power_golden
from paf_baseband2power_tpu_torch.runtime import host_register as HR
from paf_baseband2power_tpu_torch.runtime import pipeline as RP

SHAPE = (16, 64)


class _Cuda:
    """Fake ``register``/``unregister``: each call recorded, a registration
    granted unless ``grant`` is false, ``delay`` seconds long."""

    def __init__(self, grant=True, delay=0.0):
        self.grant, self.delay = grant, delay
        self.registered: list = []
        self.unregistered: list = []
        self._lock = threading.Lock()

    def register(self, ptr, nbytes):
        time.sleep(self.delay)
        with self._lock:
            self.registered.append((ptr, nbytes))
        return self.grant

    def unregister(self, ptr):
        with self._lock:
            self.unregistered.append(ptr)

    def registry(self) -> HR.HostRegistry:
        return HR.HostRegistry(self.register, self.unregister)


def _ptr(a: np.ndarray) -> int:
    return a.__array_interface__["data"][0]


def test_fresh_array_per_block_never_registers():
    """A new array per block (a generator, a file's bytes) never recurs,
    even when the allocator hands a dead array's address to the next."""
    cuda = _Cuda()
    reg = cuda.registry()
    for i in range(12):
        assert reg.take(np.full(SHAPE, i, np.int16)) is None
    raw = np.full(SHAPE, 3, np.int16).tobytes()
    view = np.frombuffer(raw, np.int16).reshape(SHAPE)   # owner: bytes
    for _ in range(3):
        assert reg.take(view) is None
    assert cuda.registered == [] and not reg._entries


def _read_only() -> np.ndarray:
    a = np.zeros(SHAPE, np.int16)
    a.flags.writeable = False
    return a


@pytest.mark.parametrize("block", [
    np.zeros(SHAPE, np.float32).view(np.int16)[:, :SHAPE[1]],  # not contiguous
    np.zeros(SHAPE, ">i2"),                                    # byte-swapped
    np.zeros(SHAPE, np.int32),
    _read_only(),
])
def test_only_contiguous_int16_is_read_in_place(block):
    cuda = _Cuda()
    reg = cuda.registry()
    for _ in range(3):
        assert reg.take(block) is None
    assert cuda.registered == []


def _mmap_block():
    m = mmap.mmap(-1, 2 * np.prod(SHAPE))
    return np.frombuffer(m, np.int16).reshape(SHAPE), m


@pytest.mark.parametrize("make, engages", [
    (lambda: (np.ones(SHAPE, np.int16),) * 2, True),
    (lambda: (lambda t: (t.numpy(), t))(torch.ones(SHAPE, dtype=torch.int16)),
     True),
    (_mmap_block, False),            # unmaps before its weak references go
    (lambda: (lambda b: (np.frombuffer(b, np.int16).reshape(SHAPE), b))(
        bytearray(2 * np.prod(SHAPE))), False),   # takes no weak reference
], ids=["ndarray", "tensor", "mmap", "bytearray"])
def test_owner_must_free_its_memory_after_its_weak_references(make, engages):
    """Read in place only what the owner's weak reference can unregister
    before the memory goes: a numpy array that owns it, or a tensor."""
    cuda = _Cuda()
    reg = cuda.registry()
    block, owner = make()
    got = [reg.take(block) is not None for _ in range(3)]
    assert got == [False, engages, engages]
    assert len(cuda.registered) == int(engages)
    del block, owner
    assert len(cuda.unregistered) == int(engages) and not reg._entries


def test_same_array_registers_on_its_second_sighting():
    cuda = _Cuda()
    reg = cuda.registry()
    pool = np.arange(np.prod(SHAPE), dtype=np.int16).reshape(SHAPE)
    assert reg.take(pool) is None                    # first sighting: copy
    got = [reg.take(pool) for _ in range(3)]
    assert cuda.registered == [(_ptr(pool), pool.nbytes)]
    for t in got:
        assert t.data_ptr() == _ptr(pool) and t.shape == SHAPE
        assert torch.equal(t, torch.from_numpy(pool))
    # a view of the same memory under the same owner is the same block
    rows = pool.reshape(4, 4, 64)
    t = reg.take(rows)
    assert t.shape == rows.shape and t.data_ptr() == _ptr(pool)
    assert len(cuda.registered) == 1


def test_registers_once_across_pipelines_on_threads():
    """Eight beams on eight threads cycle one pool of three blocks, with a
    short switch interval and a slow registration: each block is
    registered once, and unregistered once, when it dies."""
    cuda = _Cuda(delay=0.01)
    reg = cuda.registry()
    pool = [np.full(SHAPE, i, np.int16) for i in range(3)]
    ptrs = sorted(_ptr(p) for p in pool)
    used = set()                      # the pool blocks read in place
    errors = []

    def beam(b):
        try:
            for i in range(30):
                block = pool[(b + i) % 3]
                t = reg.take(block)
                if t is not None:
                    assert t.data_ptr() == _ptr(block)
                    used.add((b + i) % 3)
        except Exception as e:        # re-raised in the test's thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=beam, args=(b,))
                   for b in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    assert sorted(cuda.registered) == sorted((_ptr(p), p.nbytes)
                                             for p in pool)
    assert used == {0, 1, 2} and cuda.unregistered == []
    del pool
    assert sorted(cuda.unregistered) == ptrs and not reg._entries


def test_refused_registration_copies_and_is_not_retried():
    cuda = _Cuda(grant=False)
    reg = cuda.registry()
    pool = np.ones(SHAPE, np.int16)
    for _ in range(6):
        assert reg.take(pool) is None
    assert len(cuda.registered) == 1
    del pool
    assert cuda.unregistered == [] and not reg._entries


def test_unregistered_when_its_owner_dies():
    """The registry holds no owner: the owner's death unregisters its
    memory, before the memory is freed."""
    cuda = _Cuda()
    reg = cuda.registry()
    pool = np.ones(SHAPE, np.int16)
    ptr, alive = _ptr(pool), weakref.ref(pool)
    assert reg.take(pool) is None
    t = reg.take(pool)
    assert t is not None and cuda.unregistered == []
    del t                             # the tensor holds the block
    assert alive() is not None
    del pool
    assert alive() is None and cuda.unregistered == [ptr]
    assert not reg._entries


def test_registration_lasts_as_long_as_its_owner():
    """Run after run over the same block: registered once, read in place
    from each run's first sighting on, never unregistered while it lives."""
    cuda = _Cuda()
    reg = cuda.registry()
    pool = np.ones(SHAPE, np.int16)
    got = [reg.take(pool) is not None for _ in range(3) for _ in range(2)]
    assert got == [False] + [True] * 5
    assert len(cuda.registered) == 1 and cuda.unregistered == []


def test_seen_owner_forgotten_when_it_dies():
    cuda = _Cuda()
    reg = cuda.registry()
    block = np.ones(SHAPE, np.int16)
    reg.take(block)
    assert len(reg._entries) == 1
    del block
    assert not reg._entries and cuda.unregistered == []


def test_cpu_pipeline_never_asks_the_registry(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CPU path consulted the registry")

    monkeypatch.setattr(HR.HostRegistry, "take", refuse)
    pool = [np.ascontiguousarray(
        synthetic_block(rng=i, ndf=16, nchk=2).reshape(16, -1))
        for i in range(2)]
    sink = RP.MemorySink()
    stats = RP.PowerPipeline("cpu").run([pool[i % 2] for i in range(5)],
                                        sink)
    assert stats.nblocks == 5 and stats.direct_h2d == 0
    for i, rec in enumerate(sink.records):
        np.testing.assert_array_equal(
            rec, baseband2power_golden(synthetic_block(rng=i % 2, ndf=16,
                                                       nchk=2)))


# --- on the card ----------------------------------------------------------

NDF, NCHK = 256, 48


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _block(seed: int) -> np.ndarray:
    return synthetic_block(rng=seed, ndf=NDF, nchk=NCHK).reshape(NDF, -1)


def _golden(seed: int) -> np.ndarray:
    return baseband2power_golden(synthetic_block(rng=seed, ndf=NDF,
                                                 nchk=NCHK))


def _run(device, source) -> tuple[RP.PipelineStats, list]:
    sink = RP.MemorySink()
    stats = RP.PowerPipeline(device, depth=2).run(source, sink)
    return stats, sink.records


@pytest.mark.cuda
def test_reused_buffer_overwritten_in_next_is_bit_equal(cuda_device):
    """The source overwrites its one buffer as soon as it is asked for the
    next block: the H2D from that buffer must have finished by then."""
    buf = np.empty((NDF, NCHK * 3584), np.int16)

    def source():
        for i in range(6):
            np.copyto(buf, _block(70 + i))
            yield buf

    stats, recs = _run(cuda_device, source())
    assert stats.nblocks == 6 and stats.direct_h2d == 5
    for i, rec in enumerate(recs):
        np.testing.assert_array_equal(rec, _golden(70 + i))


@pytest.mark.cuda
def test_cycling_pool_goes_direct_after_its_first_sightings(cuda_device):
    pool = [_block(80 + i) for i in range(3)]
    stats, recs = _run(cuda_device, (pool[i % 3] for i in range(8)))
    assert stats.nblocks == 8 and stats.direct_h2d == 5
    for i, rec in enumerate(recs):
        np.testing.assert_array_equal(rec, _golden(80 + i % 3))


@pytest.mark.cuda
def test_registration_outlives_the_run(cuda_device):
    """A second run over the same pool reads every block in place; the
    pool's death unregisters it."""
    pool = [_block(85 + i) for i in range(3)]
    first, _ = _run(cuda_device, (pool[i % 3] for i in range(4)))
    stats, recs = _run(cuda_device, (pool[i % 3] for i in range(4)))
    assert (first.direct_h2d, stats.direct_h2d) == (1, 4)
    for i, rec in enumerate(recs):
        np.testing.assert_array_equal(rec, _golden(85 + i % 3))
    n = len(HR.HOST_REGISTRY._entries)
    del pool
    assert len(HR.HOST_REGISTRY._entries) == n - 3


@pytest.mark.cuda
def test_file_source_copies_every_block(cuda_device, tmp_path):
    path = tmp_path / "bb.dada"
    assert paf_gen.main(["-o", str(path), "-n", "3", "--ndf", str(NDF),
                         "--nchk", str(NCHK), "--seed", "90"]) == 0
    stats, recs = _run(cuda_device, RP.FileSource(str(path), ndf=NDF,
                                                  nchk=NCHK))
    assert stats.nblocks == 3 and stats.direct_h2d == 0
    for i, rec in enumerate(recs):
        np.testing.assert_array_equal(rec, _golden(90 + i))
