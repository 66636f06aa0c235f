"""What a driver hands back: per stream, the pool blocks it sent in order
and the records its sink received, and the window's clock readings.

A stream is one sequence of blocks with its own executor state (one beam,
one PFB carry). Block ``i`` of a stream is ``pool[sent[i]]``; a record
that is due and never came shows as ``len(records) < len(sent)``.

Records are kept by pool pair, not one by one. Record ``i`` is keyed on
``(sent[i - 1], sent[i])`` (``None`` for the first) and tested bit for bit
against the arrays already kept under that key: a match records only that
array's index, anything else is copied once as a new array of the key.
Each stream takes the pool in a fixed rotation (``gen.orders``), so a
stream has at most ``pool + 1`` keys, and the program's records are
deterministic (the PFB without float atomics, direct power in int64
sums), so a key holds one array unless the program wavers. Nothing is
lost: ``records[i]`` is bit-equal to record ``i`` whatever arrived, and
``check.compare`` judges each kept array once for every record that
points to it.
"""

from __future__ import annotations

import collections
import collections.abc
import ctypes
import dataclasses
import time

import numpy as np

# seconds of stream in one frame: 128 samples of 27/32 us
FRAME_SECONDS = 128 * 27 / 32 * 1e-6


def block_stream_seconds(cfg: dict) -> float:
    """Seconds of sky one block holds (0.884736 s at 8192 frames)."""
    return cfg["ndf"] * FRAME_SECONDS


def pair(sent: list, i: int) -> tuple:
    """The pool pair record ``i`` of a stream is due for."""
    return (sent[i - 1] if i else None, sent[i])


_memcmp = ctypes.CDLL(None).memcmp
_memcmp.restype = ctypes.c_int
_memcmp.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t)
_SMALL = 1 << 16     # bytes: below this a copy to ``bytes`` costs less


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    """Whether two arrays hold the same bytes in the same dtype and shape:
    NaN payloads and -0.0 / +0.0 count as different."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if (a.nbytes < _SMALL or not a.flags.c_contiguous
            or not b.flags.c_contiguous):
        return a.tobytes() == b.tobytes()
    return _memcmp(a.ctypes.data, b.ctypes.data, a.nbytes) == 0


class Records(collections.abc.Sequence):
    """A stream's records, each distinct array kept once per key:
    ``records[i]`` is a read-only array bit-equal to record ``i``."""

    def __init__(self):
        self.kept: dict = {}    # key -> [array]
        self.which: list = []   # record i -> (key, index in kept[key])

    def add(self, key, record) -> None:
        record = np.asarray(record)
        arrays = self.kept.setdefault(key, [])
        for j, a in enumerate(arrays):
            if same_bits(a, record):
                break
        else:
            j = len(arrays)
            a = np.array(record, copy=True, order="C")
            a.flags.writeable = False
            arrays.append(a)
        self.which.append((key, j))

    def __len__(self) -> int:
        return len(self.which)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[k] for k in range(*i.indices(len(self)))]
        key, j = self.which[i]
        return self.kept[key][j]

    def groups(self, sent: list):
        """``(pair, array, count)`` for each kept array, counting the
        records ``i < len(sent)`` that point to it: those a block was sent
        for."""
        n = collections.Counter(self.which[:len(sent)])
        for (key, j), count in n.items():
            # a record kept before its block was sent is keyed by index
            yield (pair(sent, key) if isinstance(key, int) else key,
                   self.kept[key][j], count)

    def arrays(self) -> list:
        return [a for arrays in self.kept.values() for a in arrays]


@dataclasses.dataclass
class Stream:
    sent: list = dataclasses.field(default_factory=list)     # pool indices
    records: Records = dataclasses.field(default_factory=Records)
    times: list = dataclasses.field(default_factory=list)    # perf_counter
    first_window: int = 0    # index of the first block sent in the window
    intervals: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if not isinstance(self.records, Records):
            given, self.records = self.records, Records()
            for r in given:
                self.keep(r)

    def keep(self, record) -> None:
        """Keep the stream's next record (a host array the caller may
        reuse), keyed by its pool pair."""
        i = len(self.records)
        self.records.add(pair(self.sent, i) if i < len(self.sent) else i,
                         record)

    def window_records(self) -> int:
        return max(0, len(self.records) - self.first_window)

    def last_time(self) -> float | None:
        return self.times[-1] if len(self.times) > self.first_window else None


@dataclasses.dataclass
class Clock:
    """The window's opening and close on the host clock and in unix
    nanoseconds (the profiler's clock)."""
    t0: float = 0.0
    t1: float = 0.0
    t0_ns: int = 0
    t1_ns: int = 0

    def open(self) -> None:
        self.t0, self.t0_ns = time.perf_counter(), time.time_ns()

    def close(self, last: float) -> None:
        """Close at ``last`` (a perf_counter reading: the last record)."""
        self.t1 = last
        self.t1_ns = self.t0_ns + int((last - self.t0) * 1e9)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def close_window(clock: Clock, streams: list) -> None:
    last = [s.last_time() for s in streams if s.last_time() is not None]
    clock.close(max(last) if last else time.perf_counter())
