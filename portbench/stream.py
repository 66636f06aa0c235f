"""What a driver hands back: per stream, the pool blocks it sent in order
and the records its sink received, and the window's clock readings.

A stream is one sequence of blocks with its own executor state (one beam,
one PFB carry). Block ``i`` of a stream is ``pool[sent[i]]``; a record
that is due and never came shows as ``len(records) < len(sent)``.
"""

from __future__ import annotations

import dataclasses
import time

# seconds of stream in one frame: 128 samples of 27/32 us
FRAME_SECONDS = 128 * 27 / 32 * 1e-6


def block_stream_seconds(cfg: dict) -> float:
    """Seconds of sky one block holds (0.884736 s at 8192 frames)."""
    return cfg["ndf"] * FRAME_SECONDS


@dataclasses.dataclass
class Stream:
    sent: list = dataclasses.field(default_factory=list)     # pool indices
    records: list = dataclasses.field(default_factory=list)  # host arrays
    times: list = dataclasses.field(default_factory=list)    # perf_counter
    first_window: int = 0    # index of the first block sent in the window
    intervals: list = dataclasses.field(default_factory=list)

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
