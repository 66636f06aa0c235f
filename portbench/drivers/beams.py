"""Several beams per card, closed loop, dispatched ahead.

Each beam is a ``PowerPipeline`` of its own whose ``run()`` goes on its
own host thread under its own CUDA stream, as separate per-beam processes
would. Its source yields views of a shared pool of host blocks (standing
in for a ring's filled slots), back to back in the beam's rotation; the
source does no work. Every beam first sends a warm prefix through the
same ``run()`` (its pinned slots are made at the first block); the window
opens once every beam has sent its prefix, and closes ``seconds`` later:
the sources stop, and the blocks sent in the window drain.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

from .. import gen, program
from ..stream import Clock, Stream, close_window
from ..trace import span

_WAIT_S = 600.0


class _Sink:
    def __init__(self, stream: Stream, trace: bool):
        self.stream, self.trace = stream, trace

    def write(self, row) -> None:
        with span("sink", self.trace):
            self.stream.keep(row)
            self.stream.times.append(time.perf_counter())

    def close(self) -> None:
        pass


class Session:
    def __init__(self, cfg, traffic, seed, device, step, trace):
        self.device, self.trace = device, trace
        nbeams, npool = traffic["beams"], traffic["pool_blocks"]
        self.prefix = traffic["prefix_blocks"]
        drawn = gen.make_pool(cfg, npool, seed, device)
        self.pool = [b.cpu().numpy() for b in drawn]
        del drawn
        if device.type == "cuda":
            torch.cuda.empty_cache()
        self.orders = gen.orders(seed, nbeams, npool)
        self.streams = [Stream(first_window=self.prefix)
                        for _ in range(nbeams)]
        self.pipes = [program.pipeline(device, cfg, traffic["depth"], step)
                      for _ in range(nbeams)]
        self.clock: Clock | None = None
        self.end = float("inf")
        self.errors: list = []
        self.ready = threading.Barrier(nbeams + 1)
        self.go = threading.Event()
        self.threads = [threading.Thread(target=self._beam, args=(b,),
                                         name=f"beam{b}", daemon=True)
                        for b in range(nbeams)]
        for t in self.threads:
            t.start()
        try:
            self.ready.wait(_WAIT_S)        # every beam has sent its prefix
        except threading.BrokenBarrierError:
            self._join()
            raise self._error()

    def _source(self, b: int):
        s, order = self.streams[b], self.orders[b]
        i = 0
        for _ in range(self.prefix):
            s.sent.append(order[i % len(order)])
            yield self.pool[s.sent[-1]]
            i += 1
        self.ready.wait(_WAIT_S)
        self.go.wait(_WAIT_S)
        while time.perf_counter() < self.end:
            s.sent.append(order[i % len(order)])
            yield self.pool[s.sent[-1]]
            i += 1

    def _beam(self, b: int) -> None:
        stream = (torch.cuda.Stream(self.device)
                  if self.device.type == "cuda" else None)
        ctx = (torch.cuda.stream(stream) if stream is not None
               else contextlib.nullcontext())
        try:
            with ctx:
                stats = self.pipes[b].run(self._source(b),
                                          _Sink(self.streams[b], self.trace))
            s = self.streams[b]
            # intervals between two records of blocks sent in the window
            s.intervals = list(stats.block_seconds[s.first_window + 1:])
        except Exception as e:  # re-raised in the caller's thread
            self.errors.append(e)
            self.ready.abort()
            self.go.set()

    def _error(self) -> Exception:
        if self.errors:
            return RuntimeError(f"a beam failed: {self.errors[0]!r}")
        return RuntimeError("the beams did not reach the window")

    def _join(self) -> None:
        for t in self.threads:
            t.join(_WAIT_S)
        if any(t.is_alive() for t in self.threads):
            raise RuntimeError("a beam did not finish")

    def window(self, seconds: float, clock: Clock) -> None:
        self.clock = clock
        clock.open()
        self.end = clock.t0 + seconds
        self.go.set()
        self._join()
        if self.errors:
            raise self._error()
        close_window(clock, self.streams)

    def pool_block(self, i: int) -> torch.Tensor:
        return torch.from_numpy(self.pool[i]).to(self.device)

    def close(self) -> None:
        self.pipes = []
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


def setup(cfg, traffic, seed, device, step, trace) -> Session:
    return Session(cfg, traffic, seed, device, step, trace)
