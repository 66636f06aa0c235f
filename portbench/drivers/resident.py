"""Blocks already in device memory, closed loop.

The pool lives in HBM, as a capture NIC writing packets straight into GPU
memory would leave it. One ``PowerPipeline`` takes each block through
``pipe.power(x)``, which chains the PFB carry itself; each record is copied
D2H into one of ``depth`` pinned buffers of the harness, and at most
``depth`` records are in flight. A record that has landed is kept from its
buffer by ``Stream.keep`` (a copy only when it differs from what its pool
pair already holds). A warm prefix of blocks runs the same loop before the
window.
"""

from __future__ import annotations

import collections
import time

import torch

from .. import gen, program
from ..stream import Clock, Stream, close_window
from ..trace import span


class Session:
    def __init__(self, cfg, traffic, seed, device, step, trace):
        self.device, self.trace = device, trace
        self.cuda = device.type == "cuda"
        self.depth = traffic["depth"]
        self.pool = gen.make_pool(cfg, traffic["pool_blocks"], seed, device)
        self.order = gen.orders(seed, 1, len(self.pool))[0]
        self.pipe = program.pipeline(device, cfg, self.depth, step)
        self.stream = Stream()
        self.host: list = []
        self.inflight: collections.deque = collections.deque()
        for _ in range(traffic["prefix_blocks"]):
            self._send()
        self._drain_all()
        self.stream.first_window = len(self.stream.sent)

    def _send(self) -> None:
        s = self.stream
        while len(self.inflight) >= self.depth:
            self._drain()
        i = len(s.sent)
        s.sent.append(self.order[i % len(self.order)])
        with span("step", self.trace):
            out = self.pipe.power(self.pool[s.sent[-1]])
        with span("d2h", self.trace):
            if len(self.host) < self.depth:
                buf = torch.empty(out.shape, dtype=out.dtype,
                                  pin_memory=self.cuda)
                self.host.append((buf, buf.numpy()))
            buf, view = self.host[i % self.depth]
            buf.copy_(out, non_blocking=self.cuda)
            done = None
            if self.cuda:
                done = torch.cuda.Event()
                done.record()
        self.inflight.append((view, done))

    def _drain(self) -> None:
        view, done = self.inflight.popleft()
        if done is not None:
            with span("wait", self.trace):
                done.synchronize()
        with span("keep", self.trace):
            self.stream.keep(view)
            self.stream.times.append(time.perf_counter())

    def _drain_all(self) -> None:
        while self.inflight:
            self._drain()

    @property
    def streams(self) -> list:
        return [self.stream]

    def window(self, seconds: float, clock: Clock) -> None:
        clock.open()
        end = clock.t0 + seconds
        while time.perf_counter() < end:
            self._send()
        self._drain_all()
        close_window(clock, self.streams)

    def pool_block(self, i: int) -> torch.Tensor:
        return self.pool[i]

    def close(self) -> None:
        self.pipe = None
        self.host = []
        if self.cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


def setup(cfg, traffic, seed, device, step, trace) -> Session:
    return Session(cfg, traffic, seed, device, step, trace)
