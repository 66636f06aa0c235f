"""Inputs of a run, all from ``--seed``: the pool of distinct blocks and the
order in which each stream takes them.

Blocks are Gaussian noise of the configuration's ``sample_rms`` LSB,
rounded and clipped to int16, in the wire layout ``(ndf, nchk * 3584)``.
They are drawn on the run's device with a ``torch.Generator`` there, in
slabs of frames, so a full 2.8 GB block costs a few large calls and
its float32 temporary stays small beside the program's memory.
"""

from __future__ import annotations

import random

import torch

LANES_PER_CHUNK = 3584          # int16 lanes of one 7168 B chunk-frame
_SLAB_FRAMES = 256       # 176 MB of float32 at 48 chunks


def block_shape(cfg: dict) -> tuple[int, int]:
    return cfg["ndf"], cfg["nchk"] * LANES_PER_CHUNK


def seed_generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    return g


def make_pool(cfg: dict, nblocks: int, seed: int,
              device: torch.device) -> list[torch.Tensor]:
    """``nblocks`` distinct int16 blocks on ``device``."""
    g = seed_generator(seed, device)
    shape = block_shape(cfg)
    rms = float(cfg["sample_rms"])
    pool = []
    for _ in range(nblocks):
        b = torch.empty(shape, dtype=torch.int16, device=device)
        for f0 in range(0, shape[0], _SLAB_FRAMES):
            rows = b[f0:f0 + _SLAB_FRAMES]
            x = torch.randn(rows.shape, generator=g, device=device)
            rows.copy_(x.mul_(rms).round_().clamp_(-32768, 32767))
            del x
        pool.append(b)
    return pool


def orders(seed: int, nstreams: int, npool: int) -> list[list[int]]:
    """Each stream's rotation of the pool: one permutation drawn from the
    seed, stream ``s`` starting ``s`` places further on. Stream ``s``
    takes pool block ``order[s][i % npool]`` as its ``i``-th block."""
    perm = list(range(npool))
    random.Random(seed).shuffle(perm)
    return [[perm[(s + i) % npool] for i in range(npool)]
            for s in range(nstreams)]
