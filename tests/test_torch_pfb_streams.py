"""PFB pipelines sharing one card: two ``PowerPipeline``s of one PFB 1024
mode, each on its own host thread under its own CUDA stream, over
different blocks, give the records each gives alone, bit for bit (the
kernel sums its tiles in a fixed order). Both calls need partials of one
shape, so a buffer kept across calls would be written by one pipeline's
kernel between the other's kernel and its finish.

Card only (marker ``cuda``; ``python -m pytest
tests/test_torch_pfb_streams.py -m cuda --noconftest``). This file imports
nothing of JAX, so that it runs on the card.
"""

import threading

import pytest
import torch

from paf_baseband2power_tpu_torch.runtime.pipeline import PowerPipeline

NDF, NCHK, NBLOCKS = 1024, 48, 8
_WAIT_S = 300.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _blocks(seed: int, device) -> list:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return [torch.randint(-2048, 2048, (NDF, NCHK * 3584), generator=g,
                          device=device, dtype=torch.int16)
            for _ in range(NBLOCKS)]


def _records(pipe: PowerPipeline, blocks: list) -> list:
    """Every block through ``pipe`` on the current stream, then to the
    host."""
    outs = [pipe.power(b) for b in blocks]
    torch.cuda.current_stream().synchronize()
    return [o.cpu() for o in outs]


@pytest.mark.cuda
@pytest.mark.parametrize("stokes", [False, True], ids=["power", "stokes"])
def test_two_streams_give_the_records_of_each_alone(cuda_device, stokes):
    def pipe():
        return PowerPipeline(cuda_device, stokes=stokes, pfb_nfft=1024)

    data = [_blocks(seed, cuda_device) for seed in (11, 12)]
    alone = [_records(pipe(), blocks) for blocks in data]
    pipes = [pipe(), pipe()]
    for p in pipes:                     # build and load before the race
        p.warmup(NDF, NCHK)
    got: dict = {}
    errors: list = []
    start = threading.Barrier(2)

    def beam(i: int) -> None:
        try:
            stream = torch.cuda.Stream(cuda_device)
            with torch.cuda.stream(stream):
                start.wait(_WAIT_S)
                got[i] = _records(pipes[i], data[i])
        except Exception as e:          # re-raised in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=beam, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(_WAIT_S)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for i in range(2):
        assert len(got[i]) == NBLOCKS
        bad = [k for k in range(NBLOCKS)
               if not torch.equal(got[i][k], alone[i][k])]
        assert not bad, f"pipeline {i}: blocks {bad} differ from alone"
