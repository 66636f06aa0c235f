"""Each cell on the CPU at a tiny block through the port's plain versions:
its records equal the plain reference's, every one of them, with the PFB
carry chained across the pool's rotation."""

import numpy as np
import pytest
import torch
from _tiny import CELLS, TINY

from portbench import check, gen, run
from portbench.references import pfb as RPFB


def _run(cell, seed=2**31 + 99, traced=False, **kw):
    manifest = run.load_manifest()
    return run.run_cell(manifest, cell, seed, 0.3, traced,
                        torch.device("cpu"), cfg_override=TINY, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_records_equal_the_reference(cell):
    result, verdict = _run(cell)
    assert result["correct"], result["check"]
    assert result["failed"] == 0
    assert result["attempted"] > 3
    assert result["check"]["missing_records"]["value"] == 0


def test_pfb_records_chain_the_carry(monkeypatch):
    """The resident PFB stream, worked out block after block by the
    reference with each previous block's tail, matches what the program
    delivered; the first record (no carry) differs from a later record
    of the same block (with one)."""
    kept = {}
    orig = check.compare

    def spy(cfg, streams, pool_block):
        kept["streams"], kept["pool"] = streams, pool_block
        kept["cfg"] = cfg
        return orig(cfg, streams, pool_block)

    monkeypatch.setattr(check, "compare", spy)
    result, _ = _run("pfb1024.resident")
    assert result["correct"]
    (s,), cfg = kept["streams"], kept["cfg"]
    assert len(s.records) > 4 and len(set(s.sent)) == 3
    halo = None
    for i, got in enumerate(s.records[:5]):
        block = kept["pool"](s.sent[i])
        ref = RPFB.spectrum(block, halo, cfg).numpy()
        assert np.abs(got - ref).max() <= 2e-5 * np.abs(ref).max()
        halo = RPFB.tail(block, cfg)
    again = s.sent.index(s.sent[0], 1)
    assert np.abs(s.records[0] - s.records[again]).max() > 0


def test_beams_rotate_per_beam():
    orders = gen.orders(12345, 4, 3)
    assert sorted(orders[0]) == [0, 1, 2]
    assert all(o[i] == orders[0][(b + i) % 3]
               for b, o in enumerate(orders) for i in range(3))


def test_pool_is_seeded():
    cfg = dict(TINY, sample_rms=64.0)
    a = gen.make_pool(cfg, 2, 2**33 + 5, torch.device("cpu"))
    b = gen.make_pool(cfg, 2, 2**33 + 5, torch.device("cpu"))
    c = gen.make_pool(cfg, 2, 2**33 + 6, torch.device("cpu"))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], a[1])
    assert a[0].dtype == torch.int16 and a[0].shape == (64, 2 * 3584)
