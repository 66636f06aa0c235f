"""Records kept by pool pair: the comparison over kept arrays gives the
numbers that judging every record one by one gives (the keep-everything
comparison, kept here as the oracle), whatever the records are; a run
keeps a handful of arrays however many records arrive; and the bit test
tells apart what float equality would not."""

import math

import numpy as np
import pytest
import torch
from _tiny import TINY

from portbench import check, run
from portbench.stream import Records, Stream, same_bits

SEED = 2**31 + 4321


def oracle(cfg, streams, pool_block) -> check.Verdict:
    """The comparison before records were kept by pair: every record of
    plain lists ``(sent, records)`` judged one by one."""
    ref = check.reference_module(cfg)
    kind, limit = cfg["compare"]["kind"], float(cfg["compare"]["limit"])
    expected: dict = {}
    missing = bad = attempted = 0
    worst = 0.0
    for sent, records in streams:
        attempted += len(sent)
        missing += abs(len(sent) - len(records))
        for i, got in enumerate(records[:len(sent)]):
            prev = sent[i - 1] if (ref.STATEFUL and i > 0) else None
            key = (prev, sent[i])
            if key not in expected:
                expected[key] = check.Expected(ref.record(
                    pool_block(sent[i]),
                    None if prev is None else pool_block(prev), cfg))
            err = expected[key].error(kind, got)
            worst = max(worst, err)
            bad += err > limit
    numbers = {"missing_records": {"value": missing, "limit": 0},
               f"{kind}_err": {"value": min(worst, check._FINITE_MAX),
                               "limit": limit}}
    return check.Verdict(numbers=numbers, attempted=attempted,
                         failed=missing + bad)


_RUNS: dict = {}


def _captured(cell):
    """``(cfg, streams, pool_block)`` of one CPU run of ``cell``, as
    ``check.compare`` received them."""
    if cell not in _RUNS:
        kept = {}
        orig = check.compare

        def spy(cfg, streams, pool_block):
            kept.update(cfg=cfg, streams=streams, pool=pool_block)
            return orig(cfg, streams, pool_block)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(check, "compare", spy)
            result, _ = run.run_cell(run.load_manifest(), cell, SEED, 0.3,
                                     False, torch.device("cpu"),
                                     cfg_override=TINY)
        assert result["correct"], result["check"]
        _RUNS[cell] = (kept["cfg"], kept["streams"], kept["pool"])
    return _RUNS[cell]


def _bump_bits(a: np.ndarray, k: int, n: int) -> None:
    """Element ``k`` of ``a`` ``n`` float32 steps up (positive values)."""
    a.reshape(-1).view(np.int32)[k] += n


def _equal(records):
    return records


def _one_step(records):
    mid = len(records) // 2
    _bump_bits(records[mid], 5, 1)
    return records


def _peak_1e4(records):
    mid = len(records) // 2
    r = records[mid].reshape(-1)
    r[r.argmax()] *= np.float32(1 + 1e-4)
    return records


def _one_pair(records):
    """Every record of the second record's pool pair 1e-4 of its peak off:
    several records behind one kept array."""
    bits = records[1].tobytes()
    for r in records:
        if r.tobytes() == bits:
            r = r.reshape(-1)
            r[r.argmax()] *= np.float32(1 + 1e-4)
    return records


def _wrong_shape(records):
    mid = len(records) // 2
    records[mid] = records[mid].reshape(-1)[:-1].copy()
    return records


def _nan(records):
    records[len(records) // 2].reshape(-1)[3] = np.nan
    return records


def _all_differ(records):
    for i, r in enumerate(records):
        _bump_bits(r, i % r.size, 1 + i // r.size)
    return records


def _dropped(records):
    del records[len(records) // 2]
    return records


CASES = [_equal, _one_step, _peak_1e4, _one_pair, _wrong_shape, _nan,
         _all_differ, _dropped]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__[1:])
@pytest.mark.parametrize("cell", ["power.resident", "pfb1024.resident"])
def test_compare_equals_the_oracle(cell, case):
    cfg, (s,), pool_block = _captured(cell)
    assert len(s.records) >= 5      # a pool pair comes twice
    plain = case([np.array(s.records[i]) for i in range(len(s.records))])
    got = check.compare(cfg, [Stream(sent=list(s.sent), records=plain)],
                        pool_block)
    want = oracle(cfg, [(list(s.sent), plain)], pool_block)
    assert got.numbers == want.numbers
    assert (got.failed, got.attempted) == (want.failed, want.attempted)
    assert got.correct == want.correct
    # a float32 step is inside the PFB's limit and fails an exact one
    assert got.correct is (case is _equal or (
        case in (_one_step, _all_differ)
        and cfg["compare"]["kind"] == "peak"))
    if case is _one_pair:
        assert want.failed >= 2
    elif case is _all_differ:
        assert got.kept == [len(plain)]
    elif case is _equal:
        assert got.kept[0] <= 4 < len(plain)


@pytest.mark.parametrize("cell", ["pfb1024.resident", "power.resident",
                                  "pfb1024_stokes.resident", "power.beams",
                                  "pfb1024.beams"])
def test_run_keeps_a_few_arrays(cell):
    """However many records arrive, each stream keeps at most one array
    per pool pair and one for its start: 4 with a pool of 3."""
    _, streams, _ = _captured(cell)
    for s in streams:
        assert len(s.records) == len(s.sent) >= 5
        assert len(s.records.arrays()) <= 4


def test_records_are_bit_equal_and_read_only():
    a = np.array([1.0, -0.0, np.nan], dtype=np.float32)
    quiet = a.copy()
    b = a.copy()
    b[1] = 0.0                                        # +0.0 == -0.0
    c = a.copy()
    c.view(np.int32)[2] ^= 1                          # another NaN payload
    s = Stream(sent=[0] * 5)     # keys (None, 0), then (0, 0)
    for r in (a, quiet, b, c, a):
        s.keep(r)
    assert len(s.records) == 5
    assert [len(v) for v in s.records.kept.values()] == [1, 3]
    for i, r in enumerate((a, quiet, b, c, a)):
        assert s.records[i].tobytes() == r.tobytes()
    assert s.records[1] is s.records[4]
    a[0] = 7.0                  # the caller's buffer is reused
    assert s.records[0][0] == 1.0
    with pytest.raises(ValueError):
        s.records[0][0] = 2.0


def test_large_records_compare_every_byte():
    a = np.arange(1 << 15, dtype=np.float32)          # 128 KiB
    b = a.copy()
    assert same_bits(a, b)
    b.view(np.uint8)[-1] ^= 1
    assert not same_bits(a, b)
    assert not same_bits(a, a.view(np.int32))
    assert not same_bits(a, a.reshape(2, -1))
    assert same_bits(a[::2], a[::2].copy())           # not contiguous


def test_a_record_before_its_block_is_judged_by_its_place():
    """A record kept before its block is in ``sent`` counts against the
    pair its place has once the block is sent."""
    r = Records()
    r.add(0, np.zeros(2, np.float32))
    ((p, got, n),) = r.groups([2])
    assert p == (None, 2) and n == 1 and math.isclose(got.sum(), 0.0)
