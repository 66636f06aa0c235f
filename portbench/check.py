"""The comparison that decides ``correct``: every record a run delivered,
against the plain reference of its configuration.

A stream's record ``i`` is due for block ``pool[sent[i]]`` after block
``pool[sent[i - 1]]`` (a stateful reference, such as the PFB's carry, needs
the previous block too). The reference works each distinct pair out once
from the pool blocks themselves.

The records come kept by that pool pair (``stream.Records``): each distinct
array once, tested bit for bit against the pair's earlier arrays as it
arrived, with the count of records bit-equal to it. Each kept array is
judged once, and its verdict counts for every one of those records. That is
exact, not a sample: the error is a function of the record's bytes and its
pair's reference, so records bit-equal under one pair read the same error.
It is also small: the streams take the pool in a fixed rotation and the
program's records are deterministic, so a stream keeps about one array a
pair, however many records a window delivers. Two numbers are compared,
each with its limit:

* ``missing_records``: records due and not delivered (or delivered beyond
  what was sent), limit 0;
* the configuration's error: ``exact`` is the largest relative difference
  of any value (limit 0: bit-equal), ``peak`` the largest of each record's
  largest absolute difference over the record's peak (its limit comes from
  the configuration). A value that is not finite counts as infinitely
  wrong.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
import time

import numpy as np

_FINITE_MAX = float(np.finfo(np.float64).max)   # JSON has no infinity


def reference_module(cfg: dict):
    return importlib.import_module(f"portbench.references.{cfg['reference']}")


class Expected:
    """One reference record (float32, as the program's) with its peak."""

    def __init__(self, ref: np.ndarray):
        self.ref = np.asarray(ref, dtype=np.float32).reshape(-1)
        self.peak = max(float(np.abs(self.ref).max()), 1e-300)

    def error(self, kind: str, got: np.ndarray) -> float:
        got = np.asarray(got, dtype=np.float32).reshape(-1)
        if got.shape != self.ref.shape:
            return float("inf")
        # exact where the two lie within a factor 2 of each other, and
        # never 0 for two different finite values
        diff = np.abs(got - self.ref)
        worst = float(diff.max())
        if not math.isfinite(worst):
            return float("inf")
        if kind == "exact":
            if worst == 0.0:
                return 0.0
            rel = diff.astype(np.float64) / np.maximum(
                np.abs(self.ref.astype(np.float64)), 1e-300)
            return float(rel.max())
        if kind == "peak":
            return worst / self.peak
        raise ValueError(f"unknown comparison '{kind}'")


@dataclasses.dataclass
class Verdict:
    numbers: dict          # name -> {"value": v, "limit": l}
    attempted: int
    failed: int
    seconds: float = 0.0   # the reference's and the comparison's time
    kept: list = dataclasses.field(default_factory=list)  # arrays a stream
    kept_bytes: int = 0    # the kept arrays' bytes

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(
            n["value"] <= n["limit"] for n in self.numbers.values())

    def lines(self) -> list[str]:
        return [f"check {k}: {n['value']!r} (limit {n['limit']!r})"
                for k, n in self.numbers.items()]


def compare(cfg: dict, streams: list, pool_block) -> Verdict:
    """Judge every record of ``streams``, each kept array once;
    ``pool_block(i)`` gives pool block ``i`` on the device the reference
    runs on."""
    t0 = time.perf_counter()
    ref = reference_module(cfg)
    kind, limit = cfg["compare"]["kind"], float(cfg["compare"]["limit"])
    expected: dict = {}
    missing = bad = attempted = 0
    worst = 0.0
    for s in streams:
        attempted += len(s.sent)
        missing += abs(len(s.sent) - len(s.records))
        for (prev, cur), got, count in s.records.groups(s.sent):
            key = (prev if ref.STATEFUL else None, cur)
            if key not in expected:
                expected[key] = Expected(ref.record(
                    pool_block(cur),
                    None if key[0] is None else pool_block(key[0]), cfg))
            err = expected[key].error(kind, got)
            worst = max(worst, err)
            bad += count if err > limit else 0
    numbers = {"missing_records": {"value": missing, "limit": 0},
               f"{kind}_err": {"value": min(worst, _FINITE_MAX),
                               "limit": limit}}
    kept = [s.records.arrays() for s in streams]
    return Verdict(numbers=numbers, attempted=attempted, failed=missing + bad,
                   seconds=time.perf_counter() - t0,
                   kept=[len(k) for k in kept],
                   kept_bytes=sum(a.nbytes for k in kept for a in k))
