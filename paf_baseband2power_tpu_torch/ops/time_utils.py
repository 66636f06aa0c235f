"""Absolute-time bookkeeping for BMF streams.

Replicates the semantics of ``acquire_start_time`` (``capture.c:791-843``):
the absolute start of a capture is

    epoch base (BMF ``epoch`` field = half-years since 2000-01-01, resolved
    to an MJD) + ``sec`` (seconds from epoch to the current 27 s period
    start) + ``idf`` * TDF (frame offset within the period),

split into a whole-second UTC string (``%Y-%m-%d-%H:%M:%S``) plus a
picosecond fraction. Unlike the reference's float path (which notes a
possible 1 ps deviation and rounds to whole microseconds), this module does
the fraction in exact integer picoseconds — one frame is exactly
108_000_000 ps — so no rounding is needed.

The reference resolves ``epoch -> MJD`` via an external lookup file
(``capture.c:799-816``). Here the table is computed from the calendar
(Jan 1 / Jul 1 of each year), with an optional file override in the same
``"<epoch> <mjd>"`` line format.

A copy of the JAX package's ``ops/time_utils.py``; a test holds the two
equal on seeded inputs.
"""

from __future__ import annotations

import datetime

from ..constants import MJD1970, SECDAY, TDF_PICOSECONDS

DADA_TIMESTR = "%Y-%m-%d-%H:%M:%S"
PS_PER_SEC = 10**12


def epoch_to_mjd(epoch: int) -> float:
    """MJD of BMF epoch ``epoch`` (half-years since 2000-01-01)."""
    year = 2000 + epoch // 2
    month = 1 if epoch % 2 == 0 else 7
    d = datetime.date(year, month, 1)
    unix_days = (d - datetime.date(1970, 1, 1)).days
    return MJD1970 + unix_days


def load_epoch_table(path: str) -> dict[int, float]:
    """Parse a reference-format epoch file: ``<epoch> <mjd> [...]`` lines,
    ``#`` comments (``capture.c:807-815``)."""
    table: dict[int, float] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            table[int(parts[0])] = float(parts[1])
    return table


def start_time(
    epoch: int,
    sec: int,
    idf: int,
    epoch_table: dict[int, float] | None = None,
) -> tuple[str, int]:
    """Absolute start time of frame ``idf`` -> (UTC string, picoseconds).

    Returns the whole-second UTC timestamp (no fractional second, DADA
    ``UTC_START`` convention) and the sub-second remainder in picoseconds
    (DADA ``PICOSECONDS``).
    """
    mjd = epoch_table[epoch] if epoch_table is not None else epoch_to_mjd(epoch)
    unix_sec = round((mjd - MJD1970) * SECDAY) + sec
    total_ps = idf * TDF_PICOSECONDS
    unix_sec += total_ps // PS_PER_SEC
    picoseconds = total_ps % PS_PER_SEC
    utc = datetime.datetime.fromtimestamp(
        unix_sec, tz=datetime.timezone.utc
    ).strftime(DADA_TIMESTR)
    return utc, picoseconds


def block_timestamp(utc_start: str, picoseconds: int, block_index: int,
                    block_ps: int) -> tuple[str, int]:
    """Start time of block ``block_index`` given the stream start.

    ``block_ps`` is the block duration in picoseconds (one integration =
    884_736_000_000 ps). Keeps every block independently addressable in
    time, the property the reference gets from per-frame timestamps.
    """
    base = datetime.datetime.strptime(utc_start, DADA_TIMESTR).replace(
        tzinfo=datetime.timezone.utc
    )
    total = picoseconds + block_index * block_ps
    sec, ps = divmod(total, PS_PER_SEC)
    t = base + datetime.timedelta(seconds=sec)
    return t.strftime(DADA_TIMESTR), ps
