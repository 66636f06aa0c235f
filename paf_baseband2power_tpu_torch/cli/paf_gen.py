"""CLI: synthetic BMF baseband recorder.

Writes a .dada baseband file the disk-replay path can consume — the
software stand-in for a telescope recording (the reference assumes recorded
files exist; its only generator is the live beamformer). Useful for
integration tests and for exercising the full offline pipeline.

A copy of the JAX package's ``paf_gen``: the same seed gives the same bytes.
Run ``python -m paf_baseband2power_tpu_torch.cli.paf_gen -o FILE``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import constants as C


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="paf_gen")
    ap.add_argument("-o", "--output", required=True, help="output .dada file")
    ap.add_argument("-n", "--nblocks", type=int, default=2)
    ap.add_argument("--ndf", type=int, default=C.NDF_BLK)
    ap.add_argument("--nchk", type=int, default=C.NCHK_NIC)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=64.0)
    ap.add_argument("--utc-start", default="2026-01-01-00:00:00")
    ap.add_argument("--device-layout", action="store_true",
                    help="record in the series-row device layout (ORDER "
                    "SERIES header) — what `capture --device-layout` "
                    "rings hold; replays feed the rows kernels with zero "
                    "on-device corner turn")
    args = ap.parse_args(argv)

    from ..io.dada import DadaFileWriter, baseband_header
    from ..ops.frame import block_to_rows, synthetic_block

    hdr = baseband_header(
        utc_start=args.utc_start, picoseconds=0, freq=1340.5,
        nchan=args.nchk * C.NCHAN_CHK,
        extra={"ORDER": "SERIES"} if args.device_layout else None,
    )
    with DadaFileWriter(args.output, hdr) as w:
        for i in range(args.nblocks):
            block = synthetic_block(rng=args.seed + i, ndf=args.ndf,
                                    nchk=args.nchk, scale=args.scale)
            if args.device_layout:
                block = block_to_rows(block)
            w.write(np.ascontiguousarray(block))
    print(f"wrote {args.nblocks} blocks "
          f"({args.ndf}x{args.nchk} frames"
          f"{', ORDER SERIES' if args.device_layout else ''}) "
          f"to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
