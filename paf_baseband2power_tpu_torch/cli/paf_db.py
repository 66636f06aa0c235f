"""CLI: create/destroy shared-memory ring buffers.

The ``dada_db`` analogue the launcher shells out to in the reference
(``paf-baseband2power.py:114-115,129-130``):
create with ``-k key -b bufsz -n nbufs``, destroy with ``-k key -d``.

A copy of the JAX package's ``paf_db``. Run ``python -m
paf_baseband2power_tpu_torch.cli.paf_db -k KEY ...``.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="paf_db")
    ap.add_argument("-k", "--key", required=True, help="ring key")
    ap.add_argument("-b", "--bufsz", type=int, default=None,
                    help="bytes per block")
    ap.add_argument("-n", "--nbufs", type=int, default=4,
                    help="number of blocks")
    ap.add_argument("-r", "--nreader", type=int, default=1,
                    help="reader clients every block must pass through "
                    "(dada_db -r)")
    ap.add_argument("-d", "--destroy", action="store_true")
    ap.add_argument("--sod", action="store_true",
                    help="mark start-of-data at the ring's current write "
                    "cursor (operational SOD control for a capture "
                    "running with -b 0: SOD-waiting readers start at the "
                    "next block committed after this). Out-of-band "
                    "marking is advisory within the block being "
                    "committed at that instant — mark from the writer "
                    "(-b 1 / diskdb -e 1) for an exact boundary")
    ap.add_argument("--status", action="store_true",
                    help="print cursors/SOD/EOD as one JSON line")
    args = ap.parse_args(argv)

    from ..io import ringbuffer as rb

    if args.destroy:
        rb.destroy(args.key)
        print(f"destroyed ring '{args.key}'")
        return 0
    if args.sod or args.status:
        import json

        with rb.RingBuffer(args.key) as ring:
            if args.sod:
                ring.set_sod()
            print(json.dumps({
                "key": args.key,
                "bufsz": ring.bufsz,
                "nbufs": ring.nbufs,
                "nreaders": ring.nreaders,
                "blocks_written": ring.blocks_written,
                "blocks_read": ring.blocks_read,
                "sod_block": ring.sod_block,
            }))
        return 0
    if args.bufsz is None:
        ap.error("-b/--bufsz is required to create a ring")
    rb.create(args.key, args.bufsz, args.nbufs, nreader=args.nreader)
    print(f"created ring '{args.key}': {args.nbufs} x {args.bufsz} bytes, "
          f"{args.nreader} reader(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
