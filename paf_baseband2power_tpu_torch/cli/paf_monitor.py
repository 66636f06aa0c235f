"""CLI: ring-buffer monitor.

Operational observability for a running pipeline (the ``dada_dbmonitor``
role): prints geometry, cursor positions, fill level, and the stream header
of one or more rings, once or periodically.

A copy of the JAX package's ``paf_monitor``. Run ``python -m
paf_baseband2power_tpu_torch.cli.paf_monitor KEY [KEY ...]``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def snapshot(key: str) -> dict:
    from ..io.ringbuffer import RingBuffer

    with RingBuffer(key) as ring:
        return {
            "key": key,
            "bufsz": ring.bufsz,
            "nbufs": ring.nbufs,
            "nreaders": ring.nreaders,
            "written": ring.blocks_written,
            "read": ring.blocks_read,  # slowest reader's progress
            "full": ring.blocks_full,
            "at_eod": ring.at_eod(),
        }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="paf_monitor")
    ap.add_argument("keys", nargs="+", help="ring keys to monitor")
    ap.add_argument("-i", "--interval", type=float, default=0.0,
                    help="repeat every N seconds (0 = once)")
    ap.add_argument("--header", action="store_true",
                    help="also print the stream header")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    from ..io.ringbuffer import RingBuffer

    while True:
        for key in args.keys:
            try:
                snap = snapshot(key)
            except Exception as e:
                print(f"{key}: unavailable ({e})", file=sys.stderr)
                continue
            if args.json:
                print(json.dumps(snap))
            else:
                print(f"{key}: {snap['full']}/{snap['nbufs']} blocks full, "
                      f"written={snap['written']} read={snap['read']} "
                      f"bufsz={snap['bufsz']} nreaders={snap['nreaders']}"
                      f"{' EOD' if snap['at_eod'] else ''}")
            if args.header:
                with RingBuffer(key) as ring:
                    try:
                        hdr = ring.read_header(timeout_us=1000)
                        for k, v in hdr.items():
                            print(f"  {k:<12} {v}")
                    except Exception:
                        print("  (header not yet written)")
        if not args.interval:
            return 0
        time.sleep(args.interval)


if __name__ == "__main__":
    sys.exit(main())
