"""CLI: drain a ring buffer to disk.

The stock ``dada_dbdisk`` analogue (invoked by the reference launcher,
``paf-baseband2power.py:94-95``): attach as reader, write the stream header
and every block payload to a .dada file until EOD.

A copy of the JAX package's ``paf_dbdisk``. Run ``python -m
paf_baseband2power_tpu_torch.cli.paf_dbdisk -k KEY -D DIR -o NAME``.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="paf_dbdisk")
    ap.add_argument("-k", "--key", required=True, help="source ring key")
    ap.add_argument("-D", "--dir", default=".", help="output directory")
    ap.add_argument("-o", "--output", default=None,
                    help="output file name (default <UTC_START>.dada)")
    ap.add_argument("-W", "--overwrite", action="store_true")
    ap.add_argument("--wait-sod", action="store_true",
                    help="start at the marked observation boundary, "
                    "discarding pre-SOD blocks (mid-stream attach)")
    args = ap.parse_args(argv)

    from ..io.dada import DadaFileWriter
    from ..io.ringbuffer import RingBuffer
    from ..runtime.log import open_log

    log = open_log("paf_dbdisk", args.dir)

    with RingBuffer(args.key) as ring:
        ring.lock_read()
        start_block = 0
        if args.wait_sod:
            start_block = ring.wait_sod()
            log.info("SOD at block %d", start_block)
        header = ring.read_header()
        name = args.output or f"{header.get('UTC_START', 'stream')}.dada"
        path = os.path.join(args.dir, name)
        if os.path.exists(path) and not args.overwrite:
            log.error("%s exists (use -W to overwrite)", path)
            return 1
        n = 0
        with DadaFileWriter(path, header) as w:
            while True:
                view = ring.open_block_read()
                if view is None:
                    break
                w.write(view.tobytes())
                ring.close_block_read()
                n += 1
        ring.unlock_read()
    log.info("wrote %d blocks to %s", n, path)
    print(f"wrote {n} blocks to {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
