"""CLI: replay a recorded DADA file into a ring buffer.

Reference parity (``paf_diskdb.cu:12-22``): ``-a key -b dir -c data-file
-d header-file -e sod``. Behavior contract from ``diskdb.cu:74-124``: write
the stream header (from the file's own header or an override template),
then stream whole ring blocks from the file until EOF, then EOD.

A copy of the JAX package's ``paf_diskdb``. Run ``python -m
paf_baseband2power_tpu_torch.cli.paf_diskdb -a KEY -c FILE``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="paf_diskdb")
    ap.add_argument("-a", "--key", required=True, help="target ring key")
    ap.add_argument("-b", "--dir", default=None, help="log directory")
    ap.add_argument("-c", "--file", required=True, help="input .dada file")
    ap.add_argument("-d", "--header", default=None,
                    help="header template file overriding the file's header")
    ap.add_argument("-e", "--sod", type=int, default=1,
                    help="start-of-data flag (paf_diskdb.cu -e parity): "
                    "1 writes the stream header and marks SOD at the "
                    "first replayed block; 0 replays without a SOD mark "
                    "(pre-observation / transient data)")
    ap.add_argument("--skip-blocks", type=int, default=0,
                    help="resume: skip this many ring blocks of payload "
                    "and advance OBS_OFFSET accordingly")
    args = ap.parse_args(argv)

    from ..io.dada import DadaFileReader, DadaHeader
    from ..io.ringbuffer import RingBuffer
    from ..runtime.log import open_log

    log = open_log("paf_diskdb", args.dir)

    with DadaFileReader(args.file) as reader, RingBuffer(args.key) as ring:
        ring.lock_write()
        header = reader.header
        if args.header:
            with open(args.header, "rb") as f:
                header = DadaHeader.parse(f.read())
        bufsz = ring.bufsz
        if args.skip_blocks:
            reader.skip(args.skip_blocks * bufsz)
            header = DadaHeader(header)
            header["OBS_OFFSET"] = str(args.skip_blocks * bufsz)
        if args.sod:
            ring.write_header(header)
            # first-class SOD mark (ipcbuf_enable_sod analogue,
            # diskdb.cu:36-67): readers using wait_sod start exactly here
            ring.set_sod()
        n = 0
        for raw in reader.blocks(bufsz):
            view = ring.open_block_write()
            view[:] = np.frombuffer(raw, np.uint8)
            ring.close_block_write(bufsz)
            n += 1
            log.info("block %d -> ring '%s'", n, args.key)
        ring.set_eod()
        ring.unlock_write()
    log.info("replayed %d blocks from %s", n, args.file)
    print(f"replayed {n} blocks from {args.file} into ring '{args.key}'")
    return 0


if __name__ == "__main__":
    sys.exit(main())
