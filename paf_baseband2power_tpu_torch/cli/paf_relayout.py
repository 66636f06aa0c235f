"""CLI: convert recordings between the wire and device (series-row) layouts.

``capture --device-layout`` rings and their spills hold blocks in the TPU
series-row form (``ORDER SERIES`` header) — the fast layout for every
detection mode, but a non-standard DADA ordering. This tool rewrites a
recording in the other layout so device-layout captures stay interoperable
with stock PSRDADA consumers (and wire archives can be promoted to the
fast layout for reprocessing): the byte-for-byte inverse of the capture
engine's corner turn, block by block.

Reference interop contract: the TFTFP wire order of ``capture.c:540-544``
(frame placement at ``(idf*48 + ifreq) * pkt_size``).

A copy of the JAX package's ``paf_relayout`` on this package's
``ops/frame.py`` codecs: both tools write the same bytes. Run
``python -m paf_baseband2power_tpu_torch.cli.paf_relayout -a IN -b OUT``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import constants as C


def wire_to_rows(block: np.ndarray, ndf: int, nchk: int) -> np.ndarray:
    from ..ops.frame import block_to_rows

    b6 = block.reshape(ndf, nchk, C.NSAMP_DF, C.NCHAN_CHK, C.NPOL_SAMP, 2)
    return block_to_rows(b6)


def rows_to_wire(block: np.ndarray, ndf: int, nchk: int) -> np.ndarray:
    from ..ops.frame import rows_to_block

    b6 = rows_to_block(block, ndf, nchk)
    return b6.reshape(ndf, -1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="paf_relayout")
    ap.add_argument("-a", "--input", required=True,
                    help="input .dada baseband recording (either layout; "
                    "detected from the ORDER header)")
    ap.add_argument("-b", "--output", required=True,
                    help="output .dada in the other layout")
    ap.add_argument("--ndf", type=int, default=C.NDF_BLK,
                    help="frames per block")
    ap.add_argument("--nchk", type=int, default=0,
                    help="chunk count (default: derived from the "
                    "recording's NCHAN header)")
    args = ap.parse_args(argv)

    import os

    from ..io.dada import DadaFileReader, DadaFileWriter, DadaHeader

    with DadaFileReader(args.input) as r:
        hdr = DadaHeader(r.header)  # dict.copy() would drop the subclass
        nchk = args.nchk
        if not nchk:
            nchan = int(hdr.get("NCHAN", 0))
            if not nchan or nchan % C.NCHAN_CHK:
                raise SystemExit(
                    f"cannot derive --nchk: recording NCHAN={nchan!r} is "
                    f"not a multiple of {C.NCHAN_CHK}")
            nchk = nchan // C.NCHAN_CHK
        to_rows = hdr.get("ORDER") != "SERIES"
        if to_rows:
            hdr["ORDER"] = "SERIES"
        else:
            hdr.pop("ORDER", None)
        block_nbytes = args.ndf * nchk * C.DT_SIZE
        payload = os.path.getsize(args.input) - C.DADA_HDR_SIZE
        if payload % block_nbytes:
            raise SystemExit(
                f"recording payload {payload} B is not a whole number of "
                f"{block_nbytes} B blocks (ndf={args.ndf}, nchk={nchk}) — "
                "wrong geometry flags for this file?")
        n = 0
        with DadaFileWriter(args.output, hdr) as w:
            for raw in r.blocks(block_nbytes):
                x = np.frombuffer(raw, dtype="<i2")
                out = (wire_to_rows if to_rows else rows_to_wire)(
                    x, args.ndf, nchk)
                w.write(out)
                n += 1
    if n == 0:
        raise SystemExit(
            f"no blocks converted — recording smaller than one "
            f"{block_nbytes} B block (ndf={args.ndf}, nchk={nchk})")
    print(f"converted {n} blocks to "
          f"{'SERIES rows' if to_rows else 'wire TFTFP'}: {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
