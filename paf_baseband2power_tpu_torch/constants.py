"""Data-geometry constants for the PAF BMF baseband->power pipeline.

These mirror the behavioral contract of the reference implementation
(xinpingdeng/paf-baseband2power): the compile-time constants in
``capture.h:18-44``, the INI config ``paf-baseband2power.conf:1-26``, and the
integration math in ``README.md:2`` ("1024x1024 samples and the sampling time
is 27/32 microseconds").

Everything else in this framework derives its shapes from this module, so the
invariants asserted at the bottom are the single source of truth for block
geometry.

A whole copy of the JAX package's ``constants.py``, so that the port imports
nothing of that package; a test holds the two equal name by name.
"""

from __future__ import annotations

from fractions import Fraction

# --- UDP data-frame geometry (capture.h:27-29) -------------------------------
DF_SIZE = 7232          # bytes: one BMF data frame including its header
HDR_SIZE = 64           # bytes: frame header
DT_SIZE = 7168          # bytes: frame payload (DF_SIZE - HDR_SIZE)

# --- Sample geometry (paf-baseband2power.conf:1-5) ---------------------------
NSAMP_DF = 128          # time samples per frame per channel
NPOL_SAMP = 2           # polarizations per sample
NDIM_POL = 2            # dims per polarization sample (complex: I, Q)
NBYTE_IN = 2            # bytes per dim (int16 I/Q), derived: see NCHAN_CHK

# Channels carried by one frame: 7168 / (128*2*2*2) = 7
NCHAN_CHK = DT_SIZE // (NSAMP_DF * NPOL_SAMP * NDIM_POL * NBYTE_IN)

# --- Stream geometry (capture.h:19-24) ---------------------------------------
NCHK_NIC = 48           # frequency chunks received per NIC/node
NCHK_BMF = 6            # chunks produced per BMF process
MCHK_PORT = 8           # max chunks per UDP port
NPORT_NIC = 6           # UDP ports per NIC
PORT_BASE = 17100       # first UDP port

NCHAN = NCHK_NIC * NCHAN_CHK          # 336 total channels per node

# --- Timing (README.md:2, capture.h:30-32) -----------------------------------
TSAMP = Fraction(27, 32) * Fraction(1, 10**6)   # 0.84375 us, exact
TSAMP_SEC = float(TSAMP)                         # 8.4375e-7 s
TDF = TSAMP * NSAMP_DF                           # frame interval, 1.08e-4 s exact
TDF_SEC = float(TDF)
PRD_SEC = 27            # streaming period in seconds
NDF_PRD = 250000        # frames per period per chunk (27 s / 1.08e-4 s)
TDF_PICOSECONDS = int(TDF * 10**12)              # 108_000_000 ps, exact

# --- Integration / block geometry (README.md:2, conf:9, py launcher:67) ------
NSAMP_INT = 1024 * 1024                 # samples integrated per output power
NDF_BLK = NSAMP_INT // NSAMP_DF         # 8192 frames per ring block per chunk
TINT = TSAMP * NSAMP_INT                # 0.884736 s, exact
TINT_SEC = float(TINT)

BLOCK_NBYTES = NDF_BLK * NCHK_NIC * DT_SIZE     # 2_818_572_288 bytes
BLOCK_SHAPE = (NDF_BLK, NCHK_NIC, NSAMP_DF, NCHAN_CHK, NPOL_SAMP, NDIM_POL)

# --- Output geometry (conf:24-25, header_baseband2power.txt:39-42) -----------
NBYTE_OUT = 4                           # float32 power
OUT_NBYTES = NCHAN * NBYTE_OUT          # 1344 bytes per integration
OUT_NBIT = 32
OUT_NDIM = 1
OUT_NPOL = 1

# --- Ring-buffer defaults (conf:11,26; launcher:114-115) ---------------------
DADA_HDR_SIZE = 4096
DEFAULT_NBLK_IN = 8
DEFAULT_NBLK_OUT = 4
DEFAULT_KEY_IN = "dada"
DEFAULT_KEY_OUT = "adad"

# --- Capture configuration (capture.h:35-37) ---------------------------------
TBUF_NDF = 256          # frames of headroom in the late-frame temp buffer
NDF_CHECK = 800         # frames probed per port to discover active chunks

# --- Epoch / time bases (capture.h:43-44) ------------------------------------
SECDAY = 86400.0
MJD1970 = 40587.0       # MJD of the unix epoch

# --- Invariants --------------------------------------------------------------
assert NCHAN_CHK == 7
assert NCHAN == 336
assert NDF_BLK == 8192
assert BLOCK_NBYTES == 2_818_572_288
assert OUT_NBYTES == 1344
assert float(TINT) == 0.884736
assert TDF_PICOSECONDS == 108_000_000
assert NDF_PRD * TDF == PRD_SEC  # one period is exactly 250000 frames
