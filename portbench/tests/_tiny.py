"""Shared sizes of the CPU tests: a 64-frame, 2-chunk block (8192 samples
a series: 8 windows at nfft 1024)."""

TINY = {"ndf": 64, "nchk": 2}
CELLS = ("power.beams", "pfb1024.resident", "power.resident")
