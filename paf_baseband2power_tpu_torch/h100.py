"""Published peak rates of one NVIDIA H100 SXM, the yardsticks of the
bench's ``hbm_fraction`` and of the least times ``chip_smoke.py`` reports.

Kept apart from ``constants.py``, which holds the data geometry only, name
for name equal to the JAX package's.
"""

HBM_BPS = 3.35e12       # HBM3 bytes/s
FP32_FLOPS = 67e12      # fp32 FLOP/s outside the tensor cores
BF16_FLOPS = 989e12     # bf16 tensor-core FLOP/s, dense
