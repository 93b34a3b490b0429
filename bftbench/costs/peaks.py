"""Peaks of one NVIDIA H100 SXM, for rooflines.

HBM bandwidth from NVIDIA's data sheet (80 GB HBM3, 3.35 TB/s).  32-bit
integer operations (multiply-add, add, logic, shift) at 64 per clock per
SM (CUDA C++ Programming Guide, arithmetic instruction throughput,
compute capability 9.0) x 132 SMs x 1.98 GHz, the highest SM clock.
Both assume the card's full power limit of 700 W: a share is stated
beside the power limit the run reads.
"""

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
