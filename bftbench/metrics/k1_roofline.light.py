"""Kernel K1 (`csrc/verify_grouped.cu`) in the light cells: its least
time per launch (`costs/k1.py`, at the card's peaks) over its device time
per launch in the profiler's trace, in %.  Moves `headers_per_s`."""

from bftbench.metrics._shared import k1_roofline

UNIT = "%"
read = k1_roofline
