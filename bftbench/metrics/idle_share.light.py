"""The card in the light cells: 100 x (1 - the union of its kernels and
copies in the profiler's trace over the window).  Moves `headers_per_s`."""

from bftbench.metrics._shared import idle_share

UNIT = "%"
read = idle_share
