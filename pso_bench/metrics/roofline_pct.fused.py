"""``fused_kernel``'s counted bound (``costs/fused_kernel.py``) over its device time
in the traced window, in %."""
from pso_bench.trace import roofline_pct


def read(summary):
    return roofline_pct(summary, "fused_kernel")
