"""``async_kernel``'s counted bound (``costs/async_kernel.py``) over its device time
in the traced window, in %."""
from pso_bench.trace import roofline_pct


def read(summary):
    return roofline_pct(summary, "async_kernel")
