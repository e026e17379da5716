"""The host's time in ``ops.pack``, ``ops.launch`` and ``ops.unpack`` (the
D-major pack, the kernels' argument building and launches, the unpack), ms
a solve."""
from pso_bench import spans


def read(summary, events=None):
    return spans.duration_ms(summary, ("ops.pack", "ops.launch",
                                       "ops.unpack"), events)
