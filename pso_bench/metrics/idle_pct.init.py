"""The share of the traced window, in %, in which the device sat idle while
the host's innermost span was ``pso.init_swarm``."""
from pso_bench import spans


def read(summary, events=None):
    return spans.idle_pct(summary, "init", events)
