"""The share of the traced window, in %, in which the device sat idle while
the host's innermost span was ``api.solve`` itself."""
from pso_bench import spans


def read(summary, events=None):
    return spans.idle_pct(summary, "facade", events)
