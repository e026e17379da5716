"""The host's time in ``api.read`` (``Result.best_fit``, ``best_pos``,
``gbest_fit``: waiting for the card, then the copy), ms a solve."""
from pso_bench import spans


def read(summary, events=None):
    return spans.duration_ms(summary, ("api.read",), events)
