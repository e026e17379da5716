"""The host's time in ``pso.init_swarm`` (the initial draw, the objective
and the gbest pick, enqueued), ms a solve."""
from pso_bench import spans


def read(summary, events=None):
    return spans.duration_ms(summary, ("pso.init_swarm",), events)
