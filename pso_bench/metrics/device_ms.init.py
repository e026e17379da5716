"""The device time of the operations issued inside ``pso.init_swarm``, ms a
solve."""
from pso_bench import spans


def read(summary, events=None):
    got = spans.issued_in(summary, "pso.init_swarm", events)
    return None if got is None else spans.per_solve_ms(summary, got[1])
