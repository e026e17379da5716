"""Device operations (kernels, copies, memsets) issued inside
``pso.init_swarm``, a solve."""
from pso_bench import spans


def read(summary, events=None):
    got = spans.issued_in(summary, "pso.init_swarm", events)
    return None if got is None else got[0] / summary["solves"]
