"""The host's self time in ``api.solve`` (its span's duration less its
children's: configuration, the method's resolution, the ``Result``), ms a
solve."""
from pso_bench import spans


def read(summary, events=None):
    return spans.self_ms(summary, "api.solve", events)
