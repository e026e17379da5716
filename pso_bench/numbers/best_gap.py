"""The relative distance of ``best_fit`` from the reference's best after
the same iterations from the same seed."""


def value(prog, ref, ctx):
    want = float(ref["gbest_fit"])
    return abs(prog["best_fit"] - want) / abs(want)
