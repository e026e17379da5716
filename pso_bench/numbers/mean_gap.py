"""The relative distance of the swarm's mean pbest fitness from the
reference's: the initial draw, the update and the fold of every particle.
A swarm that stopped moving, or particles left behind, fall short."""
import torch


def value(prog, ref, ctx):
    got = float(prog["pbest_fit"].to(torch.float64).mean())
    want = float(ref["pbest_fit"].to(torch.float64).mean())
    return abs(got - want) / abs(want)
