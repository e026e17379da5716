"""The final positions and velocities element by element against the
reference's from the same seed: the largest gap of a position over the
box's width and of a velocity over the width of its range. Where the
program runs the reference's operations in the same order (one swarm
synchronized every iteration), each is the same float32 number on both
sides and the gap 0; a wrong draw, term, coefficient or iteration count
moves the trajectory, and every later iteration with it."""
import torch


def value(prog, ref, ctx):
    cfg = ctx["config"]
    pos = (prog["pos"] - ref["pos"]).abs().max() / (cfg["hi"] - cfg["lo"])
    vel = (prog["vel"] - ref["vel"]).abs().max() / (2.0 * cfg["max_v"])
    return float(torch.maximum(pos, vel))
