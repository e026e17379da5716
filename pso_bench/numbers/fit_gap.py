"""How far a reported fitness lies from the objective at its own position,
evaluated in float64: every particle's pbest, the best the user reads
(``best_fit`` at ``best_pos``) and the best of the pbests against
``best_fit``; each gap over the sum of the objective's terms' magnitudes
at that position, the scale its rounding works against. It covers the
objective and what the pbest fold and the gbest publication wrote."""
import torch


def value(prog, ref, ctx):
    f64 = ctx["objective"].f64
    f, scale = f64(prog["pbest_pos"])
    pbf = prog["pbest_fit"].to(torch.float64)
    gaps = [float(torch.max((pbf - f).abs() / scale))]
    fb, sb = f64(prog["best_pos"])
    gaps.append(abs(prog["best_fit"] - float(fb)) / float(sb))
    gaps.append(abs(float(pbf.max()) - prog["best_fit"]) / float(sb))
    return max(gaps)
