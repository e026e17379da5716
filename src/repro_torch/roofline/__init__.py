"""Roofline analysis for cost-model-driven scheduling, the port of
``repro.roofline``.

``pso_cost`` is the PSO cost model behind the schedule autotuner
(``repro_torch.core.autotune``): per-iteration flop/byte counts for every
engine variant (fitness op mix per built-in, gbest publication traffic as
a function of ``sync_every``, the CUDA kernels' synchronisation points and
dispatches) and the ``Calibration`` that turns them into microseconds on
the CPU or the card. This is what ``Method(schedule="auto")`` ranks
candidate schedules with before the measured fallback.

The reference's ``analysis``, ``piecewise`` and ``report`` modules serve
its LM substrate and are not ported yet (ROADMAP.md, port order item 8).
"""
from .pso_cost import (DEFAULT_CALIBRATION, Calibration, IterCost, OpMix,
                       RuleMix, estimate_us_per_iter, fit_calibration,
                       fitness_op_mix, iteration_cost, rule_op_mix)

__all__ = ["Calibration", "DEFAULT_CALIBRATION", "IterCost", "OpMix",
           "RuleMix", "estimate_us_per_iter", "fit_calibration",
           "fitness_op_mix", "iteration_cost", "rule_op_mix"]
