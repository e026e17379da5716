"""Roofline analysis, the port of ``repro.roofline``. Two layers:

* ``analysis`` — the H100's ceilings (``PEAK_FLOPS``, ``HBM_BW``,
  ``NVLINK_BW``), the ``Roofline`` report, parameter and MODEL_FLOPS
  counting for the model zoo, and ``CostCounter``, the torch-op count
  (flops, unfused bytes, collectives, peak live bytes) that takes the
  place of XLA's ``cost_analysis``; ``piecewise`` builds a step's totals
  from one instance of each piece, counted on the meta device, and
  ``report`` renders the dry run's tables.
* ``pso_cost`` — the PSO cost model behind the schedule autotuner
  (``repro_torch.core.autotune``): per-iteration flop/byte counts for
  every engine variant (fitness op mix per built-in, gbest publication
  traffic as a function of ``sync_every``, the CUDA kernels'
  synchronisation points and dispatches) and the ``Calibration`` that
  turns them into microseconds on the CPU or the card. This is what
  ``Method(schedule="auto")`` ranks candidate schedules with before the
  measured fallback.
"""
from .analysis import (HBM_BW, NVLINK_BW, PEAK_FLOPS, CostCounter, Roofline,
                       analyze, count_active_params, count_params,
                       model_flops)
from .pso_cost import (DEFAULT_CALIBRATION, Calibration, IterCost, OpMix,
                       RuleMix, estimate_us_per_iter, fit_calibration,
                       fitness_op_mix, iteration_cost, rule_op_mix)

__all__ = ["Roofline", "analyze", "CostCounter", "count_params",
           "count_active_params", "model_flops", "PEAK_FLOPS", "HBM_BW",
           "NVLINK_BW", "Calibration", "DEFAULT_CALIBRATION", "IterCost",
           "OpMix", "RuleMix", "estimate_us_per_iter", "fit_calibration",
           "fitness_op_mix", "iteration_cost", "rule_op_mix"]
