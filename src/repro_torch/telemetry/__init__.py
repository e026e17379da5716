"""In-program solver telemetry, the port of ``repro.telemetry``.

1. **Kernel counters** (``counters``): the fused and async CUDA kernels
   optionally add per-swarm int32 event counts (queue updates, gbest
   publications, per-block pbest improvements) into a buffer the caller
   passes; with no buffer the kernels take a null pointer and count
   nothing. Their plain PyTorch versions count at the same program points
   (tests/test_torch_telemetry.py holds them to ``repro``'s oracles).
2. **Convergence traces**: ``Method(record_history=True)`` on every
   backend (``repro_torch.api``; ``core.pso.run_with_history``,
   ``core.multi_swarm.run_many_with_history``).
3. **Exporters** (``trace``, ``prometheus``): a Chrome/Perfetto
   ``trace.json`` writer and a Prometheus text-exposition renderer, the
   reference's, plus ``profiler_session`` on ``torch.profiler``.
4. **Program spans** (``trace.begin``/``end``): ``api.solve``,
   ``pso.init_swarm``, ``ops.pack``/``launch``/``unpack`` and ``api.read``,
   stamped on the profiler's clock, recorded under a ``torch.profiler``
   session or into a writer installed with ``recording``; ``spans()``
   returns them.
"""
from .counters import (COUNTER_NAMES, SLOTS_PER_SWARM, KernelCounters,
                       zero_counts)
from .prometheus import prometheus_text
from .trace import TraceWriter, profiler_session, recording, spans

__all__ = [
    "COUNTER_NAMES",
    "SLOTS_PER_SWARM",
    "KernelCounters",
    "zero_counts",
    "prometheus_text",
    "TraceWriter",
    "profiler_session",
    "recording",
    "spans",
]
