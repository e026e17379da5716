"""Serving, the port of ``repro.serving``: continuous batching, the lane
program cache, metrics.

Three layers over the flush server in ``repro_torch.launch.serve``:

* ``scheduler.ContinuousScheduler``: persistent batched async lanes with
  chunk-boundary admission (the streaming front end); on the kernel
  backend a lane lives in the kernels' layout and a chunk is one CUDA
  graph replay (``kernels.ops.AsyncLane``).
* ``compile_cache.CompileCache``: a manifest of lane programs, rebuilt at
  ``prewarm()``, so a restarted replica serves its first request with no
  build on the request path.
* ``metrics.ServingMetrics``: queue/compile/dispatch/solve latency spans
  (p50/p99), batch-fill and preemption counters, JSON snapshots.
"""
from .compile_cache import CompileCache
from .metrics import LatencyStat, ServingMetrics
from .scheduler import ContinuousScheduler

__all__ = ["CompileCache", "ContinuousScheduler", "LatencyStat",
           "ServingMetrics"]
