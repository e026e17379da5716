"""The PSO engine in PyTorch: config, state, RNG, objectives, rules, and
the batched multi-swarm engine."""
from .multi_swarm import (SwarmBatch, batch_row, best_of_batch, init_batch,
                          run_many, solve_many)

__all__ = ["SwarmBatch", "batch_row", "best_of_batch", "init_batch",
           "run_many", "solve_many"]
