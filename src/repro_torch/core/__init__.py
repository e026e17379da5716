"""The PSO engine in PyTorch: config, state, RNG, objectives, rules, the
batched multi-swarm engine, the lbest topologies, and the numpy serial
baseline."""
from .multi_swarm import (SwarmBatch, batch_row, best_of_batch, init_batch,
                          run_many, solve_many)
from .serial import SerialSwarm, run_serial_fast
from .topology import block_neighbor_best, grid_dims

__all__ = ["SwarmBatch", "batch_row", "best_of_batch", "init_batch",
           "run_many", "solve_many", "SerialSwarm", "run_serial_fast",
           "block_neighbor_best", "grid_dims"]
