"""The PSO engine in PyTorch: config, state, RNG, objectives, constraints,
rules, the batched multi-swarm engine, the lbest topologies, the numpy
serial baseline and the coefficient tuner. Re-exports every name of
``repro.core``."""
from .blocking import LANE, pick_block_n
from .fitness import (BUILTIN_PROBLEMS, DEFAULT_BOUNDS, FITNESS_FNS,
                      FITNESS_IDS)
from .constraints import (Constraint, ConstraintSet, constrain_problem,
                          constraint_from_spec, constraint_set_from_cli,
                          project_simplex, simplex_constraints)
from .problem import (Problem, get_problem, list_problems, register_problem,
                      resolve_problem)
from .pso import (ASYNC_SYNC_EVERY, STEP_FNS, VARIANTS, PSOConfig,
                  SwarmState, flush_async_locals, init_async_locals,
                  init_swarm, publish_async_locals, run, run_async,
                  run_with_history, solve, step_async, step_queue,
                  step_queue_lock, step_reduction)
from .multi_swarm import (MIN_VALIDATED_SWARMS, SwarmBatch, batch_row,
                          best_of_batch, init_batch, run_many, solve_many,
                          stack_states)
from .serial import SerialSwarm, run_serial_fast
from .topology import block_neighbor_best, grid_dims
from .tuner import (PSO_COEFF_DIMS, PSOTuner, SearchDim, TunerResult,
                    make_solve_many_fitness)
from .update_rules import (TOPOLOGIES, UPDATE_RULES, UpdateRule,
                           resolve_rule, rule_names)

__all__ = [
    "FITNESS_FNS", "FITNESS_IDS", "DEFAULT_BOUNDS", "BUILTIN_PROBLEMS",
    "Problem", "register_problem", "get_problem", "list_problems",
    "resolve_problem", "LANE", "pick_block_n",
    "Constraint", "ConstraintSet", "constrain_problem",
    "constraint_from_spec", "constraint_set_from_cli", "project_simplex",
    "simplex_constraints",
    "PSOConfig", "SwarmState", "STEP_FNS", "VARIANTS", "ASYNC_SYNC_EVERY",
    "init_swarm", "run", "solve", "run_async", "run_with_history",
    "step_async",
    "init_async_locals", "publish_async_locals", "flush_async_locals",
    "step_queue", "step_queue_lock", "step_reduction",
    "SwarmBatch", "init_batch", "batch_row", "stack_states", "run_many",
    "solve_many", "best_of_batch", "MIN_VALIDATED_SWARMS",
    "SerialSwarm", "run_serial_fast",
    "block_neighbor_best", "grid_dims",
    "UpdateRule", "UPDATE_RULES", "TOPOLOGIES", "resolve_rule",
    "rule_names",
    "PSOTuner", "SearchDim", "TunerResult", "PSO_COEFF_DIMS",
    "make_solve_many_fitness",
]
