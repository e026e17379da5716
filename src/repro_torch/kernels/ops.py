"""Swarm-level wrappers around the main-path kernels, the port of the
``repro.kernels.ops`` single-swarm functions.

They translate between the engine's particle-major ``SwarmState`` and the
kernels' D-major operands, pick the block size, and chain the async
kernel's phases. Results match the eager ``repro_torch.core.pso`` variants
(``step_queue`` iterated for the fused kernel; ``run_async`` block
semantics for the async kernel).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.blocking import pick_block_n
from ..core.fitness import builtin_id
from ..core.pso import ASYNC_SYNC_EVERY, PSOConfig, SwarmState
from . import pso_step
from .pso_step import KernelSpec
# the phase split under the reference's name (repro.kernels.ops._async_spans)
from .pso_step import async_spans as _async_spans  # noqa: F401


def _resolve_block(n: int, block_n: Optional[int]) -> int:
    """Validate an explicit ``block_n`` or fall back to the heuristic pick."""
    bn = block_n or pick_block_n(n)
    if bn < 1 or n % bn:
        raise ValueError(
            f"block_n={bn} must be a positive divisor of particle_cnt={n}")
    return bn


def pack_dmajor(x: torch.Tensor) -> torch.Tensor:
    """[N, D] -> a new contiguous [D, N] (the kernels update it in place)."""
    return x.t().clone(memory_format=torch.contiguous_format)


def unpack_dmajor(arr: torch.Tensor) -> torch.Tensor:
    """[D, N] -> [N, D]."""
    return arr.t().contiguous()


def kernel_spec(cfg: PSOConfig) -> KernelSpec:
    """Static kernel operands from a config: the kernels carry the six
    built-in objectives and take float32 only."""
    cfg = cfg.resolved()
    if cfg.dtype != "float32":
        raise ValueError(f"the kernels take float32 only, not {cfg.dtype}")
    return KernelSpec(fitness=builtin_id(cfg.problem), rule=cfg.update_rule,
                      w=cfg.w, c1=cfg.c1, c2=cfg.c2, lo=cfg.min_pos,
                      hi=cfg.max_pos, mv=cfg.max_v)


def state_to_kernel(s: SwarmState):
    """SwarmState -> new D-major operands (pos, vel, pbp, pbf, gp, gf)."""
    return (pack_dmajor(s.pos), pack_dmajor(s.vel), pack_dmajor(s.pbest_pos),
            s.pbest_fit.clone(), s.gbest_pos.clone(),
            s.gbest_fit.reshape(1).clone())


def kernel_to_state(s: SwarmState, pos, vel, pbp, pbf, gp, gf,
                    iters: int) -> SwarmState:
    return s._replace(
        pos=unpack_dmajor(pos), vel=unpack_dmajor(vel),
        fit=pbf,  # the kernels do not keep the raw fit; pbest_fit >= fit
        pbest_pos=unpack_dmajor(pbp), pbest_fit=pbf,
        gbest_pos=gp, gbest_fit=gf[0], iteration=s.iteration + iters,
        lbest_pos=None, lbest_fit=None)


def run_queue_lock_fused(cfg: PSOConfig, s: SwarmState, iters: int,
                         block_n: Optional[int] = None) -> SwarmState:
    """``iters`` iterations of the fused queue-lock in ONE kernel launch
    (on a CUDA state; the plain version on a CPU state)."""
    cfg = cfg.resolved()
    n, _ = s.pos.shape
    bn = _resolve_block(n, block_n)
    ops = state_to_kernel(s)
    pso_step.fused(*ops, kernel_spec(cfg), seed=s.seed, iteration=s.iteration,
                   iters=iters, block_n=bn)
    return kernel_to_state(s, *ops, iters)


def run_queue_lock_fused_async(cfg: PSOConfig, s: SwarmState, iters: int,
                               sync_every: int = ASYNC_SYNC_EVERY,
                               block_n: Optional[int] = None) -> SwarmState:
    """``iters`` iterations of the ASYNC queue-lock: each particle block
    runs ``sync_every`` iterations per chunk against its block-local best,
    touching the shared gbest only at chunk boundaries. A state that
    carries block-local bests of the same block count resumes them. With a
    single block the result equals ``run_queue_lock_fused``."""
    cfg = cfg.resolved()
    n, _ = s.pos.shape
    bn = _resolve_block(n, block_n)
    nb = n // bn
    ops = state_to_kernel(s)
    gp, gf = ops[4], ops[5]
    if s.lbest_fit is not None and tuple(s.lbest_fit.shape) == (nb,):
        lp, lf = pack_dmajor(s.lbest_pos), s.lbest_fit.clone()
    else:
        lp = gp[:, None].repeat(1, nb)       # local bests seeded from gbest
        lf = gf.repeat(nb)
    pso_step.fused_async(*ops, lp, lf, kernel_spec(cfg), seed=s.seed,
                         iteration=s.iteration, iters=iters,
                         sync_every=sync_every, block_n=bn)
    out = kernel_to_state(s, *ops, iters)
    return out._replace(lbest_pos=unpack_dmajor(lp), lbest_fit=lf)
