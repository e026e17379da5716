"""Sequential SPSO in numpy, the port of ``repro.core.serial``: the paper's
Algorithm 1, the CPU-serial baseline of Tables 3-5.

It stays numpy on purpose: it is the host baseline the card is measured
against, not a torch path. ``SerialSwarm`` runs Alg. 1 as written (the
particle loop is sequential and gbest updates inside it, so particle i+1
sees what particle i improved in the same iteration); ``run_serial_fast``
keeps Alg. 1's per-iteration work but vectorizes the particle loop, with
synchronous gbest semantics, for timing. Both draw from a numpy mirror of
the counter RNG (``core/rng.py``), so trajectories are comparable with the
parallel variants.

The six built-ins are evaluated in numpy; any other objective through its
torch ``max_fn`` on a CPU tensor (correctness over speed: the serial path
is a baseline, not a hot path). A constrained Problem takes the engine's
constrained init (projection, or the repair redraws from the same counter
RNG) and, in projection mode, the projection after every advance, through
its torch operators on CPU tensors.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .pso import (PSOConfig, STREAM_INIT_POS, STREAM_INIT_VEL, STREAM_R1,
                  STREAM_R2)

_U32 = np.uint32


def _mix(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> _U32(16))
    x = (x * _U32(0x85EBCA6B)).astype(_U32)
    x = x ^ (x >> _U32(13))
    x = (x * _U32(0xC2B2AE35)).astype(_U32)
    x = x ^ (x >> _U32(16))
    return x


def _hash_u32(seed, iteration, stream, index):
    with np.errstate(over="ignore"):
        seed = _U32(seed)
        iteration = _U32(iteration)
        stream = _U32(stream)
        index = np.asarray(index, dtype=_U32)
        h = (seed * _U32(0x9E3779B9) + iteration * _U32(0x85EBCA6B)
             + stream * _U32(0xC2B2AE35)
             + index * _U32(0x27D4EB2F)).astype(_U32)
        h = _mix(h)
        h = _mix(h ^ (index * _U32(0x9E3779B9)
                      + iteration * _U32(0xC2B2AE35)).astype(_U32))
    return h


def _uniform(seed, iteration, stream, index, dtype=np.float32):
    bits = _hash_u32(seed, iteration, stream, index)
    dtype = np.dtype(dtype)
    return (bits >> _U32(8)).astype(dtype) * dtype.type(1.0 / (1 << 24))


def _np_bound(v, dt):
    """Bound -> numpy operand: scalars stay Python floats, per-dimension
    tuples become [D] arrays."""
    return v if isinstance(v, (int, float)) else np.asarray(v, dt)


def _fitness(cfg: PSOConfig, pos: np.ndarray) -> np.ndarray:
    """Numpy fitness of the six built-ins (the same operations as
    ``core.fitness``); any other objective through its torch ``max_fn``."""
    x = pos
    name = cfg.fitness
    if not isinstance(name, str):
        return _torch_fitness(name.max_fn, pos)
    if name == "cubic":
        return np.sum(x * x * x - 0.8 * (x * x) - 1000.0 * x + 8000.0, axis=-1)
    if name == "sphere":
        return -np.sum(x * x, axis=-1)
    if name == "rosenbrock":
        if x.shape[-1] == 1:
            return -np.squeeze((1.0 - x) ** 2, axis=-1)
        a, b = x[..., :-1], x[..., 1:]
        return -np.sum(100.0 * (b - a * a) ** 2 + (1.0 - a) ** 2, axis=-1)
    if name == "griewank":
        d = x.shape[-1]
        idx = np.arange(1, d + 1, dtype=x.dtype)
        return -(np.sum(x * x, axis=-1) / 4000.0
                 - np.prod(np.cos(x / np.sqrt(idx)), axis=-1) + 1.0)
    if name == "rastrigin":
        d = x.shape[-1]
        return -(10.0 * d + np.sum(x * x - 10.0 * np.cos(2 * np.pi * x),
                                   axis=-1))
    if name == "ackley":
        d = x.shape[-1]
        s1 = np.sqrt(np.sum(x * x, axis=-1) / d)
        s2 = np.sum(np.cos(2 * np.pi * x), axis=-1) / d
        return -(-20.0 * np.exp(-0.2 * s1) - np.exp(s2) + 20.0 + np.e)
    # any other registered name resolves through the registry
    return _torch_fitness(cfg.problem.max_fn, pos)


def _torch_fitness(max_fn, pos: np.ndarray) -> np.ndarray:
    return max_fn(torch.from_numpy(np.ascontiguousarray(pos))).numpy()


def _projection(cfg: PSOConfig):
    """The problem's feasibility projection, numpy in and out, or None
    (every mode but "projection")."""
    proj = cfg.problem.projection_fn
    if proj is None:
        return None
    return lambda pos: proj(torch.from_numpy(
        np.ascontiguousarray(pos))).numpy().astype(pos.dtype)


def _constrained_init(cfg: PSOConfig, pos: np.ndarray, seed: int, lo, span,
                      idx: np.ndarray, dt) -> np.ndarray:
    """``init_swarm``'s constrained init on numpy: the projection, or the
    repair redraws through ``constraints.repair_init_positions`` (its
    counter RNG is this module's numpy mirror, bit for bit)."""
    prob = cfg.problem
    proj = _projection(cfg)
    if proj is not None:
        return proj(pos)
    if not (prob.constrained and prob.constraints.mode == "repair"):
        return pos
    from .constraints import repair_init_positions

    def operand(v):
        return v if isinstance(v, float) else torch.from_numpy(
            np.asarray(v, dt))
    return repair_init_positions(
        prob.constraints, prob.violation_fn, torch.from_numpy(pos),
        operand(lo), operand(span), seed, STREAM_INIT_POS,
        torch.from_numpy(idx.astype(np.int64)), getattr(torch, dt.name)
    ).numpy().astype(pos.dtype)


class SerialSwarm:
    """Alg. 1 state + sequential iteration."""

    def __init__(self, cfg: PSOConfig, seed: int = 0):
        cfg = cfg.resolved()
        self.cfg = cfg
        self.seed = seed
        n, d = cfg.particle_cnt, cfg.dim
        dt = np.dtype(cfg.dtype)
        idx = np.arange(n * d, dtype=_U32).reshape(n, d)
        lo, hi = _np_bound(cfg.min_pos, dt), _np_bound(cfg.max_pos, dt)
        mv = _np_bound(cfg.max_v, dt)
        span = hi - lo
        self.pos = lo + span * _uniform(seed, 0, STREAM_INIT_POS, idx, dt)
        self.pos = _constrained_init(cfg, self.pos, seed, lo, span, idx, dt)
        self._project = _projection(cfg)
        self.vel = -mv + 2 * mv * _uniform(seed, 0, STREAM_INIT_VEL, idx, dt)
        self.fit = _fitness(cfg, self.pos)
        self.pbest_pos = self.pos.copy()
        self.pbest_fit = self.fit.copy()
        b = int(np.argmax(self.fit))
        self.gbest_pos = self.pos[b].copy()
        self.gbest_fit = float(self.fit[b])
        self.iteration = 0

    def step(self) -> None:
        """One sequential iteration: the inner loop of Alg. 1 lines 8-20."""
        cfg = self.cfg
        n, d = self.pos.shape
        it = self.iteration + 1
        idx = np.arange(n * d, dtype=_U32).reshape(n, d)
        r1 = _uniform(self.seed, it, STREAM_R1, idx, self.pos.dtype)
        r2 = _uniform(self.seed, it, STREAM_R2, idx, self.pos.dtype)
        for i in range(n):  # sequential: later particles see updated gbest
            v = (cfg.w * self.vel[i]
                 + cfg.c1 * r1[i] * (self.pbest_pos[i] - self.pos[i])
                 + cfg.c2 * r2[i] * (self.gbest_pos - self.pos[i]))
            mv = _np_bound(cfg.max_v, v.dtype)
            v = np.clip(v, -mv, mv)
            p = np.clip(self.pos[i] + v, _np_bound(cfg.min_pos, v.dtype),
                        _np_bound(cfg.max_pos, v.dtype))
            if self._project is not None:   # post-advance feasibility hook
                p = self._project(p[None])[0]
            f = float(_fitness(cfg, p[None])[0])
            self.vel[i] = v
            self.pos[i] = p
            self.fit[i] = f
            if f > self.pbest_fit[i]:                 # Alg. 1 step 4
                self.pbest_fit[i] = f
                self.pbest_pos[i] = p
                if f > self.gbest_fit:                # Alg. 1 step 5
                    self.gbest_fit = f
                    self.gbest_pos = p.copy()
        self.iteration = it

    def run(self, iters: int) -> Tuple[float, np.ndarray]:
        for _ in range(iters):
            self.step()
        return self.gbest_fit, self.gbest_pos


def run_serial_fast(cfg: PSOConfig, seed: int,
                    iters: int) -> Tuple[float, np.ndarray]:
    """Vectorized-numpy serial baseline for timing.

    Keeps Alg. 1's per-iteration work (a full pbest argmax every iteration,
    as the paper's CPU version) but vectorizes the particle loop so the
    Python interpreter is not what is measured. Synchronous gbest
    semantics: the same work per iteration as the paper's serial C code,
    which is what the speed-up tables compare."""
    cfg = cfg.resolved()
    n, d = cfg.particle_cnt, cfg.dim
    dt = np.dtype(cfg.dtype)
    idx = np.arange(n * d, dtype=_U32).reshape(n, d)
    lo, hi = _np_bound(cfg.min_pos, dt), _np_bound(cfg.max_pos, dt)
    mv = _np_bound(cfg.max_v, dt)
    span = hi - lo
    pos = lo + span * _uniform(seed, 0, STREAM_INIT_POS, idx, dt)
    pos = _constrained_init(cfg, pos, seed, lo, span, idx, dt)
    project = _projection(cfg)
    vel = -mv + 2 * mv * _uniform(seed, 0, STREAM_INIT_VEL, idx, dt)
    fit = _fitness(cfg, pos)
    pbest_pos, pbest_fit = pos.copy(), fit.copy()
    b = int(np.argmax(fit))
    gbest_pos, gbest_fit = pos[b].copy(), float(fit[b])
    for it in range(1, iters + 1):
        r1 = _uniform(seed, it, STREAM_R1, idx, dt)
        r2 = _uniform(seed, it, STREAM_R2, idx, dt)
        vel = (cfg.w * vel + cfg.c1 * r1 * (pbest_pos - pos)
               + cfg.c2 * r2 * (gbest_pos[None] - pos))
        np.clip(vel, -mv, mv, out=vel)
        pos = np.clip(pos + vel, lo, hi)
        if project is not None:
            pos = project(pos)
        fit = _fitness(cfg, pos)
        m = fit > pbest_fit
        pbest_fit = np.where(m, fit, pbest_fit)
        pbest_pos = np.where(m[:, None], pos, pbest_pos)
        b = int(np.argmax(pbest_fit))
        if pbest_fit[b] > gbest_fit:
            gbest_fit = float(pbest_fit[b])
            gbest_pos = pbest_pos[b].copy()
    return gbest_fit, gbest_pos
