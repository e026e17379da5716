"""The plain reference of the benchmark's solves, in plain PyTorch.

It imports nothing of the measured program and takes nothing the program
made: given the configuration, the traffic and the seeds, it draws the
initial swarms itself, runs the paper's update (Alg. 1, paper Table 1's
coefficients) in float32 and folds pbest and gbest as the traffic's variant
defines them (``variants/<variant>.py``), one batch of swarms at a time,
with the configuration's objective (``objectives/<name>.py``). The counter
RNG, the initial draw and the update are frozen copies of the algorithm's
definitions (a uint32 hash of (seed, iteration, stream, element index),
held in int64 and masked), so both sides draw the same numbers from the
same seeds.
"""
from __future__ import annotations

from typing import Sequence

import torch

from pso_bench.spec import load_module

_M = 0xFFFFFFFF
_W0 = 0x9E3779B9
_W1 = 0x85EBCA6B
_W2 = 0xC2B2AE35
_W3 = 0x27D4EB2F

STREAM_INIT_POS = 0
STREAM_INIT_VEL = 1
STREAM_R1 = 2
STREAM_R2 = 3


def _mix(x: torch.Tensor) -> torch.Tensor:
    """murmur3's fmix32 on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = (x * _W1) & _M
    x = x ^ (x >> 13)
    x = (x * _W2) & _M
    return x ^ (x >> 16)


def hash_u32(seed: torch.Tensor, iteration: int, stream: int,
             index: torch.Tensor) -> torch.Tensor:
    """The uint32 hash (in int64) of (seed [S, 1, 1], iteration, stream,
    index [N, D]): a Weyl sum of the components, two fmix32 rounds."""
    h = ((seed * _W0) & _M) + ((iteration * _W1) & _M) \
        + ((stream * _W2) & _M)
    h = (h + ((index * _W3) & _M)) & _M
    h = _mix(h)
    return _mix(h ^ ((((index * _W0) & _M) + ((iteration * _W2) & _M))
                     & _M))


def uniform(seed, iteration, stream, index) -> torch.Tensor:
    """Uniform float32 in [0, 1): the hash's top 24 bits times 2^-24."""
    bits = hash_u32(seed, iteration, stream, index)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def best(fit: torch.Tensor, pos: torch.Tensor):
    """(fit, pos) of the first maximum of ``fit`` [..., K] over K."""
    i = torch.argmax(fit, dim=-1, keepdim=True)
    p = pos.gather(-2, i[..., None].expand(*i.shape, pos.shape[-1]))
    return fit.gather(-1, i)[..., 0], p[..., 0, :]


class Swarms:
    """S swarms' float32 state: pos, vel, pbest_pos [S, N, D], pbest_fit
    [S, N], gbest_pos [S, D], gbest_fit [S]; ``seeds`` [S, 1, 1]."""

    def __init__(self, seeds, pos, vel, fit):
        self.seeds = seeds
        self.pos, self.vel = pos, vel
        self.pbest_pos, self.pbest_fit = pos, fit
        self.gbest_fit, self.gbest_pos = best(fit, pos)


class Reference:
    """The solves of one configuration (``configs/<name>.json``: ``dim``,
    ``particles``, the box [lo, hi], the velocity limit ``max_v``, the
    coefficients ``w``, ``c1``, ``c2``, ``block_n``) with the objective
    ``objective`` (``objectives/<name>.py``), on ``device``."""

    def __init__(self, cfg: dict, objective: str, device="cpu"):
        self.d, self.n = int(cfg["dim"]), int(cfg["particles"])
        self.lo, self.hi, self.mv = cfg["lo"], cfg["hi"], cfg["max_v"]
        self.w, self.c1, self.c2 = cfg["w"], cfg["c1"], cfg["c2"]
        self.block_n = int(cfg["block_n"])
        self.objective = load_module("objectives", objective).f32
        self.device = torch.device(device)
        self.index = torch.arange(self.d * self.n, dtype=torch.int64,
                                  device=self.device).reshape(self.n, self.d)

    def init(self, seeds: Sequence[int]) -> Swarms:
        """The initial swarms of ``seeds``: positions uniform in the box,
        velocities uniform in [-max_v, max_v]."""
        sd = torch.tensor([int(s) & _M for s in seeds], dtype=torch.int64,
                          device=self.device).reshape(-1, 1, 1)
        u_pos = uniform(sd, 0, STREAM_INIT_POS, self.index)
        u_vel = uniform(sd, 0, STREAM_INIT_VEL, self.index)
        pos = self.lo + (self.hi - self.lo) * u_pos
        vel = -self.mv + (2.0 * self.mv) * u_vel
        return Swarms(sd, pos, vel, self.objective(pos))

    def draws(self, s: Swarms, it: int):
        """The two uniform draws (r1, r2) [S, N, D] of iteration ``it``."""
        return (uniform(s.seeds, it, STREAM_R1, self.index),
                uniform(s.seeds, it, STREAM_R2, self.index))

    def move(self, s: Swarms, it: int, attractor):
        """Alg. 1's velocity and position update for iteration ``it``,
        against ``attractor`` (broadcast to [S, N, D]), and the pbest fold;
        returns the new fitness."""
        r1, r2 = self.draws(s, it)
        vel = (self.w * s.vel + self.c1 * r1 * (s.pbest_pos - s.pos)
               + self.c2 * r2 * (attractor - s.pos))
        s.vel = torch.clamp(vel, -self.mv, self.mv)
        s.pos = torch.clamp(s.pos + s.vel, self.lo, self.hi)
        fit = self.objective(s.pos)
        better = fit > s.pbest_fit
        s.pbest_fit = torch.where(better, fit, s.pbest_fit)
        s.pbest_pos = torch.where(better[..., None], s.pos, s.pbest_pos)
        return fit

    @staticmethod
    def take(s: Swarms, fit, pos):
        """gbest takes the first best of ``fit`` [S, K] (at ``pos``) where
        it is greater."""
        bf, bp = best(fit, pos)
        take = bf > s.gbest_fit
        s.gbest_fit = torch.where(take, bf, s.gbest_fit)
        s.gbest_pos = torch.where(take[..., None], bp, s.gbest_pos)

    def run(self, seeds: Sequence[int], iters: int, traffic: dict) -> Swarms:
        """``iters`` iterations of the traffic's variant
        (``variants/<variant>.py``) from the initial swarms of ``seeds``."""
        variant = load_module("variants", traffic["variant"])
        return variant.run(self, self.init(seeds), iters, traffic)
