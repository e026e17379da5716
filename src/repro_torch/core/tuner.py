"""PSO as a black-box (hyperparameter) tuner, the port of
``repro.core.tuner``.

A particle is a point in a box-constrained search space (e.g. log-lr,
warmup fraction, PSO's own coefficients). Fitness is any callable
``params -> score`` (higher is better). The swarm runs in numpy, seeded as
the reference's, so ``ask()`` gives the reference's populations for the
same seed: populations are tens of points, and the evaluations are the
device work.

``make_solve_many_fitness`` scores PSO coefficient candidates ``(w, c1,
c2)``: the whole population x probe-seed grid is one
``core.multi_swarm.solve_many`` call with per-swarm coefficients, on
``device`` (``None``: the card).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .pso import ASYNC_SYNC_EVERY, PSOConfig

Array = np.ndarray


@dataclasses.dataclass(frozen=True)
class SearchDim:
    """One tunable hyperparameter."""
    name: str
    low: float
    high: float
    log: bool = False     # search in log10 space

    def to_user(self, unit: Array) -> Array:
        """unit in [0,1] -> user-space value."""
        if self.log:
            lo, hi = np.log10(self.low), np.log10(self.high)
            return 10.0 ** (lo + unit * (hi - lo))
        return self.low + unit * (self.high - self.low)


@dataclasses.dataclass
class TunerResult:
    best_params: Dict[str, float]
    best_fitness: float
    history: List[Tuple[int, float]]          # (iteration, gbest_fit)
    evaluations: int


class PSOTuner:
    """Synchronous-population PSO over a hyperparameter box, in unit space
    [0,1]^D (paper Alg. 1 with synchronous gbest and the queue predicate:
    gbest moves only when a fitness beats it)."""

    def __init__(self, dims: Sequence[SearchDim], particles: int = 16,
                 w: float = 0.7, c1: float = 1.5, c2: float = 1.5,
                 seed: int = 0):
        self.dims = list(dims)
        self.n = particles
        self.w, self.c1, self.c2 = w, c1, c2
        self.rng = np.random.default_rng(seed)
        d = len(self.dims)
        self.pos = self.rng.uniform(size=(particles, d))
        self.vel = self.rng.uniform(-0.25, 0.25, size=(particles, d))
        self.pbest_pos = self.pos.copy()
        self.pbest_fit = np.full(particles, -np.inf)
        self.gbest_pos = self.pos[0].copy()
        self.gbest_fit = -np.inf
        self.evaluations = 0

    def _decode(self, unit_row: Array) -> Dict[str, float]:
        return {d.name: float(d.to_user(unit_row[i]))
                for i, d in enumerate(self.dims)}

    def ask(self) -> List[Dict[str, float]]:
        """Current population in user space (for external batch evaluation)."""
        return [self._decode(self.pos[i]) for i in range(self.n)]

    def tell(self, fits: Sequence[float]) -> None:
        """Report fitness for the population returned by the last ask()."""
        fits = np.asarray(fits, dtype=np.float64)
        self.evaluations += len(fits)
        improved = fits > self.pbest_fit
        self.pbest_fit = np.where(improved, fits, self.pbest_fit)
        self.pbest_pos = np.where(improved[:, None], self.pos, self.pbest_pos)
        if np.any(fits > self.gbest_fit):          # queue predicate
            b = int(np.argmax(fits))
            self.gbest_fit = float(fits[b])
            self.gbest_pos = self.pos[b].copy()
        d = len(self.dims)
        r1 = self.rng.uniform(size=(self.n, d))
        r2 = self.rng.uniform(size=(self.n, d))
        self.vel = (self.w * self.vel
                    + self.c1 * r1 * (self.pbest_pos - self.pos)
                    + self.c2 * r2 * (self.gbest_pos[None] - self.pos))
        np.clip(self.vel, -0.5, 0.5, out=self.vel)
        self.pos = np.clip(self.pos + self.vel, 0.0, 1.0)

    def run(self, fitness: Optional[Callable[[Dict[str, float]], float]] = None,
            iters: int = 10,
            callback: Optional[Callable[[int, "PSOTuner"], None]] = None,
            *, batch_fitness: Optional[
                Callable[[List[Dict[str, float]]], Sequence[float]]] = None
            ) -> TunerResult:
        """Optimize; exactly one of ``fitness`` / ``batch_fitness`` is given.
        ``batch_fitness(population) -> scores`` evaluates the whole
        population at once (``make_solve_many_fitness``)."""
        if (fitness is None) == (batch_fitness is None):
            raise ValueError("pass exactly one of fitness / batch_fitness")
        history: List[Tuple[int, float]] = []
        for it in range(iters):
            pop = self.ask()
            if batch_fitness is not None:
                fits = list(batch_fitness(pop))
            else:
                fits = [fitness(p) for p in pop]
            self.tell(fits)
            history.append((it, self.gbest_fit))
            if callback:
                callback(it, self)
        return TunerResult(best_params=self._decode(self.gbest_pos),
                           best_fitness=self.gbest_fit,
                           history=history, evaluations=self.evaluations)


PSO_COEFF_DIMS = (
    SearchDim("w", 0.3, 1.0),
    SearchDim("c1", 0.5, 2.5),
    SearchDim("c2", 0.5, 2.5),
)


def make_solve_many_fitness(cfg: PSOConfig, seeds: Sequence[int],
                            iters: int = 100, variant: str = "queue",
                            sync_every: Optional[int] = None, device=None):
    """Batch fitness scoring PSO coefficient candidates by ONE batched
    solve on ``device`` (``None``: the card).

    Each candidate ``{"w": ..., "c1": ..., "c2": ...}`` (missing keys fall
    back to ``cfg``) scores the mean final ``gbest_fit`` over the probe
    ``seeds``: P candidates x K seeds run as one ``solve_many`` of P*K
    swarms with per-swarm coefficients. Scores are in the engine's
    canonical maximization form, so any Problem, constrained ones
    included, ranks its candidates correctly. ``sync_every`` is the
    ``async`` variant's publication interval.
    """
    from .multi_swarm import solve_many

    if sync_every is None:
        sync_every = ASYNC_SYNC_EVERY
    cfg = cfg.resolved()
    seeds = np.asarray(seeds, dtype=np.int64)
    k = len(seeds)

    def batch_fitness(population: List[Dict[str, float]]) -> np.ndarray:
        p = len(population)
        all_seeds = np.tile(seeds, p)
        coeffs = tuple(np.repeat([c.get(name, getattr(cfg, name))
                                  for c in population], k).astype(np.float32)
                       for name in ("w", "c1", "c2"))
        batch = solve_many(cfg, all_seeds, iters=iters, variant=variant,
                           sync_every=sync_every, coeffs=coeffs,
                           device=device)
        fit = batch.gbest_fit.detach().cpu().numpy()
        return fit.reshape(p, k).mean(axis=1)

    return batch_fitness
