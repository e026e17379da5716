"""Analytic per-iteration FLOP/byte cost model of the PSO engines, the port
of ``repro.roofline.pso_cost``.

The cuPSO result is a *schedule* result: the async variant wins by trading
gbest memory traffic against synchronisation frequency, and the crossover
depends on (problem, d, n, block_n, sync_every), not only on the
algorithm. This module prices one PSO iteration of every engine the port
ships, so ``repro_torch.core.autotune`` can rank candidate schedules
before measuring the top few:

  * eager engines: ``reduction | queue | queue_lock | async`` of
    ``repro_torch.core.pso`` (batched by ``batch=S``), priced exactly as
    the reference prices its ``backend="jnp"`` engines;
  * CUDA kernels: ``queue`` (a launch an iteration), ``queue_lock`` (the
    fused kernel, every iteration in one launch) and ``async`` (blocks
    resident, a boundary every ``sync_every``), and their batched forms
    (``kernels/csrc/pso_step.cu``); any Problem that is not one of the six
    unconstrained built-ins runs the split path (``kernels/pso_split.py``).

Three ingredient families, as in the reference:

1. **Fitness op mix**: ``FITNESS_MIX`` counts the adds/muls and
   transcendentals each built-in objective spends per particle-dimension
   (the reference's table). A custom ``Problem`` is counted by running its
   ``max_fn`` once on the CPU at ``(_MEASURE_N, d)`` under a
   ``TorchDispatchMode`` (``_OpCounter``): an elementwise op counts its
   output's elements, a reduction its input's, the named transcendental
   ops count as transcendentals. The reference reads XLA's
   ``cost_analysis`` of the jitted function at the same shape; both are
   cached per ``Problem.cache_key()``.

2. **Traffic**: per-iteration device bytes, with the gbest publication
   traffic split out (``IterCost.gbest_bytes``): the async variants'
   pull and publish per block per chunk divides by ``sync_every``.

3. **Scheduling**: synchronisation points and host dispatches an
   iteration. On the kernel backend these count what the CUDA kernels
   synchronise on, which is not what the TPU's grid steps were:

   * ``queue_lock`` (the fused kernel): every block arrives at one
     grid-wide barrier an iteration, so ``grid_steps = nb``; with one block
     there is no barrier and ``grid_steps = 0`` (the reference: 1);
   * ``async``: every block passes one seqlock boundary a chunk,
     ``grid_steps = nb / sync_every`` (as the reference); the CUDA kernel
     streams pos, vel and pbest from device memory every iteration, so its
     state bytes do NOT divide by ``sync_every`` (the reference's TPU
     kernel keeps a block resident in VMEM over a chunk);
   * ``queue``: a launch an iteration, ``grid_steps = nb`` and one
     dispatch (as the reference);
   * the split path (a non-built-in Problem): two normal launches an
     iteration (the advance, and the fold with the cross-block stage in
     its last block) around the user's torch step, so
     ``dispatches = 2 +`` the step's torch calls (``torch_step_calls``),
     ``grid_steps = 0`` and no hoisted-const bytes (``const_operand_bytes``
     is 0: nothing is lowered into a kernel; the reference streams the
     adapter's consts).

``Calibration`` turns counts into microseconds. ``DEFAULT_CALIBRATION``
keeps the reference's constants (a CPU running XLA); ``default_calibration``
returns the card's on a CUDA device, one set for the kernels and one for
the eager engine, whose every torch op is a launch from the host: one set
of constants cannot price both (the reference's jnp engine is one compiled
program). ``fit_calibration`` fits constants from a benchmark document
(table3 records the eager throughput terms, async_sweep records the
per-synchronisation constant), refusing a document whose recorded
``host``/``cpu_count``/``device_kind`` disagree with this process.
"""
from __future__ import annotations

import dataclasses
import json
import os
import platform
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

DTYPE_BYTES = {"float32": 4, "float64": 8, "bfloat16": 2, "float16": 2}

#: Default fraction of iterations on which the swarm best improves at
#: steady state: the paper's queue-algorithm premise (§4.1: <0.1%; a
#: conservative 2% so early-run behaviour is not underpriced).
RARE_IMPROVE = 0.02

# --- advance (velocity/position update) op counts, per particle-dim -----
#: w*vel + c1*r1*(pbest-pos) + c2*r2*(gbest-pos): 5 mul + 4 add/sub.
VEL_FLOPS = 9
#: clip(vel) (2) + pos += vel (1) + clip(pos) (2).
POS_FLOPS = 5
#: pbest_pos where-select per element.
PBEST_SELECT_FLOPS = 1
#: per-particle pbest compare + fit select.
PBEST_FLOPS_PER_PARTICLE = 2
#: uniform draws per particle-dim per iteration (r1, r2).
RNG_DRAWS = 2
#: switch bookkeeping per kernel block for hetero dispatch.
HETERO_SWITCH_FLOPS = 16.0
#: launches an iteration of the split path (advance, fold and publish).
SPLIT_LAUNCHES = 2

BACKENDS = ("eager", "kernel")


@dataclasses.dataclass(frozen=True)
class RuleMix:
    """Advance-op mix of one update rule, per particle-dim.

    The aggregation scaffold (queues, local bests, publication) is
    rule-independent; only the velocity/position chain and the RNG draw
    count change with ``PSOConfig(update_rule=...)``. Counted from the
    ``core.update_rules`` source expressions the same way ``FITNESS_MIX``
    counts the objectives."""

    vel_flops: float
    pos_flops: float
    rng_draws: int = RNG_DRAWS


#:   pso      w v + c1 r1 (p-x) + c2 r2 (g-x); clip; x+v; clip  -> 9 + 5
#:   sso      fresh = lo+(hi-lo)r2 (3); 3 cmp+select (6); clip (2); no vel
#:   lowcost  2 sub + 2 cmp + 2 select + 2 add (8); clips as pso (5)
RULE_MIX: Dict[str, RuleMix] = {
    "pso": RuleMix(VEL_FLOPS, POS_FLOPS),
    "sso": RuleMix(0.0, 11.0),
    "lowcost": RuleMix(8.0, POS_FLOPS),
}


def rule_op_mix(rule) -> RuleMix:
    """Mix for a rule name/instance; unlisted custom rules price as the
    canonical chain with their own declared ``rng_draws``."""
    from ..core.update_rules import resolve_rule

    r = resolve_rule(rule)
    mix = RULE_MIX.get(r.name)
    if mix is None:
        mix = RuleMix(VEL_FLOPS, POS_FLOPS, r.rng_draws)
    return mix


@dataclasses.dataclass(frozen=True)
class OpMix:
    """Arithmetic mix of one objective evaluation.

    ``flops_per_dim`` counts adds/muls per particle per dimension (the sum
    reduction's add is folded in); ``transc_per_dim`` counts cos/exp/sqrt
    the same way; the ``*_per_particle`` fields hold the reduction tail
    (negation, scalar combines) paid once per particle.
    """

    flops_per_dim: float
    flops_per_particle: float = 0.0
    transc_per_dim: float = 0.0
    transc_per_particle: float = 0.0

    def flops(self, d: int, n: int) -> float:
        return n * (d * self.flops_per_dim + self.flops_per_particle)

    def transcendentals(self, d: int, n: int) -> float:
        return n * (d * self.transc_per_dim + self.transc_per_particle)


#: Op mix of the six built-ins, counted from their source expressions
#: (the reference's table, golden-filed in tests/test_torch_roofline.py):
#:   cubic      x³-0.8x²-1000x+8000 : 5 mul + 3 add + sum  -> 9/dim
#:   sphere     -Σx²                : 1 mul + sum          -> 2/dim + negate
#:   rosenbrock Σ100(b-a²)²+(1-a)²  : 4 mul + 4 add        -> 8/dim + negate
#:   griewank   Σx²/4000 - Πcos(x/√i) + 1 : 3 flops + div + cos per dim
#:   rastrigin  10d + Σ(x²-10cos2πx): 4 flops + cos-scale per dim
#:   ackley     -20e^(-.2√(Σx²/d)) - e^(Σcos2πx/d) + 20 + e
FITNESS_MIX: Dict[str, OpMix] = {
    "cubic": OpMix(9.0, 0.0),
    "sphere": OpMix(2.0, 1.0),
    "rosenbrock": OpMix(8.0, 1.0),
    "griewank": OpMix(4.0, 4.0, 1.0),
    "rastrigin": OpMix(5.0, 3.0, 1.0),
    "ackley": OpMix(4.0, 7.0, 1.0, 3.0),
}

_MEASURE_N = 64  # reference particle count for custom-objective accounting

#: aten ops counted as transcendentals (``pow`` too, with a non-integer
#: exponent), as XLA's cost analysis counts them.
_TRANSCENDENTAL = frozenset({"cos", "sin", "tan", "exp", "exp2", "expm1",
                             "log", "log2", "log10", "log1p", "sqrt",
                             "rsqrt", "tanh", "sigmoid", "erf", "atan",
                             "acos", "asin"})
#: aten ops that reduce: they count their input's elements.
_REDUCTIONS = frozenset({"sum", "prod", "mean", "amax", "amin", "max",
                         "min", "argmax", "argmin", "norm",
                         "linalg_vector_norm", "logsumexp", "var", "std",
                         "cumsum", "cumprod", "sort", "topk"})
#: aten ops that compute nothing: creation and copies.
_NO_WORK = frozenset({"arange", "zeros", "ones", "empty", "full",
                      "zeros_like", "ones_like", "empty_like", "full_like",
                      "scalar_tensor", "lift_fresh", "lift_fresh_copy",
                      "_to_copy", "copy", "clone", "detach",
                      "_local_scalar_dense"})


def _numel(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else 0


class _OpCounter(TorchDispatchMode):
    """Counts the work of the torch ops dispatched under it: elements of
    arithmetic (an elementwise op its output's, a reduction its input's),
    elements of transcendental ops, and the ops that compute (``calls``:
    each a launch on the card). Views and creation ops count nothing."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.transc = 0
        self.calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self._count(func, args, out)
        return out

    @staticmethod
    def _is_view(func) -> bool:
        schema = func._schema
        return (not schema.is_mutable
                and any(r.alias_info is not None for r in schema.returns))

    def _count(self, func, args, out) -> None:
        name = func.overloadpacket.__name__.rstrip("_")
        if self._is_view(func) or name in _NO_WORK:
            return
        first = _numel(args[0]) if args else 0
        result = _numel(out[0] if isinstance(out, (tuple, list)) else out)
        if name in _REDUCTIONS:
            self.flops += first
        elif name in _TRANSCENDENTAL or (
                name == "pow" and len(args) > 1
                and not isinstance(args[1], torch.Tensor)
                and float(args[1]) != int(args[1])):
            self.transc += result
        else:
            self.flops += result
        self.calls += 1


_MEASURED: Dict[Tuple[str, int, str], Tuple[OpMix, int]] = {}


def _measured(prob, d: int, dtype: str) -> Tuple[OpMix, int]:
    """(op mix, torch calls) of one evaluation of ``prob.max_fn`` at
    ``(_MEASURE_N, d)`` on the CPU, cached per content hash."""
    key = (prob.cache_key(), d, dtype)
    got = _MEASURED.get(key)
    if got is None:
        x = torch.rand(_MEASURE_N, d, dtype=getattr(torch, dtype),
                       generator=torch.Generator().manual_seed(0))
        counter = _OpCounter()
        with counter:
            prob.max_fn(x)
        elems = _MEASURE_N * d
        got = (OpMix(flops_per_dim=counter.flops / elems,
                     transc_per_dim=counter.transc / elems), counter.calls)
        _MEASURED[key] = got
    return got


def fitness_op_mix(problem, d: int, dtype: str = "float32") -> OpMix:
    """Op mix for a registered name or ``Problem`` (measured fallback)."""
    from ..core.problem import resolve_problem

    prob = resolve_problem(problem)
    mix = FITNESS_MIX.get(prob.name)
    if mix is not None and not prob.constrained:
        return mix
    if mix is not None and prob.constrained:
        # penalty mode evaluates the violation alongside the objective;
        # approximate the combined cost as 2x the raw mix.
        return OpMix(2 * mix.flops_per_dim, 2 * mix.flops_per_particle + 4,
                     2 * mix.transc_per_dim, 2 * mix.transc_per_particle)
    return _measured(prob, d, dtype)[0]


def torch_step_calls(problem, d: int, dtype: str = "float32") -> int:
    """Torch ops one evaluation of the objective dispatches: on the card
    each is a launch of the split path's torch step."""
    from ..core.problem import resolve_problem

    return _measured(resolve_problem(problem), d, dtype)[1]


def const_operand_bytes(problem, d: int, block_n: int,
                        dtype: str = "float32") -> float:
    """Bytes of hoisted const operands a kernel streams per block step:
    always 0 in the port. The built-ins' kernels take none, and every other
    Problem runs the split path, where the user's torch step reads its own
    tensors (counted in its op mix) and nothing is lowered into a kernel."""
    del problem, d, block_n, dtype
    return 0.0


@dataclasses.dataclass(frozen=True)
class IterCost:
    """Priced work of ONE PSO iteration (whole batch, all swarms).

    ``gbest_bytes`` (publication traffic) and ``const_bytes`` (const
    streaming, 0 in the port) are *subsets* of ``bytes_hbm``, split out
    because they are the schedule-sensitive terms."""

    flops: float
    transcendentals: float
    bytes_hbm: float
    gbest_bytes: float
    const_bytes: float
    grid_steps: float      # block arrivals at a synchronisation point
    dispatches: float      # host dispatches per iteration


def _blocks(n: int, block_n: Optional[int], backend: str) -> Tuple[int, int]:
    from ..core.blocking import pick_block_n

    bn = block_n or pick_block_n(n, lane=(128 if backend == "kernel" else 1))
    return bn, max(1, n // bn)


def _builtin(problem) -> bool:
    from ..core.fitness import is_builtin
    from ..core.problem import resolve_problem

    return is_builtin(resolve_problem(problem))


def fused_grid_steps(nb: int) -> float:
    """The fused kernel's block arrivals at its grid-wide barrier an
    iteration: every block, and none with one block (no barrier)."""
    return float(nb) if nb > 1 else 0.0


def iteration_cost(variant: str, problem, d: int, n: int, *,
                   dtype: str = "float32", backend: str = "eager",
                   block_n: Optional[int] = None, sync_every: int = 8,
                   batch: int = 1, hetero_table: int = 0,
                   rule: str = "pso",
                   rare: float = RARE_IMPROVE) -> IterCost:
    """Price one iteration of ``variant`` on ``backend``.

    The eager backend's counts are the reference's ``backend="jnp"``
    counts exactly. ``hetero_table > 0`` marks a heterogeneous batch with
    that many table members: the eager engine evaluates every member for
    every row (fitness cost times the table size), the kernels switch once
    a block. The kernel backend's scheduling terms follow the CUDA kernels
    (module docstring). All counts scale linearly with ``batch``.
    """
    from ..core.pso import VARIANTS

    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if backend == "kernel" and variant == "reduction":
        raise ValueError("no reduction kernel exists")
    b = DTYPE_BYTES[dtype]
    sync_every = max(1, sync_every)
    mix = fitness_op_mix(problem, d, dtype)
    bn, nb = _blocks(n, block_n, backend)
    split = backend == "kernel" and not _builtin(problem)

    # --- flops ------------------------------------------------------------
    fit_mult = max(1, hetero_table) if backend == "eager" else 1
    fit_flops = fit_mult * mix.flops(d, n)
    transc = fit_mult * mix.transcendentals(d, n)
    rmix = rule_op_mix(rule)
    adv = n * d * (rmix.vel_flops + rmix.pos_flops + PBEST_SELECT_FLOPS)
    pbest = n * PBEST_FLOPS_PER_PARTICLE
    if variant == "reduction":
        agg = n + d + 1                      # unconditional argmax + gather
    elif variant in ("queue", "queue_lock"):
        agg = 2 * n + rare * (2 * n + d)     # cmp + any; rare argmax+gather
    else:  # async: per-block argmax every iter, publish every sync_every
        agg = n + nb * (1 + d) + (nb + d) / sync_every
    flops = fit_flops + adv + pbest + agg
    if backend == "kernel" and hetero_table:
        flops += HETERO_SWITCH_FLOPS * nb

    # --- bytes ------------------------------------------------------------
    # pos/vel/pbest_pos read+write (6 n d) + materialized r1/r2 (2 n d);
    # fit/pbest_fit read+write (4 n). The CUDA kernels stream the state
    # every iteration in both variants.
    state = b * (8 * n * d + 4 * n)
    if variant == "reduction":
        gbest = b * (d + 1) * 2
    elif variant in ("queue", "queue_lock"):
        gbest = b * (d + 1) * (1 + rare)
    else:
        # pull + predicated publish per block per chunk, plus the per-
        # iteration block-local best maintenance (read+select per block).
        gbest = (b * 2 * (d + 1) * nb / sync_every
                 + b * 2 * (d + 1) * nb)
    const_traffic = 0.0
    bytes_hbm = state + gbest + const_traffic

    # --- scheduling -------------------------------------------------------
    if backend == "eager":
        grid_steps, dispatches = 0.0, 0.0    # as the reference's jnp engine
    elif split:
        grid_steps = 0.0
        dispatches = float(SPLIT_LAUNCHES + torch_step_calls(problem, d,
                                                             dtype))
    elif variant == "queue":
        grid_steps, dispatches = float(nb), 1.0   # a launch an iteration
    elif variant == "queue_lock":
        grid_steps, dispatches = fused_grid_steps(nb), 0.0
    else:
        grid_steps, dispatches = nb / sync_every, 0.0

    s = max(1, batch)
    return IterCost(flops=s * flops, transcendentals=s * transc,
                    bytes_hbm=s * bytes_hbm, gbest_bytes=s * gbest,
                    const_bytes=s * const_traffic,
                    grid_steps=s * grid_steps, dispatches=s * dispatches)


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Machine constants that turn an ``IterCost`` into microseconds.

    Defaults are the reference's: a mid-range CPU running jit-compiled XLA
    with Pallas in interpret mode. ``default_calibration`` gives the card's;
    ``fit_calibration`` fits constants from benchmark records."""

    flops_per_us: float = 1500.0      # effective element-op throughput
    bytes_per_us: float = 6000.0      # effective stream bandwidth
    iter_overhead_us: float = 0.35    # loop/bookkeeping per iteration
    dispatch_us: float = 50.0         # host -> device dispatch
    grid_step_us: float = 25.0        # per synchronisation arrival
    transcendental_flops: float = 8.0  # one cos/exp ~ this many flops
    rng_flops: float = 12.0           # one counter-RNG draw, per element
    source: str = "default"

    def us_per_iter(self, cost: IterCost, rng_elems: float = 0.0) -> float:
        """Roofline estimate: max(compute, memory) + scheduling terms."""
        flops = (cost.flops
                 + cost.transcendentals * self.transcendental_flops
                 + rng_elems * self.rng_flops)
        work = max(flops / self.flops_per_us,
                   cost.bytes_hbm / self.bytes_per_us)
        return (self.iter_overhead_us + work
                + cost.grid_steps * self.grid_step_us
                + cost.dispatches * self.dispatch_us)


DEFAULT_CALIBRATION = Calibration()

#: The kernels on the card (``source="cuda-default"``). The throughput
#: terms are an H100 SXM's data-sheet peaks, the rates chip_smoke.py's
#: bounds use: 3.35 TB/s of HBM, and 67 TFLOP/s of float32 counting an FMA
#: as two operations, so 33.5e6 single operations a microsecond (the
#: kernels contract no FMA). The scheduling terms are chip_smoke.py phase
#: 10c's fit on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit
#: (nvidia-smi --query-gpu=name,power.limit): the per-arrival
#: synchronisation cost from the async_sweep records, the per-iteration
#: overhead the median residual of those records, the dispatch cost from
#: the split path's custom sphere (d=8, n=1024).
CUDA_CALIBRATION = Calibration(
    flops_per_us=33.5e6,        # H100 SXM data sheet
    bytes_per_us=3.35e6,        # H100 SXM data sheet
    iter_overhead_us=1.481,     # NVIDIA H100 80GB HBM3, 700.00 W, phase 10c
    dispatch_us=42.38,          # NVIDIA H100 80GB HBM3, 700.00 W, phase 10c
    grid_step_us=0.004559,      # NVIDIA H100 80GB HBM3, 700.00 W, phase 10c
    source="cuda-default")
#: The eager engine on the card (``source="cuda-eager-default"``): the
#: kernels' constants with the throughput and per-iteration terms that
#: phase 10c fits from the eager table3 records (cubic d=1; NVIDIA H100
#: 80GB HBM3, 700.00 W). Every torch op of an eager iteration is a launch
#: from the host, so the per-iteration term carries the host's time.
CUDA_EAGER_CALIBRATION = dataclasses.replace(
    CUDA_CALIBRATION,
    flops_per_us=1.4315e5,      # NVIDIA H100 80GB HBM3, 700.00 W, phase 10c
    iter_overhead_us=1300.9,    # NVIDIA H100 80GB HBM3, 700.00 W, phase 10c
    source="cuda-eager-default")


def default_calibration(device=None, backend: str = "kernel") -> Calibration:
    """The machine constants of ``backend`` on ``device``: the reference's
    ``DEFAULT_CALIBRATION`` off the card (``device`` None means the CPU
    here), and on a CUDA device the card's: ``CUDA_CALIBRATION`` for the
    kernels, ``CUDA_EAGER_CALIBRATION`` for the eager engine."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if device is None or torch.device(device).type != "cuda":
        return DEFAULT_CALIBRATION
    return CUDA_CALIBRATION if backend == "kernel" else CUDA_EAGER_CALIBRATION


def estimate_us_per_iter(variant: str, problem, d: int, n: int, *,
                         dtype: str = "float32", backend: str = "eager",
                         block_n: Optional[int] = None, sync_every: int = 8,
                         batch: int = 1, hetero_table: int = 0,
                         rule: str = "pso",
                         calib: Calibration = DEFAULT_CALIBRATION) -> float:
    """One-call convenience: ``iteration_cost`` -> microseconds."""
    cost = iteration_cost(variant, problem, d, n, dtype=dtype,
                          backend=backend, block_n=block_n,
                          sync_every=sync_every, batch=batch,
                          hetero_table=hetero_table, rule=rule)
    return calib.us_per_iter(
        cost, rng_elems=batch * n * d * rule_op_mix(rule).rng_draws)


# --------------------------------------------------------------------------
# Calibration fitting from benchmark records.
# --------------------------------------------------------------------------

def device_kind(device=None) -> str:
    """The kind of ``device`` (None: this process's, the card if it has
    one): the card's name on a CUDA device, ``"cpu"`` otherwise. Benchmark
    documents record it, and the autotuner's cache scopes name it."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def _host_fingerprint() -> Dict[str, object]:
    return {"host": os.environ.get("BENCH_HOST_ID") or platform.node(),
            "cpu_count": os.cpu_count(), "device_kind": device_kind()}


def hosts_comparable(meta: Dict) -> bool:
    """True unless the artifact records host metadata that disagrees with
    this process. Artifacts predating the cpu_count/device_kind fields are
    treated as unknown-but-usable (the fit is marked unverified)."""
    fp = _host_fingerprint()
    for key in ("cpu_count", "device_kind", "host"):
        if meta.get(key) is not None and fp.get(key) is not None \
                and meta[key] != fp[key]:
            return False
    return True


def _fit_jnp_terms(records: Dict[str, Dict]) -> Optional[Tuple[float, float]]:
    """(flops_per_us, iter_overhead_us) from table3 eager records (d=1
    cubic, flop-bound: the memory term is not separately identifiable
    there)."""
    rows = []
    for name, rec in records.items():
        parts = name.split("/")
        if (len(parts) != 3 or parts[0] != "table3"
                or parts[2] not in ("reduction", "queue", "queue_lock")):
            continue
        n = int(parts[1].lstrip("p"))
        cost = iteration_cost(parts[2], "cubic", 1, n)
        flops = (cost.flops + RNG_DRAWS * n * 1 *
                 DEFAULT_CALIBRATION.rng_flops)
        rows.append((flops, rec["us_per_call"]))
    if len(rows) < 3:
        return None
    a = np.array([[f, 1.0] for f, _ in rows])
    y = np.array([t for _, t in rows])
    (inv_f, c), *_ = np.linalg.lstsq(a, y, rcond=None)
    if inv_f <= 0:
        return None
    return 1.0 / inv_f, max(float(c), 0.0)


def _fit_grid_step(records: Dict[str, Dict]) -> Optional[float]:
    """Per-arrival microseconds from the async_sweep kernel records:
    us/iter = base + grid_step_us * arrivals, with the async kernel's
    ``blocks / sync_every`` arrivals and the fused kernel's
    (``sync_kernel``) ``fused_grid_steps(blocks)``."""
    rows = []
    for name, rec in records.items():
        parts = name.split("/")
        if (len(parts) != 3 or parts[0] != "async_sweep"
                or "_b" not in parts[1]):
            continue
        try:
            nb = (int(parts[1].split("_n")[1].split("_b")[0])
                  // int(parts[1].split("_b")[1]))
        except (IndexError, ValueError):
            continue
        if parts[2] == "sync_kernel":
            rows.append((fused_grid_steps(nb), rec["us_per_call"]))
        elif parts[2].startswith("sync_every_"):
            k = int(parts[2].rsplit("_", 1)[1])
            rows.append((nb / k, rec["us_per_call"]))
    if len(rows) < 2:
        return None
    a = np.array([[g, 1.0] for g, _ in rows])
    y = np.array([t for _, t in rows])
    (g, _base), *_ = np.linalg.lstsq(a, y, rcond=None)
    return float(g) if g > 0 else None


def fit_calibration(bench: Union[str, Dict, None],
                    base: Optional[Calibration] = None) -> Calibration:
    """Fit machine constants from a benchmark document or its path.

    The fitted terms replace those of ``base`` (default: the constants of
    this process's device, ``default_calibration``), which is returned
    when the artifact is missing or unreadable, and with a source naming
    the reason when the artifact's recorded host fingerprint
    (``host``/``cpu_count``/``device_kind``) disagrees with this process:
    model fits must never mix hosts."""
    if base is None:
        base = default_calibration(
            "cuda" if torch.cuda.is_available() else "cpu")
    if bench is None:
        return base
    if isinstance(bench, str):
        try:
            with open(bench) as f:
                bench = json.load(f)
        except (OSError, ValueError):
            return base
    meta = bench.get("meta", {})
    if not hosts_comparable(meta):
        return dataclasses.replace(
            base, source=f"default(host-mismatch:{meta.get('host')})")
    records = {r["name"]: r for r in bench.get("benchmarks", [])
               if r.get("us_per_call", 0) > 0}
    kw = {}
    jnp_fit = _fit_jnp_terms(records)
    if jnp_fit is not None:
        kw["flops_per_us"], kw["iter_overhead_us"] = jnp_fit
    grid = _fit_grid_step(records)
    if grid is not None:
        kw["grid_step_us"] = grid
    if not kw:
        return base
    verified = all(meta.get(k) is not None
                   for k in ("cpu_count", "device_kind"))
    src = "bench-fit" if verified else "bench-fit(unverified-host)"
    return dataclasses.replace(base, source=src, **kw)
