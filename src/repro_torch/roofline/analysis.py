"""Roofline analysis for one H100, the port of ``repro.roofline.analysis``.

Three terms, in seconds, for a step on ``chips`` cards:

    compute    = flops_total       / (chips × PEAK_FLOPS)
    memory     = bytes_total       / (chips × HBM_BW)
    collective = coll_bytes_per_chip / NVLINK_BW

The reference reads these counts from XLA's ``cost_analysis`` of a
compiled TPU program and parses collectives out of its HLO. The port has
no HLO: it counts the torch ops themselves, dispatched under
``CostCounter`` (a ``TorchDispatchMode``), usually on the meta device,
where nothing is allocated or computed:

  * **flops** as XLA counts them: 2·M·N·K for every matmul, batched
    matmul and einsum product (``mm``/``bmm``/``addmm``/``baddbmm``, into
    which ``einsum`` and ``matmul`` decompose), one an output element for
    elementwise work, a reduction its input's elements, data movement
    (``cat``, ``index``, ``gather``, copies) none; transcendentals apart;
  * **bytes** as the eager port moves them: every op that is not a view
    reads its inputs once and writes its outputs once (a gather reads only
    the rows it takes, an indexed write only the rows it writes). This is
    unfused traffic, op by op, and not XLA's "bytes accessed" of a fused
    program, so it runs above what a fused kernel would move;
  * **collective bytes** by the reference's five kinds, the output bytes
    of every ``_c10d_functional`` collective: 0 on one card;
  * **peak live bytes**: every storage an op creates counts from that op
    until its last tensor is freed (a weak reference on the storage, which
    autograd's saved tensors keep alive), so the trace's peak is the
    memory it needs beyond its inputs.

``MODEL_FLOPS`` (the "useful work" yardstick): 6·N·D for training, 2·N·D
for prefill, 2·N_active·B for one decode token; MoE archs use active
params.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils import _pytree as pytree

from ..launch.sharding import flatten_with_path
from .pso_cost import _OpCounter

# H100 SXM data sheet ceilings, not measurements: dense BF16 on the tensor
# cores (the rate chip_smoke.py holds the bf16 GLA kernel to), HBM3
# bandwidth, and NVLink 4 bandwidth a direction (900 GB/s both ways).
PEAK_FLOPS = 989e12        # bf16 / card
HBM_BW = 3.35e12           # B/s / card
NVLINK_BW = 450e9          # B/s / card

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
#: ``_c10d_functional`` ops by the reference's collective kind.
_C10D = {"all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_coalesced": "all-gather",
         "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "all_to_all_single": "all-to-all"}
_MATMULS = frozenset({"mm", "bmm", "addmm", "baddbmm"})
#: ops that move data and compute nothing (XLA's concatenate, gather,
#: reverse, pad; the backward of a slice, a zero tensor with the slice
#: written in).
_MOVES = frozenset({"cat", "stack", "index", "gather", "flip",
                    "constant_pad_nd", "slice_backward", "select_backward",
                    "new_zeros", "new_ones"})
#: gathers: read the rows they take (their output) and their indices.
_GATHERS = frozenset({"index", "gather"})
#: an indexed write into a large tensor: reads and writes only its values.
_INDEX_WRITES = frozenset({"index_put"})
#: ops that allocate without writing.
_UNWRITTEN = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                        "new_empty_strided"})


def _tensors(tree):
    return [x for x in pytree.tree_leaves(tree)
            if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _read_bytes(t: torch.Tensor) -> int:
    """An input's bytes, at most its storage's (an expanded view reads its
    storage once)."""
    try:
        return min(_nbytes(t), t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):
        return _nbytes(t)


def _storage_key(t: torch.Tensor) -> Optional[int]:
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return None


class CostCounter(_OpCounter):
    """``_OpCounter`` (the PSO cost model's count of elementwise work and
    transcendentals) with matmul flops, bytes, collectives and peak live
    bytes (module docstring). ``live`` and ``peak`` count only storages
    made under the counter."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.mm_flops = 0             # the matmuls' share of ``flops``
        self.coll = {k: 0 for k in _COLLECTIVES}
        self.coll_count = 0
        self.live = 0
        self.peak = 0
        self._held: Dict[int, tuple] = {}

    def _free(self, key: int) -> None:
        got = self._held.pop(key, None)
        if got is not None:
            self.live -= got[1]

    def _hold(self, outs, ins) -> None:
        seen = {_storage_key(t) for t in ins}
        for t in outs:
            key = _storage_key(t)
            if key is None or key in seen or key in self._held:
                continue
            seen.add(key)
            st = t.untyped_storage()
            n = st.nbytes()
            self._held[key] = (weakref.ref(
                st, lambda _, key=key: self._free(key)), n)
            self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        name = func.overloadpacket.__name__.rstrip("_")
        if func.namespace == "_c10d_functional":
            kind = _C10D.get(name)
            if kind is not None:
                self.coll[kind] += sum(_nbytes(t) for t in outs)
                self.coll_count += 1
        elif name in _MATMULS:
            a, b = args[-2], args[-1]
            self.mm_flops += 2 * a.numel() * b.shape[-1]
            self.flops += 2 * a.numel() * b.shape[-1]
            if name in ("addmm", "baddbmm"):
                self.flops += outs[0].numel()
            self.calls += 1
        elif name in _MOVES:
            self.calls += 1
        else:
            self._count(func, args, out)
        if not self._is_view(func) and name not in _UNWRITTEN:
            if name in _GATHERS:
                read = sum(_nbytes(t) for t in outs) + sum(
                    _nbytes(t) for t in ins[1:]
                    if not t.is_floating_point())
            elif name in _INDEX_WRITES:
                values = args[2]
                read = _nbytes(values) + sum(_nbytes(t) for t in args[1]
                                             if t is not None)
                outs = [values]
            elif name == "copy":                  # the destination is written
                read = _read_bytes(args[1])
            else:
                read = sum(_read_bytes(t) for t in ins)
            self.bytes += read + sum(_nbytes(t) for t in outs)
        if not self._is_view(func):
            self._hold(_tensors(out), ins)
        return out

    def totals(self) -> Dict[str, float]:
        coll = dict(self.coll)
        coll["total"] = sum(self.coll.values())
        return {"flops": float(self.flops),
                "mm_flops": float(self.mm_flops), "transcendentals":
                float(self.transc), "bytes": float(self.bytes),
                "coll_bytes": float(coll["total"]),
                "coll_count": self.coll_count, "collectives": coll,
                "peak_bytes": float(self.peak)}


def count_params(params_shape: Any) -> int:
    return sum(int(leaf.numel()) for leaf in _tensors(params_shape))


def count_active_params(cfg, params_shape: Any) -> int:
    """MoE-aware: expert weights count at top_k/n_experts utilization."""
    total = 0
    for ps, leaf in flatten_with_path(params_shape):
        n = int(leaf.numel())
        if cfg.moe and "moe" in ps and any(
                w in ps for w in ("w_in", "w_out", "w_gate")):
            n = int(n * cfg.top_k / cfg.n_experts)
        total += n
    return total


def model_flops(cfg, params_shape: Any, kind: str, tokens: int) -> float:
    n_active = count_active_params(cfg, params_shape)
    # embedding lookups are gathers, not FLOPs: subtract the embed table
    embed = cfg.vocab * cfg.d_model
    n_mm = max(n_active - embed, 1)
    if kind == "train":
        return 6.0 * n_mm * tokens
    return 2.0 * n_mm * tokens          # prefill / decode forward


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_total: float
    bytes_total: float
    coll_bytes_per_chip: float
    coll_count: int
    model_flops: float
    mem_per_device: Optional[float] = None

    @property
    def t_compute(self) -> float:
        return self.flops_total / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.bytes_total / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_chip / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / max(self.flops_total, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """MODEL_FLOPS-based fraction of peak at the step's critical time."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        return (self.model_flops / (self.chips * PEAK_FLOPS)) / max(t, 1e-30)

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, bottleneck=self.bottleneck,
                 useful_ratio=self.useful_ratio,
                 roofline_fraction=self.roofline_fraction)
        return d


def analyze(arch: str, shape: str, mesh_name: str, chips: int,
            cost: Dict[str, float], cfg, params_shape, kind: str,
            tokens: int) -> Roofline:
    """The roofline of per-device counts ``cost`` (``piecewise.combine``'s
    dict: ``flops_dev``, ``bytes_dev``, ``coll_bytes_dev``,
    ``coll_count``, and ``mem_dev`` when known) on ``chips`` cards."""
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_total=float(cost["flops_dev"]) * chips,
        bytes_total=float(cost["bytes_dev"]) * chips,
        coll_bytes_per_chip=float(cost["coll_bytes_dev"]),
        coll_count=int(cost["coll_count"]),
        model_flops=model_flops(cfg, params_shape, kind, tokens),
        mem_per_device=cost.get("mem_dev"))
