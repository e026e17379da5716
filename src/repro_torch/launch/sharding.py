"""Sharding policy, the port of ``repro.launch.sharding``: partition specs
for params, optimizer states, batches and decode caches on a mesh
(``launch.mesh``), with the reference's rules, spec for spec.

Baseline policy (uniform, divisibility-guarded):
  * weight matrices — last dim over "model" (TP), previous dim over "data"
    (FSDP); leading stack dims (layer/group/expert) unsharded; vectors
    replicated. The "pod" axis is pure DP: params replicated across pods.
  * batch-like arrays — first dim over ("pod","data").
  * decode KV caches — batch over "data" when divisible, cache sequence
    over "model" (context parallelism); long_500k (batch=1) re-shards the
    sequence over ("data","model").
An axis is applied only when the dim divides the mesh extent, so the
policy is total over every (arch × shape × mesh) cell.

A spec is a ``P``: a tuple of axis names (or tuples of them, or None),
one entry a leading dim, the ``PartitionSpec`` analogue. The rules match
leaves by their path, written as ``jax.tree_util.keystr`` writes it
(``['layers']['attn']['wq']``, ``.inner['m']...`` under an ``OptState``),
since ``_count_stack_dims`` and ``opt_pspecs`` match substrings such as
``['m']``, ``['s']`` and ``['vr']``. ``to_named`` turns a spec into one
``torch.distributed.tensor`` placement a mesh axis (``Shard(i)`` or
``Replicate()``): plain data, no process group. On one card every spec
resolves to whole tensors.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

from ..configs.base import SHAPES, ArchConfig
from .mesh import data_axes


class P(tuple):
    """A partition spec: ``P("data", None)``; ``tuple(P(...))`` is the
    reference's ``tuple(PartitionSpec(...))``, which writes an entry of one
    axis, ``("data",)``, as the axis itself."""

    def __new__(cls, *axes):
        return super().__new__(cls, (a[0] if isinstance(a, tuple)
                                     and len(a) == 1 else a for a in axes))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map_with_path(fn: Callable[[str, Any], Any], tree, path: str = "",
                       is_leaf: Callable[[Any], bool] = lambda x: False):
    """``tree`` (dicts, lists, tuples, NamedTuples) rebuilt with each leaf
    replaced by ``fn(keystr, leaf)``, visited in jax's flattening order
    (dict keys sorted); None stays None."""
    if tree is None:
        return None
    if is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        out = {k: tree_map_with_path(fn, tree[k], f"{path}[{k!r}]", is_leaf)
               for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map_with_path(fn, getattr(tree, f),
                                               f"{path}.{f}", is_leaf)
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, f"{path}[{i}]", is_leaf)
                          for i, v in enumerate(tree))
    return fn(path, tree)


def flatten_with_path(tree, is_leaf=lambda x: False) -> List[Tuple[str, Any]]:
    """``[(keystr, leaf)]`` in jax's flattening order."""
    out: List[Tuple[str, Any]] = []
    tree_map_with_path(lambda p, x: out.append((p, x)), tree,
                       is_leaf=is_leaf)
    return out


def _is_spec(x) -> bool:
    return isinstance(x, P)


def _fits(dim: int, mesh, axis) -> bool:
    if axis is None:
        return True
    if isinstance(axis, tuple):
        total = 1
        for a in axis:
            total *= mesh.shape[a]
        return dim % total == 0
    return dim % mesh.shape[axis] == 0


def _matrix_spec(shape, mesh, n_stack: int,
                 model_axis="model", data_axis="data") -> P:
    """Generic weight rule: trailing dim → model, the one before → data."""
    ndim = len(shape)
    spec = [None] * ndim
    if ndim - n_stack >= 1:
        last = ndim - 1
        if _fits(shape[last], mesh, model_axis):
            spec[last] = model_axis
    if ndim - n_stack >= 2:
        prev = ndim - 2
        if _fits(shape[prev], mesh, data_axis):
            spec[prev] = data_axis
    return P(*spec)


def _count_stack_dims(path_str: str, cfg: ArchConfig) -> int:
    """Leading non-matmul dims: layer stacks, xlstm groups, moe experts."""
    n = 0
    if "layers" in path_str or "enc_layers" in path_str or "dec_layers" in path_str:
        n += 1
        if "['m']" in path_str and cfg.xlstm:
            n += 1                              # [G, g-1, ...]
    if "moe" in path_str and ("w_in" in path_str or "w_out" in path_str
                              or "w_gate" in path_str):
        n += 1                                  # expert dim
    return n


def _param_spec(cfg: ArchConfig, ps: str, shape, mesh) -> P:
    if len(shape) <= 1 + _count_stack_dims(ps, cfg):
        # vectors (norms, biases) possibly stacked: replicate
        return P()
    if cfg.moe and "moe" in ps and any(
            w in ps for w in ("w_in", "w_out", "w_gate")) \
            and cfg.moe_expert_sharding == "ep":
        # expert parallelism: E over model; FSDP the wider matmul dim
        nstack = _count_stack_dims(ps, cfg) - 1   # E handled explicitly
        spec = [None] * len(shape)
        e_dim = nstack                            # [..stack.., E, a, b]
        if _fits(shape[e_dim], mesh, "model"):
            spec[e_dim] = "model"
        if _fits(shape[e_dim + 1], mesh, "data"):
            spec[e_dim + 1] = "data"
        return P(*spec)
    if "embed" in ps or "unembed" in ps:
        # [V, d] / [d, V]: vocab→model, d→data
        big = 0 if shape[0] >= shape[1] else 1
        spec = [None, None]
        if _fits(shape[big], mesh, "model"):
            spec[big] = "model"
        if _fits(shape[1 - big], mesh, "data"):
            spec[1 - big] = "data"
        return P(*spec)
    if cfg.row_parallel_out and any(w in ps for w in ("wo", "w_out")):
        # Megatron row-parallel: contraction dim (ff / H*hd) over model,
        # output dim FSDP over data.
        nd = len(shape)
        spec = [None] * nd
        if _fits(shape[nd - 2], mesh, "model"):
            spec[nd - 2] = "model"
        if _fits(shape[nd - 1], mesh, "data"):
            spec[nd - 1] = "data"
        return P(*spec)
    return _matrix_spec(shape, mesh, _count_stack_dims(ps, cfg))


def param_pspecs(cfg: ArchConfig, params_shape: Any, mesh) -> Any:
    """Spec tree matching a param tree (tensors, meta tensors, or anything
    with ``.shape``)."""
    return tree_map_with_path(
        lambda ps, leaf: _param_spec(cfg, ps, tuple(leaf.shape), mesh),
        params_shape)


def opt_pspecs(cfg: ArchConfig, opt_shape: Any, mesh,
               param_specs: Any) -> Any:
    """Optimizer state specs: mirror the param spec where shapes match;
    adafactor's factored vectors inherit the surviving dims."""
    by_path = dict(flatten_with_path(param_specs, is_leaf=_is_spec))

    def spec_for(ps: str, leaf) -> P:
        # strip the optimizer wrapper levels: .inner['m']<param path>
        match = None
        for ppath, spec in by_path.items():
            if ps.endswith(ppath) or ppath in ps:
                match = (ppath, spec)
                break
        ndim = len(leaf.shape)
        if ndim == 0:
            return P()
        if match and len(match[1]) == ndim:
            return match[1]
        if match and len(match[1]) == ndim + 1:
            # factored row/col: drop the missing trailing/leading entry
            spec = list(match[1])
            if ps.endswith("['vr']") or "vr" in ps.rsplit("[", 1)[-1]:
                return P(*spec[:-1])
            return P(*(spec[:-2] + spec[-1:]))    # vc: drops dim -2
        return P()

    return tree_map_with_path(spec_for, opt_shape)


def batch_pspecs(cfg: ArchConfig, shape_name: str, mesh) -> Dict[str, P]:
    cell = SHAPES[shape_name]
    dp = data_axes(mesh)
    dp = dp if len(dp) > 1 else dp[0]
    b = cell.global_batch
    bdp = dp if _fits(b, mesh, dp) else None
    if cell.kind in ("train", "prefill"):
        spec: Dict[str, P] = {"tokens": P(bdp, None), "labels": P(bdp, None)}
        if cfg.encdec:
            spec["frames"] = P(bdp, None, None)
        if cfg.vision_prefix:
            spec["vision_embeds"] = P(bdp, None, None)
        return spec
    return {"token": P(bdp, None), "cache_len": P()}


def cache_pspecs(cfg: ArchConfig, cache_shape: Any, shape_name: str,
                 mesh) -> Any:
    """Decode caches: [L, B, S, ...] → B over data, S over model (context
    parallelism); batch=1 (long_500k) shards S over (data, model)."""
    cell = SHAPES[shape_name]

    def spec_for(ps: str, leaf) -> P:
        shape = tuple(leaf.shape)
        if cfg.xlstm or "ssm" in ps or "['s']" in ps:
            # recurrent states: shard batch dim if possible, else replicate
            spec = [None] * len(shape)
            for i, d in enumerate(shape):
                if d == cell.global_batch and _fits(d, mesh, "data"):
                    spec[i] = "data"
                    break
            return P(*spec)
        # KV-like: [L, B, S, K, hd] or [L, B, S, r]
        spec = [None] * len(shape)
        b_dim, s_dim = 1, 2
        if cfg.swa_window_decode and cfg.swa_window:
            # windowed decode reads are slices along S: keep the cache
            # unsharded on S (batch-sharded only) so the slice stays local.
            if _fits(shape[b_dim], mesh, "data"):
                spec[b_dim] = "data"
            return P(*spec)
        seq_axis: Any = "model"
        if cell.global_batch == 1:
            seq_axis = tuple(a for a in mesh.axis_names)  # all axes
            if not _fits(shape[s_dim], mesh, seq_axis):
                seq_axis = ("data", "model")
        elif _fits(shape[b_dim], mesh, "data"):
            spec[b_dim] = "data"
        if _fits(shape[s_dim], mesh, seq_axis):
            spec[s_dim] = seq_axis
        return P(*spec)

    return tree_map_with_path(spec_for, cache_shape)


def placements(spec: P, mesh) -> tuple:
    """One placement a mesh axis, in ``mesh.axis_names`` order: ``Shard(i)``
    where tensor dim ``i`` is split over that axis, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in mesh.axis_names:
        dims = [i for i, a in enumerate(spec)
                if a == axis or (isinstance(a, tuple) and axis in a)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def to_named(tree_specs: Any, mesh) -> Any:
    return tree_map_with_path(lambda _, s: placements(s, mesh), tree_specs,
                              is_leaf=_is_spec)
