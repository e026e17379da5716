"""The LM substrate's layout tooling against the JAX reference on the CPU:
``models.unroll.maybe_scan`` (both modes), ``models.policy``'s activation
spec, ``launch.mesh``, the four spec functions of ``launch.sharding`` on
the reference's production meshes (16, 16) and (2, 16, 16), and
``zoo.abstract_params`` / ``abstract_cache`` against ``jax.eval_shape``,
for all ten archs at full size.

Everything here is exact: specs tuple for tuple (``tuple(P)``) with the
reference's ``keystr`` paths, shapes and dtypes leaf for leaf, and
``maybe_scan``'s outputs bit for bit (integer-valued float32 inputs, so
no sum depends on its order). The reference's spec functions read only
``mesh.shape`` and ``mesh.axis_names``, so the port's mesh descriptor
stands in for a ``jax.sharding.Mesh`` of 256 or 512 devices.
"""
import numpy as np
import pytest
import torch

from repro_torch import configs as t_configs
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import sharding as t_sh
from repro_torch.models import policy as t_policy
from repro_torch.models import unroll as t_unroll
from repro_torch.models import zoo as t_zoo
from repro_torch.optim import get_optimizer as t_get_optimizer

try:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec

    from repro import configs as j_configs
    from repro.launch import mesh as j_mesh
    from repro.launch import sharding as j_sh
    from repro.models import policy as j_policy
    from repro.models import unroll as j_unroll
    from repro.models import zoo as j_zoo
    from repro.optim import get_optimizer as j_get_optimizer
except ModuleNotFoundError:     # a CUDA host may have no JAX installed
    jax = None

ARCHS = t_configs.list_archs()
MESHES = {"16x16": t_mesh.make_production_mesh(),
          "2x16x16": t_mesh.make_production_mesh(multi_pod=True)}


@pytest.fixture(scope="module", autouse=True)
def reference():
    if jax is None:
        pytest.skip("needs the JAX reference package `repro`, and JAX is "
                    "not installed")


def _ref_specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return [(jax.tree_util.keystr(p), tuple(s)) for p, s in flat]


def _port_specs(tree):
    return [(p, tuple(s)) for p, s in t_sh.flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, t_sh.P))]


def _shapes(tree):
    return [(jax.tree_util.keystr(p), tuple(a.shape),
             str(a.dtype).split(".")[-1])
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]]


# --- unroll --------------------------------------------------------------------

@pytest.mark.parametrize("unroll", [False, True])
def test_maybe_scan_equals_reference(unroll):
    r = np.random.default_rng(3)
    a = r.integers(-4, 5, (5, 3)).astype(np.float32)
    b = r.integers(-4, 5, (5,)).astype(np.float32)

    def body(carry, x, np_=jnp):
        c = carry + np_.sum(x["a"]) * x["b"]
        return c, {"y": x["a"] * 2 + x["b"], "c": c}

    with j_unroll.unrolled(unroll):
        jc, jy = j_unroll.maybe_scan(body, jnp.float32(1), {
            "a": jnp.asarray(a), "b": jnp.asarray(b)})
    with t_unroll.unrolled(unroll):
        assert t_unroll.is_unrolled() == unroll
        tc, ty = t_unroll.maybe_scan(
            lambda c, x: body(c, x, torch), torch.tensor(1.0),
            {"a": torch.from_numpy(a), "b": torch.from_numpy(b)})
    assert not t_unroll.is_unrolled()
    assert float(tc) == float(jc)
    for k in ("y", "c"):
        np.testing.assert_array_equal(ty[k].numpy(), np.asarray(jy[k]))

    # length only, and a body with no outputs
    with j_unroll.unrolled(unroll):
        jc, jy = j_unroll.maybe_scan(lambda c, _: (c * 2, None),
                                     jnp.float32(3), None, length=4)
    tc, ty = t_unroll.maybe_scan(lambda c, _: (c * 2, None),
                                 torch.tensor(3.0), None, length=4)
    assert jy is None and ty is None and float(tc) == float(jc)


# --- mesh and policy -----------------------------------------------------------

def test_meshes():
    for name, mesh in MESHES.items():
        assert mesh.name == name
        assert t_mesh.data_axes(mesh) == j_mesh.data_axes(mesh)
    assert MESHES["16x16"].shape == {"data": 16, "model": 16}
    assert MESHES["2x16x16"].axis_names == ("pod", "data", "model")
    local = t_mesh.make_local_mesh()
    assert local.axis_names == ("data", "model")
    assert local.sizes == (max(torch.cuda.device_count(), 1), 1)


class _Shape:
    """A shape-only stand-in for the reference's ``constrain``."""

    def __init__(self, shape):
        self.shape, self.ndim = tuple(shape), len(shape)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_activation_spec_equals_reference(mesh_name, monkeypatch):
    """The spec ``repro.models.policy.constrain`` applies (captured from
    its ``with_sharding_constraint`` call) against ``activation_spec``, for
    each arch's activations at each shape cell; ``constrain`` itself
    returns ``x`` unchanged."""
    mesh = MESHES[mesh_name]
    seen = []
    monkeypatch.setattr(j_policy, "NamedSharding", lambda m, s: s)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: seen.append(tuple(s)) or x)
    dp, tp = t_mesh.data_axes(mesh), "model"
    layouts = [("dp", None, "tp"), ("dp", None, "tp", None),
               ("dp", None, None), ("dp", "tp"), (None, "tp")]
    n = 0
    for name in ARCHS:
        cfg = t_configs.get_arch(name)
        for cell in t_configs.SHAPES.values():
            b, s = cell.global_batch, cell.seq_len
            shapes = [(b, s, cfg.d_model), (b, s, cfg.n_heads,
                                            cfg.resolved_head_dim),
                      (b, s, cfg.vocab), (b * s, cfg.d_ff or cfg.d_model),
                      (b, cfg.n_kv_heads)]
            for shape in shapes:
                for layout in layouts:
                    if len(layout) != len(shape):
                        continue
                    with j_policy.activation_policy(mesh, dp, tp):
                        j_policy.constrain(_Shape(shape), layout)
                    assert t_policy.activation_spec(
                        shape, layout, mesh, dp, tp) == seen[-1]
                    n += 1
    assert len(seen) == n > 100
    x = torch.zeros(2, 3)
    with t_policy.activation_policy(mesh, dp, tp):
        assert t_policy.constrain(x, ("dp", "tp")) is x
    assert t_policy.constrain(x, ("dp", "tp")) is x


# --- abstract trees ------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_abstract_trees_equal_eval_shape(name):
    """``abstract_params`` and ``abstract_cache`` (meta tensors) against
    ``jax.eval_shape`` of the reference's, at full size: every leaf's
    path, shape and dtype, for every shape cell the arch supports."""
    cfg, ref = t_configs.get_arch(name), j_configs.get_arch(name)
    params = t_zoo.abstract_params(cfg)
    assert all(t.is_meta for t in jax.tree.leaves(params))
    assert _shapes(params) == _shapes(j_zoo.abstract_params(ref))
    for shape in t_configs.SHAPES:
        if not cfg.supports(shape):
            continue
        cache = t_zoo.abstract_cache(cfg, shape)
        assert all(t.is_meta for t in jax.tree.leaves(cache))
        assert _shapes(cache) == _shapes(j_zoo.abstract_cache(ref, shape))


# --- sharding ------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", ARCHS)
def test_specs_equal_reference(name, mesh_name):
    """``param_pspecs``, ``opt_pspecs`` (over the arch's own optimizer's
    state: Adam's ``.inner['m']``/``['v']`` trees or Adafactor's per-leaf
    ``vr``/``vc``/``v``/``m``), ``batch_pspecs`` and ``cache_pspecs`` for
    every shape cell, spec for spec."""
    mesh = MESHES[mesh_name]
    cfg, ref = t_configs.get_arch(name), j_configs.get_arch(name)
    t_params = t_zoo.abstract_params(cfg)
    j_params = j_zoo.abstract_params(ref)
    t_ps = t_sh.param_pspecs(cfg, t_params, mesh)
    j_ps = j_sh.param_pspecs(ref, j_params, mesh)
    assert _port_specs(t_ps) == _ref_specs(j_ps)

    t_opt = t_get_optimizer(cfg.optimizer)[0](t_params)
    j_opt = jax.eval_shape(j_get_optimizer(ref.optimizer)[0], j_params)
    got = _port_specs(t_sh.opt_pspecs(cfg, t_opt, mesh, t_ps))
    assert got == _ref_specs(j_sh.opt_pspecs(ref, j_opt, mesh, j_ps))
    assert any(s for _, s in got)

    for shape in t_configs.SHAPES:
        assert _port_specs(t_sh.batch_pspecs(cfg, shape, mesh)) == \
            _ref_specs(j_sh.batch_pspecs(ref, shape, mesh))
        if not cfg.supports(shape):
            continue
        got = _port_specs(t_sh.cache_pspecs(
            cfg, t_zoo.abstract_cache(cfg, shape), shape, mesh))
        assert got == _ref_specs(j_sh.cache_pspecs(
            ref, j_zoo.abstract_cache(ref, shape), shape, mesh))


def test_spec_overrides_equal_reference():
    """The per-arch levers the rules read: expert parallelism and
    row-parallel output projections."""
    import dataclasses
    mesh = MESHES["16x16"]
    for name, lever in (("arctic-480b", dict(moe_expert_sharding="ep")),
                        ("phi3.5-moe-42b-a6.6b",
                         dict(moe_expert_sharding="ep")),
                        ("qwen1.5-110b", dict(row_parallel_out=True)),
                        ("hymba-1.5b", dict(swa_window_decode=True))):
        cfg = dataclasses.replace(t_configs.get_arch(name), **lever)
        ref = dataclasses.replace(j_configs.get_arch(name), **lever)
        assert _port_specs(t_sh.param_pspecs(
            cfg, t_zoo.abstract_params(cfg), mesh)) == _ref_specs(
                j_sh.param_pspecs(ref, j_zoo.abstract_params(ref), mesh))
        got = _port_specs(t_sh.cache_pspecs(
            cfg, t_zoo.abstract_cache(cfg, "decode_32k"), "decode_32k",
            mesh))
        assert got == _ref_specs(j_sh.cache_pspecs(
            ref, j_zoo.abstract_cache(ref, "decode_32k"), "decode_32k",
            mesh))


def test_to_named_placements():
    """One placement a mesh axis: ``Shard(i)`` where dim i is split over
    it, else ``Replicate()``; a tuple entry shards one dim over several
    axes."""
    from torch.distributed.tensor import Replicate, Shard
    m2, m3 = MESHES["16x16"], MESHES["2x16x16"]
    assert t_sh.placements(t_sh.P("data", None, "model"), m2) == \
        (Shard(0), Shard(2))
    assert t_sh.placements(t_sh.P(), m2) == (Replicate(), Replicate())
    assert t_sh.placements(t_sh.P(("pod", "data"), None), m3) == \
        (Shard(0), Shard(0), Replicate())
    cfg = t_configs.get_arch("stablelm-3b")
    specs = t_sh.param_pspecs(cfg, t_zoo.abstract_params(cfg), m3)
    named = t_sh.to_named(specs, m3)
    for (path, spec), (path2, pl) in zip(
            _port_specs(specs), t_sh.flatten_with_path(
                named, is_leaf=lambda x: isinstance(x, tuple) and all(
                    isinstance(p, (Shard, Replicate)) for p in x))):
        assert path == path2 and len(pl) == 3
        for axis, p in zip(m3.axis_names, pl):
            on = [i for i, a in enumerate(spec)
                  if a == axis or (isinstance(a, tuple) and axis in a)]
            assert p == (Shard(on[0]) if on else Replicate())
