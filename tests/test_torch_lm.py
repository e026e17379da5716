"""The LM substrate's serving path (``repro_torch.configs``, ``models``,
``launch.steps``) against the JAX reference (``repro.configs``,
``repro.models``) on the CPU, at smoke size in float32, with the
reference's weights carried across by ``models.convert.params_from_jax``,
and the entry points' device rule (``None`` means the card). Its building
blocks: ``tests/test_torch_lm_blocks.py``; training:
``tests/test_torch_train.py``.

Inputs are made from numpy seeds. Tolerances, float32 throughout: whole
models (loss, decode logits) rtol = atol = 1e-4, sums over a few hundred
terms taken in other orders, through two to four layers and the
unembedding; configs equal field for field.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as t_configs
from repro_torch.launch import steps as t_steps
from repro_torch.models import convert
from repro_torch.models import zoo as t_zoo

try:
    import jax
    import jax.numpy as jnp

    from repro import configs as j_configs
    from repro.models import zoo as j_zoo
except ModuleNotFoundError:     # a CUDA host may have no JAX installed
    jax = None

torch.set_num_threads(1)

MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
#: One arch of each family: hybrid (SSD heads, SWA, meta tokens), xLSTM
#: (mLSTM/sLSTM), dense MHA, MLA, VLM prefix, MoE (top-2, and arctic's with
#: a dense residual), enc-dec (whisper: stub frames, cross-attention);
#: and the two dense GQA archs with qkv biases (qwen2-7b, qwen1.5-110b).
ARCHS = ["hymba-1.5b", "xlstm-350m", "stablelm-3b", "minicpm3-4b",
         "llava-next-34b", "phi3.5-moe-42b-a6.6b", "arctic-480b",
         "whisper-small", "qwen2-7b", "qwen1.5-110b"]


@pytest.fixture(scope="module", autouse=True)
def reference():
    if jax is None:
        pytest.skip("needs the JAX reference package `repro`, and JAX is "
                    "not installed")


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(r, *shape, scale=1.0):
    return (r.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind == "i"
                            else np.array(a))


def _close(got, want, tol=MODEL_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


# --- configs -----------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(j_configs.list_archs()) if jax
                         else [])
def test_config_equals_reference(name):
    want, got = j_configs.get_arch(name), t_configs.get_arch(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.smoke()) == dataclasses.asdict(want.smoke())
    for cfg, ref in ((got, want), (got.smoke(), want.smoke())):
        assert (cfg.resolved_head_dim, cfg.attention_free, cfg.subquadratic) \
            == (ref.resolved_head_dim, ref.attention_free, ref.subquadratic)
        assert [cfg.supports(s) for s in t_configs.SHAPES] == \
            [ref.supports(s) for s in j_configs.SHAPES]


def test_config_registry_equals_reference():
    assert t_configs.list_archs() == j_configs.list_archs()
    assert {k: dataclasses.asdict(v) for k, v in t_configs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in j_configs.SHAPES.items()}


# --- whole models ------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """One arch's smoke config, the reference's weights (seed 0) in both
    packages, and a batch from a numpy seed (B=2, S=64)."""
    name = request.param
    cfg_j = j_configs.get_arch(name).smoke()
    cfg = t_configs.get_arch(name).smoke()
    jp = j_zoo.init_params(cfg_j, jax.random.key(0))
    tree = jax.tree.map(np.asarray, jp)
    r = _rng(11)
    batch = {"tokens": r.integers(0, cfg.vocab, (2, 64)).astype(np.int32),
             "labels": r.integers(0, cfg.vocab, (2, 64)).astype(np.int32)}
    if cfg.vision_prefix:
        batch["vision_embeds"] = _normal(r, 2, cfg.vision_prefix,
                                         cfg.d_model)
    if cfg.encdec:
        batch["frames"] = _normal(r, 2, 64, cfg.d_model)
    return (cfg, cfg_j, jp, convert.params_from_jax(cfg, tree, "cpu"), batch,
            r)


def test_params_layout_equals_reference(arch):
    """The port's own init (a torch.Generator) gives the reference's tree,
    leaf for leaf in shape and dtype, and the carried weights equal the
    reference's."""
    cfg, _, jp, carried, _, _ = arch
    mine = t_zoo.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    want = jax.tree_util.tree_flatten_with_path(jp)[0]
    for tree in (mine, carried):
        got = jax.tree_util.tree_flatten_with_path(tree)[0]
        assert [p for p, _ in got] == [p for p, _ in want]
        assert [(tuple(a.shape), str(a.dtype).split(".")[-1])
                for _, a in got] == [(a.shape, str(a.dtype))
                                     for _, a in want]
    for (_, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(
            carried)[0], want):
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", ARCHS)
def test_full_width_params_layout_equals_reference(name):
    """At full width (bfloat16), the port's init on the meta device (no
    memory) against ``jax.eval_shape`` of the reference's: the same tree,
    shapes and dtypes."""
    cfg = t_configs.get_arch(name)
    want = jax.eval_shape(lambda: j_zoo.init_params(
        j_configs.get_arch(name), jax.random.key(0)))
    got = t_zoo.init_params(cfg, None, "meta")
    want = jax.tree_util.tree_flatten_with_path(want)[0]
    got = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    assert [(tuple(a.shape), str(a.dtype).split(".")[-1]) for _, a in got] \
        == [(a.shape, str(a.dtype)) for _, a in want]


def test_prefill_step_matches_reference(arch):
    """``make_prefill_step`` (the loss, forward only) against
    ``repro.models.zoo.loss_fn`` on the same weights and batch."""
    cfg, cfg_j, jp, params, batch, _ = arch
    want = jax.jit(lambda p, b: j_zoo.loss_fn(cfg_j, p, b))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    got = t_steps.make_prefill_step(cfg)(
        params, {k: _t(v) for k, v in batch.items()})
    assert got.dtype == torch.float32 and got.shape == ()
    _close(got, want, MODEL_TOL)


def test_serve_step_matches_reference(arch):
    """Four ``make_serve_step`` decode steps from ``init_cache`` against
    ``repro.models.zoo.decode_fn``: the logits of each, the same tokens
    fed to both."""
    cfg, cfg_j, jp, params, _, r = arch
    jc = j_zoo.init_cache(cfg_j, 2, 16)
    tc = t_zoo.init_cache(cfg, 2, 16, "cpu")
    assert [tuple(a.shape) for a in jax.tree.leaves(tc)] == \
        [a.shape for a in jax.tree.leaves(jc)]
    decode = jax.jit(lambda p, c, n, t: j_zoo.decode_fn(cfg_j, p, c, n, t))
    serve = t_steps.make_serve_step(cfg)
    for n in range(4):
        tok = r.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        want, jc = decode(jp, jc, jnp.int32(n), jnp.asarray(tok))
        got, tc = serve(params, tc, n, _t(tok))
        assert got.dtype == torch.float32
        assert tuple(got.shape) == (2, cfg.vocab)
        _close(got, want, MODEL_TOL)


def test_input_specs_and_batches_equal_reference():
    for name in t_configs.list_archs():
        cfg, ref = t_configs.get_arch(name), j_configs.get_arch(name)
        for shape in t_configs.SHAPES:
            got = t_zoo.input_specs(cfg, shape, override_batch=3)
            want = j_zoo.input_specs(ref, shape, override_batch=3)
            assert list(got) == list(want)
            assert [(tuple(g.shape), str(g.dtype).split(".")[-1])
                    for g in got.values()] == \
                [(w.shape, str(w.dtype)) for w in want.values()]
    cfg = t_configs.get_arch("llava-next-34b").smoke()
    for name in ("llava-next-34b", "whisper-small"):
        cfg = t_configs.get_arch(name).smoke()
        b = t_zoo.make_batch(cfg, "train_4k", 2, 40, torch.Generator(),
                             "cpu")
        want = j_zoo.make_batch(j_configs.get_arch(name).smoke(),
                                "train_4k", 2, 40, jax.random.key(0))
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in b.items()} == \
            {k: (v.shape, str(v.dtype)) for k, v in want.items()}


def test_entry_points_default_to_the_card():
    """``None`` means the card: without one, ``init_params``,
    ``init_cache``, ``make_batch``, ``tree_from_numpy`` and
    ``params_from_jax`` raise ``RuntimeError`` unless given ``device="cpu"``;
    a generator on another device than the one asked for raises
    ``ValueError``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card error cannot occur")
    gen = torch.Generator().manual_seed(0)
    for name in ("stablelm-3b", "phi3.5-moe-42b-a6.6b", "whisper-small"):
        cfg = t_configs.get_arch(name).smoke()
        calls = {
            "init_params": lambda d: t_zoo.init_params(cfg, gen, *d),
            "init_cache": lambda d: t_zoo.init_cache(cfg, 1, 8, *d),
            "make_batch": lambda d: t_zoo.make_batch(cfg, "train_4k", 1, 8,
                                                     gen, *d),
            "tree_from_numpy": lambda d: convert.tree_from_numpy(
                {"w": np.ones(3, np.float32)}, *d),
            "params_from_jax": lambda d: convert.params_from_jax(
                cfg, jax.tree.map(np.asarray, j_zoo.init_params(
                    j_configs.get_arch(name).smoke(), jax.random.key(0))),
                *d),
        }
        for what, call in calls.items():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call(())
            tree = call(("cpu",))
            leaves = jax.tree.leaves(tree)
            assert leaves and all(t.device.type == "cpu" for t in leaves
                                  if isinstance(t, torch.Tensor)), what
        with pytest.raises(ValueError, match="generator"):
            t_zoo.init_params(cfg, gen, "meta")
        with pytest.raises(ValueError, match="generator"):
            t_zoo.make_batch(cfg, "train_4k", 1, 8, gen, "meta")


def test_params_from_jax_refuses_another_config():
    cfg = t_configs.get_arch("stablelm-3b").smoke()
    tree = jax.tree.map(np.asarray, j_zoo.init_params(
        j_configs.get_arch("phi3.5-moe-42b-a6.6b").smoke(),
        jax.random.key(0)))
    with pytest.raises(ValueError, match="parameters"):
        convert.params_from_jax(cfg, tree, "cpu")
