"""The LM substrate's training path (``repro_torch.launch.steps.
make_train_step``: the loss and its gradients by autograd, the cosine lr,
the arch's optimizer, the grad norm) against the JAX reference's
``repro.launch.steps.make_train_step`` on the CPU, at smoke size in
float32 on the reference's weights (``models.convert``); then the three
remat modes, ``chunk_remat`` and ``flash_custom_vjp`` on the port. The
CLI and checkpoints of a training state: ``tests/test_torch_train_cli.py``.

Inputs are made from numpy seeds (B=2, S=64), the same batch every step,
base lr 1e-2, warmup 1, 10 steps in all: the first step's lr is 0 (the
schedule's warm-up), so the first step moves only the optimizer state and
the second the parameters. Tolerances, float32:
- loss and grad norm: rtol = 1e-5 (sums over a few hundred terms in other
  orders through two to four layers);
- Adam's m and v after each step: rtol = 1e-4, atol = 1e-6 (v holds g²);
- parameters after each step, by regime of the reference's |ĝ| =
  sqrt(v / (1 - b2^t)): where |ĝ| >= 1e-5 (1000 eps) Adam's update is
  ~sign(g) and insensitive to the grads' rounding, |Δ| <= 1e-6; where
  |ĝ| < 1e-5 (grads that are zero or cancel to rounding noise) the update
  g/(|g| + eps) is rounding noise itself, |Δ| <= 3 lr. The test reports how
  many entries fall in the loose regime.
- Adafactor (arctic-480b, llava-next-34b, qwen1.5-110b): the factored
  second moments (vr, vc, v) as Adam's v; the bfloat16 momentum m, leaf by
  leaf, |Δm| <= 2^-5 max|m| (measured up to 1.5%: entries whose grads are
  rounding noise get an O(1) normalized update either way) with at most
  0.1% of its entries more than one bfloat16 ulp (2^-7 |m|) apart
  (measured 0.02%); parameters, leaf by leaf, |Δ| <= 2^-5 times the
  reference's largest change of that leaf in the step (measured 1.4%).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as t_configs
from repro_torch.launch import steps as t_steps
from repro_torch.models import convert, ssm as t_ssm
from repro_torch.models import zoo as t_zoo
from repro_torch.optim.optimizers import tree_leaves, tree_map, \
    tree_unflatten

try:
    import jax
    import jax.numpy as jnp

    from repro import configs as j_configs
    from repro.launch import steps as j_steps
    from repro.models import zoo as j_zoo
except ModuleNotFoundError:     # a CUDA host may have no JAX installed
    jax = None

torch.set_num_threads(1)

ARCHS = ["stablelm-3b", "hymba-1.5b", "xlstm-350m", "phi3.5-moe-42b-a6.6b",
         "whisper-small", "arctic-480b", "llava-next-34b", "qwen1.5-110b"]
#: Adafactor's bounds (module docstring).
ADAFACTOR_M, ADAFACTOR_FAR, ADAFACTOR_P = 2.0 ** -5, 1e-3, 2.0 ** -5
LR, WARMUP, TOTAL = 1e-2, 1, 10
B2 = 0.95


@pytest.fixture(scope="module", autouse=True)
def reference():
    if jax is None:
        pytest.skip("needs the JAX reference package `repro`, and JAX is "
                    "not installed")


def _batch(cfg, seed=11, b=2, s=64):
    r = np.random.default_rng(seed)
    batch = {"tokens": r.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": r.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.encdec:
        batch["frames"] = r.standard_normal((b, s, cfg.d_model)).astype(
            np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCHS)
def runs(request):
    """Two train steps of one arch in each package from the reference's
    weights: per step (reference, port) of (loss, grad_norm, parameters,
    step, optimizer state), copied (the port updates in place)."""
    name = request.param
    cfg_j = j_configs.get_arch(name).smoke()
    cfg = t_configs.get_arch(name).smoke()
    jp = j_zoo.init_params(cfg_j, jax.random.key(0))
    tp = convert.params_from_jax(cfg, jax.tree.map(np.asarray, jp), "cpu")
    batch = _batch(cfg)
    j_step, j_init = j_steps.make_train_step(cfg_j, LR, WARMUP, TOTAL)
    t_step, t_init = t_steps.make_train_step(cfg, LR, WARMUP, TOTAL)
    j_step = jax.jit(j_step)
    js, ts = j_init(jp), t_init(tp)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = _torch_batch(batch)
    out = []
    for _ in range(2):
        jp, js, jm = j_step(jp, js, jb)
        tp, ts, tm = t_step(tp, ts, tb)
        out.append(((float(jm["loss"]), float(jm["grad_norm"]),
                     [np.asarray(a, np.float32) for a in jax.tree.leaves(jp)],
                     int(js.step), jax.tree.map(np.asarray, js.inner)),
                    (float(tm["loss"]), float(tm["grad_norm"]),
                     [a.float().numpy().copy() for a in tree_leaves(tp)],
                     int(ts.step), tree_map(torch.clone, ts.inner))))
    out.insert(0, [np.asarray(a, np.float32) for a in jax.tree.leaves(
        j_zoo.init_params(cfg_j, jax.random.key(0)))])
    return name, cfg.optimizer, out


def test_train_loss_and_grad_norm_match_reference(runs):
    _, _, (_, *out) = runs
    for want, got in out:
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5)
        assert got[3] == want[3]
    assert out[0][1][0] == out[1][1][0]       # lr 0: the same loss again


@pytest.mark.parametrize("step", [0, 1])
def test_train_state_matches_reference(runs, step):
    """Parameters and the optimizer's moments after one and after two
    steps."""
    name, optimizer, (init, *out) = runs
    want, got = out[step]
    if optimizer == "adafactor":
        before = init if step == 0 else out[step - 1][0][2]
        _adafactor_state_matches(name, step, want, got, before)
        return
    m_j, v_j = want[4]["m"], want[4]["v"]
    m_t, v_t = got[4]["m"], got[4]["v"]
    for tree_j, tree_t in ((m_j, m_t), (v_j, v_t)):
        for a, b in zip(jax.tree.leaves(tree_j), tree_leaves(tree_t)):
            np.testing.assert_allclose(b.numpy(), a, rtol=1e-4, atol=1e-6)
    c2 = 1 - B2 ** want[3]
    loose = 0
    for p_j, p_t, v in zip(want[2], got[2], jax.tree.leaves(v_j)):
        tight = np.sqrt(v / c2) >= 1e-5
        d = np.abs(p_t - p_j)
        assert np.all(d[tight] <= 1e-6), (name, d[tight].max())
        assert np.all(d[~tight] <= 3 * LR), (name, d[~tight].max())
        loose += int((~tight).sum())
    total = sum(p.size for p in want[2])
    print(f"{name} step {step + 1}: {loose} of {total} entries in the loose "
          "regime")
    if step == 0:
        for p_j, p_t in zip(want[2], got[2]):
            np.testing.assert_array_equal(p_t, p_j)   # lr 0: unchanged


def _adafactor_state_matches(name, step, want, got, before):
    """Adafactor's bounds (module docstring)."""
    js = jax.tree_util.tree_flatten_with_path(want[4])[0]
    ts = jax.tree_util.tree_flatten_with_path(got[4])[0]
    assert [p for p, _ in ts] == [p for p, _ in js]
    far = total = 0
    for (path, a), (_, b) in zip(js, ts):
        a, b = np.asarray(a, np.float32), b.float().numpy()
        if jax.tree_util.keystr(path).endswith("['m']"):
            d = np.abs(b - a)
            assert d.max() <= ADAFACTOR_M * np.abs(a).max(), (name, path)
            far += int((d > 2.0 ** -7 * np.abs(a)).sum())
            total += a.size
        else:
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6)
    assert far <= ADAFACTOR_FAR * total, (name, far, total)
    for p0, p_j, p_t in zip(before, want[2], got[2]):
        moved = np.abs(p_j - p0).max()
        assert np.abs(p_t - p_j).max() <= ADAFACTOR_P * moved, name
    print(f"{name} step {step + 1}: {far} of {total} momentum entries more "
          "than one bfloat16 ulp apart")
    if step == 0:
        for p_j, p_t in zip(want[2], got[2]):
            np.testing.assert_array_equal(p_t, p_j)   # lr 0: unchanged


# --- the port alone ------------------------------------------------------------

def _grads(cfg, params, batch):
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    loss = t_zoo.loss_fn(cfg, tree_unflatten(params, leaves), batch)
    return float(loss.detach()), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("name", ["hymba-1.5b", "phi3.5-moe-42b-a6.6b"])
def test_remat_modes_agree(name):
    """``remat`` "full", "dots" and "nothing" give the same loss and grads
    bit for bit (a recompute repeats the same CPU ops)."""
    base = t_configs.get_arch(name).smoke()
    params = t_zoo.init_params(base, torch.Generator().manual_seed(0),
                               "cpu")
    batch = _torch_batch(_batch(base))
    results = [_grads(dataclasses.replace(base, remat=mode), params, batch)
               for mode in ("full", "dots", "nothing")]
    for loss, grads in results[1:]:
        assert loss == results[0][0]
        for a, b in zip(grads, results[0][1]):
            assert torch.equal(a, b)


def test_gla_chunk_remat_agrees():
    """``gla_chunked(chunk_remat=True)`` under autograd: the same output
    and gradients as without the per-chunk checkpoint."""
    r = np.random.default_rng(5)
    shapes = [(2, 80, 3, 8), (2, 80, 3, 8), (2, 80, 3, 6), (2, 80, 3),
              (2, 80, 3)]
    args = [torch.from_numpy(r.standard_normal(s).astype(np.float32))
            for s in shapes]
    args[3] = -torch.nn.functional.softplus(args[3])
    outs = []
    for remat in (True, False):
        xs = [a.clone().requires_grad_() for a in args]
        y, h = t_ssm.gla_chunked(*xs, chunk=16, chunk_remat=remat)
        grads = torch.autograd.grad((y.sin().sum() + h.sum()), xs)
        outs.append((y.detach(), h.detach(), grads))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    for a, b in zip(outs[0][2], outs[1][2]):
        assert torch.equal(a, b)


def test_flash_custom_vjp_trains_like_default():
    """stablelm-3b with ``flash_custom_vjp=True`` against the default
    path: loss within 1e-5 and grads within the flash tests' 5e-4, and a
    train step runs with finite metrics (the reference's test)."""
    cfg0 = t_configs.get_arch("stablelm-3b").smoke()
    cfg1 = dataclasses.replace(cfg0, flash_custom_vjp=True)
    params = t_zoo.init_params(cfg0, torch.Generator().manual_seed(0),
                               "cpu")
    batch = _torch_batch(_batch(cfg0))
    l0, g0 = _grads(cfg0, params, batch)
    l1, g1 = _grads(cfg1, params, batch)
    assert l1 == pytest.approx(l0, rel=1e-5)
    for a, b in zip(g1, g0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-4,
                                   atol=5e-4)
    step, init = t_steps.make_train_step(cfg1, LR, WARMUP, TOTAL)
    _, _, m = step(params, init(params), batch)
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"]))


def test_grad_norm_sums_a_large_leaf_a_slice_at_a_time(monkeypatch):
    """The grad norm of a leaf larger than ``optimizers._PIECE`` elements
    is summed a run of leading rows at a time (no float32 copy of the
    whole leaf): within float32 rounding (rtol 1e-6) of the one-sum norm,
    with the same loss and, Adam being elementwise, the same weights bit
    for bit (stablelm-3b smoke, ``_PIECE`` lowered to 1000 elements)."""
    from repro_torch.optim import optimizers
    cfg = t_configs.get_arch("stablelm-3b").smoke()
    batch = _torch_batch(_batch(cfg))
    out = []
    for piece in (optimizers._PIECE, 1000):
        monkeypatch.setattr(optimizers, "_PIECE", piece)
        params = t_zoo.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
        step, init = t_steps.make_train_step(cfg, LR, WARMUP, TOTAL)
        opt = init(params)
        for _ in range(2):
            params, opt, m = step(params, opt, batch)
        out.append((float(m["loss"]), float(m["grad_norm"]), params))
    (l0, g0, p0), (l1, g1, p1) = out
    assert max(t.numel() for t in tree_leaves(p0)) > 1000
    assert l1 == l0
    np.testing.assert_allclose(g1, g0, rtol=1e-6)
    for a, b in zip(tree_leaves(p1), tree_leaves(p0)):
        assert torch.equal(a, b)
