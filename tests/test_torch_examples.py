"""The port's LM examples (``repro_torch.examples.train_lm`` and
``tune_lm_hparams``) on the CPU, against the reference's
``examples/train_lm.py`` and ``examples/tune_lm_hparams.py`` (loaded from
their files; they are not a package) from the reference's weights carried
across by ``models.convert``.

- ``train_lm``: three steps of the ~100M config at a reduced batch and
  sequence (B=2, S=32), their losses against the reference's jitted train
  step at rtol 1e-5 (float32 through 12 layers and a 50304-word
  unembedding). A run stopped after its step-2 checkpoint and resumed
  equals the straight run bit for bit (losses and every weight); this one
  at 2 of the 12 layers and a 512-word vocabulary, which changes nothing
  of the checkpoint logic and keeps its files at a few MB.
- ``tune_lm_hparams``: the tuner's ``ask()`` populations over the
  example's three dims equal the reference's; two probes' fitness (the
  negative loss after 8 Adam steps of stablelm-3b's smoke config) at rtol
  1e-4, 8 steps of an lr up to 1e-2 compounding float32 rounding; and
  ``params0`` unchanged by a probe.
"""
import dataclasses
import importlib.util
import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.core import PSOTuner
from repro_torch.examples import train_lm, tune_lm_hparams
from repro_torch.models import convert
from repro_torch.optim.optimizers import tree_leaves, tree_map

try:
    import jax
    import jax.numpy as jnp

    from repro.core import PSOTuner as JPSOTuner
    from repro.core import SearchDim as JSearchDim
    from repro.data import DataConfig, SyntheticLM
    from repro.launch.steps import make_train_step
    from repro.models import zoo as j_zoo
except ModuleNotFoundError:     # a CUDA host may have no JAX installed
    jax = None

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def reference():
    if jax is None:
        pytest.skip("needs the JAX reference package `repro`, and JAX is "
                    "not installed")


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _carried(cfg, cfg_j):
    jp = j_zoo.init_params(cfg_j, jax.random.key(0))
    return jp, convert.params_from_jax(cfg, jax.tree.map(np.asarray, jp),
                                       "cpu")


def test_train_lm_resume_equals_straight_run(tmp_path):
    cfg = dataclasses.replace(train_lm.hundred_m_config(), n_layers=2,
                              vocab=512)
    kw = dict(steps=4, batch=2, seq=32, lr=3e-4, ckpt_interval=2,
              device="cpu")
    run = str(tmp_path / "run")
    losses, params, opt = train_lm.train(cfg, ckpt_dir=run, **kw)
    assert sorted(os.listdir(run)) == ["step_00000002", "step_00000004"]
    straight = [t.clone() for t in tree_leaves((params, opt))]
    del params, opt
    shutil.rmtree(os.path.join(run, "step_00000004"))     # the "crash"
    resumed, params, opt = train_lm.train(cfg, ckpt_dir=run, resume=True,
                                          **kw)
    assert sorted(resumed) == [2, 3]
    assert [resumed[k] for k in (2, 3)] == [losses[k] for k in (2, 3)]
    for a, b in zip(tree_leaves((params, opt)), straight):
        assert torch.equal(a, b)


def test_train_lm_against_reference(tmp_path):
    ref = _example("train_lm")
    cfg, cfg_j = train_lm.hundred_m_config(), ref.hundred_m_config()
    assert cfg == train_lm.hundred_m_config() and cfg.vocab == cfg_j.vocab
    jp, tp = _carried(cfg, cfg_j)
    steps, b, s = 3, 2, 32
    step, init = make_train_step(cfg_j, base_lr=3e-4, warmup=20,
                                 total_steps=steps)
    step = jax.jit(step)
    js = init(jp)
    data = SyntheticLM(DataConfig(vocab=cfg_j.vocab, seq_len=s,
                                  global_batch=b, seed=0))
    want = []
    for i in range(steps):
        jp, js, m = step(jp, js, {k: jnp.asarray(v)
                                  for k, v in data.batch(i).items()})
        want.append(float(m["loss"]))
    got, _, _ = train_lm.train(cfg, steps=steps, batch=b, seq=s, lr=3e-4,
                               ckpt_dir=str(tmp_path / "ckpt"),
                               device="cpu", params=tp)
    np.testing.assert_allclose([got[i] for i in range(steps)], want,
                               rtol=1e-5)


def test_tuner_populations_equal_reference():
    ref_dims = [JSearchDim("lr", 1e-5, 1e-2, log=True),
                JSearchDim("warmup_frac", 0.05, 0.5),
                JSearchDim("wd", 0.0, 0.1)]
    assert [(d.name, d.low, d.high, d.log) for d in
            tune_lm_hparams.DIMS] == [(d.name, d.low, d.high, d.log)
                                      for d in ref_dims]
    mine = PSOTuner(list(tune_lm_hparams.DIMS), particles=6, seed=0)
    theirs = JPSOTuner(ref_dims, particles=6, seed=0)
    for _ in range(4):
        pop = mine.ask()
        assert pop == theirs.ask()
        fits = [-(np.log10(p["lr"]) + 3) ** 2 - p["warmup_frac"]
                for p in pop]
        mine.tell(fits)
        theirs.tell(fits)


def test_probe_matches_reference_and_keeps_params0():
    from repro_torch import configs as t_configs
    from repro import configs as j_configs
    ref = _example("tune_lm_hparams")
    arch = "stablelm-3b"
    _, params0 = _carried(t_configs.get_arch(arch).smoke(),
                          j_configs.get_arch(arch).smoke())
    before = tree_map(torch.clone, params0)
    mine = tune_lm_hparams.make_probe(arch, device="cpu", params0=params0)
    theirs = ref.make_probe(arch)
    pop = PSOTuner(list(tune_lm_hparams.DIMS), particles=6, seed=0).ask()
    for hp in pop[:2]:
        got, want = mine(hp), theirs(hp)
        assert got == pytest.approx(want, rel=1e-4), hp
        for a, b in zip(tree_leaves(params0), tree_leaves(before)):
            assert torch.equal(a, b)
    assert mine(pop[0]) == mine(pop[0])       # every probe from params0
