"""PSO × LM integration, the port of the reference's
``examples/tune_lm_hparams.py``: the paper's optimizer tunes the training
hyperparameters of an assigned-architecture LM (smoke scale).

Each particle is (log10 lr, warmup fraction, weight decay); fitness is the
negative loss of a short probe run on the synthetic pipeline
(``core.PSOTuner``; the weight decay is searched and, as in the
reference, not passed to the train step).

    PYTHONPATH=src python -m repro_torch.examples.tune_lm_hparams \
        --arch stablelm-3b

on the CUDA card unless ``--device cpu``. The train step updates the
parameters and moments in place (``launch.steps.make_train_step``), so
every probe starts from its own copy of the initial weights.
"""
from __future__ import annotations

import argparse
import math
from typing import Optional, Sequence

import torch

from .. import _device
from ..configs import get_arch
from ..core import PSOTuner, SearchDim
from ..data import DataConfig, SyntheticLM
from ..launch.steps import make_train_step
from ..models import zoo
from ..optim.optimizers import tree_map

DIMS = (SearchDim("lr", 1e-5, 1e-2, log=True),
        SearchDim("warmup_frac", 0.05, 0.5),
        SearchDim("wd", 0.0, 0.1))


def make_probe(arch: str, probe_steps: int = 8, batch: int = 4,
               seq: int = 64, device=None, params0=None):
    """The probe: hyperparameters -> the negative loss after
    ``probe_steps`` steps from ``params0`` (default: the smoke config's
    init, seed 0, on ``device``), which it never changes."""
    cfg = get_arch(arch).smoke()
    dev = _device.resolve(device)
    if params0 is None:
        params0 = zoo.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch, seed=7))
    batches = [{k: torch.as_tensor(v, device=dev)
                for k, v in data.batch(i).items()}
               for i in range(probe_steps)]

    def probe(hp) -> float:
        step, opt_init = make_train_step(
            cfg, base_lr=hp["lr"],
            warmup=max(1, int(hp["warmup_frac"] * probe_steps)),
            total_steps=probe_steps)
        params = tree_map(torch.clone, params0)
        opt = opt_init(params)
        loss = None
        for b in batches:
            params, opt, m = step(params, opt, b)
            loss = float(m["loss"])
            if not math.isfinite(loss):
                return -1e9               # diverged: worst fitness
        return -loss                      # maximize −loss

    return probe


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--particles", type=int, default=6)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    try:
        _device.resolve(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    tuner = PSOTuner(list(DIMS), particles=args.particles, seed=0)
    probe = make_probe(args.arch, device=args.device)
    result = tuner.run(probe, iters=args.iters,
                       callback=lambda it, t: print(
                           f"iter {it}: best probe loss "
                           f"{-t.gbest_fit:.4f}", flush=True))
    print(f"\nbest hyperparameters after {result.evaluations} probes:")
    for k, v in result.best_params.items():
        print(f"  {k} = {v:.5g}")
    print(f"best probe loss = {-result.best_fitness:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
