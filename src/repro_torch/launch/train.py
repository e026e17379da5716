"""LM training launcher, the port of ``repro.launch.train``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \
        --steps 200 --batch 8 --seq 256 --smoke --ckpt-dir build/ckpt

on the CUDA card unless ``--device cpu``. ``--smoke`` uses the reduced
config (CPU-viable). Batches come from ``data.SyntheticLM`` (host numpy,
moved to the device each step); ``--ckpt-dir`` runs the steps under
``runtime.StepRunner``, which saves ``(params, OptState)`` every
``--ckpt-interval`` steps and resumes from the newest checkpoint there. It
prints the reference's lines: ``step … loss … gnorm …`` every
``--log-interval`` steps and ``final loss: …`` at the end.

The port trains on one card. The reference's multi-host branch
(``jax.distributed.initialize`` when ``COORDINATOR_ADDRESS`` is set, one
process a host, each reading its shard of the batch) has no counterpart
here: this launcher is one process reading the whole batch, and it does
not read that variable.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from .. import _device
from ..configs import get_arch
from ..data import DataConfig, SyntheticLM
from ..models import zoo
from ..runtime import RunnerConfig, StepRunner
from .steps import make_train_step


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-interval", type=int, default=50)
    ap.add_argument("--log-interval", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    try:
        dev = _device.resolve(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = zoo.init_params(cfg, gen, dev)
    train_step, opt_init = make_train_step(cfg, base_lr=args.lr,
                                           warmup=max(args.steps // 10, 1),
                                           total_steps=args.steps)
    opt_state = opt_init(params)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch, seed=args.seed))
    losses = []

    def step_fn(state, step):
        params, opt_state = state
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in data.batch(step).items()}
        params, opt_state, metrics = train_step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if step % args.log_interval == 0:
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)
        return params, opt_state

    state = (params, opt_state)
    if args.ckpt_dir:
        runner = StepRunner(
            RunnerConfig(args.ckpt_dir, ckpt_interval=args.ckpt_interval),
            step_fn)
        start, state = runner.resume_or(state)
        state = runner.run(state, start, args.steps - start)
    else:
        for step in range(args.steps):
            state = step_fn(state, step)
    print(f"final loss: {losses[-1]:.4f} (first: {losses[0]:.4f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
