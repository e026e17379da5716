"""End-to-end example, the port of the reference's ``examples/train_lm.py``:
train a ~100M-parameter dense LM for a few hundred steps on the synthetic
pipeline with checkpoint/restart, and show the loss decreasing. (The
entry point for the registered configs is ``python -m
repro_torch.launch.train``.)

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300

on the CUDA card unless ``--device cpu``. A checkpoint of ``(params,
OptState)`` is written every 100 steps, as in the reference, and at the
end, into ``--ckpt-dir`` (under ``build/`` by default),
the two newest kept; ``--resume`` continues from the newest one there,
otherwise the directory is cleared first. The train step updates the
parameters and moments in place (``launch.steps.make_train_step``); a
resume restores into new tensors.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import time
from typing import Dict, Optional, Sequence

import torch

from .. import _device
from .. import checkpoint as ckpt
from ..configs import get_arch
from ..data import DataConfig, SyntheticLM
from ..launch.steps import make_train_step
from ..models import zoo
from ..optim.optimizers import tree_leaves


def hundred_m_config():
    """~100M-param dense transformer (stablelm family, shrunk)."""
    return dataclasses.replace(
        get_arch("stablelm-3b"),
        n_layers=12, d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
        vocab=50304, head_dim=64, loss_chunk=256, attn_q_block=256,
        attn_kv_block=256, param_dtype="float32")


def train(cfg, *, steps: int, batch: int, seq: int, lr: float,
          ckpt_dir: str, resume: bool = False, ckpt_interval: int = 100,
          device=None, params=None):
    """The example's run: (losses by step, params, opt_state), from
    ``params`` (default: the port's init, seed 0, on ``device``), which
    the steps update in place."""
    dev = _device.resolve(device)
    if params is None:
        params = zoo.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
    n_params = sum(int(p.numel()) for p in tree_leaves(params))
    print(f"model: {n_params/1e6:.1f}M params "
          f"({cfg.n_layers}L d={cfg.d_model})")

    step_fn, opt_init = make_train_step(cfg, base_lr=lr, warmup=20,
                                        total_steps=steps)
    opt_state = opt_init(params)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch, seed=0))

    start = 0
    if resume:
        got = ckpt.restore_latest(ckpt_dir, (params, opt_state))
        if got[0] is not None:
            start, (params, opt_state) = got
            print(f"resumed from step {start}")
    elif os.path.isdir(ckpt_dir):
        shutil.rmtree(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)

    losses: Dict[int, float] = {}
    t0 = time.time()
    for step in range(start, steps):
        b = {k: torch.as_tensor(v, device=dev)
             for k, v in data.batch(step).items()}
        params, opt_state, m = step_fn(params, opt_state, b)
        loss = float(m["loss"])
        losses[step] = loss
        if step % 20 == 0:
            toks = batch * seq
            dt = time.time() - t0
            print(f"step {step:4d}  loss {loss:.4f}  "
                  f"({toks*(step-start+1)/max(dt,1e-9):.0f} tok/s)",
                  flush=True)
        if (step + 1) % ckpt_interval == 0:
            ckpt.save(ckpt_dir, step + 1, (params, opt_state))
            ckpt.prune(ckpt_dir, keep=2)
    ckpt.save(ckpt_dir, steps, (params, opt_state))
    return losses, params, opt_state


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join("build",
                                                       "train_lm_ckpt"))
    ap.add_argument("--resume", action="store_true")
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
    losses, _, _ = train(hundred_m_config(), steps=args.steps,
                         batch=args.batch, seq=args.seq, lr=args.lr,
                         ckpt_dir=args.ckpt_dir, resume=args.resume,
                         device=args.device)
    first, last = losses[min(losses)], losses[max(losses)]
    print(f"\nloss: {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    assert last < first, "training did not reduce loss"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
