"""Fault-tolerance runtime, the port of ``repro.runtime``: a supervised
step loop with checkpoint and restart, retry with backoff around device
failures, and heartbeats. Host-only; a copy of the reference on the port's
``checkpoint``.

Straggler mitigation for PSO is island mode (``core.distributed``): the
only barrier is the gbest exchange every K iterations, so a straggling
island delays a scalar exchange, not each step, and K can be raised.
``suggest_checkpoint_interval`` tunes the checkpoint cadence to the mean
time between failures.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Optional

from .. import checkpoint as ckpt


@dataclasses.dataclass
class RunnerConfig:
    ckpt_dir: str
    ckpt_interval: int = 100         # steps between checkpoints
    keep: int = 3
    max_retries: int = 3
    backoff_s: float = 1.0
    heartbeat_interval: int = 10     # steps between heartbeat callbacks


def suggest_checkpoint_interval(step_time_s: float, mtbf_hours: float,
                                write_time_s: float) -> int:
    """Young/Daly optimum: sqrt(2 * write * MTBF), in steps."""
    mtbf_s = mtbf_hours * 3600.0
    interval_s = math.sqrt(2.0 * write_time_s * mtbf_s)
    return max(1, int(interval_s / max(step_time_s, 1e-9)))


class StepRunner:
    """Supervised optimization loop.

    ``step_fn(state, step) -> state`` is a pure update. ``save_tree``/
    ``load_tree`` convert between the runtime state and the checkpointed
    tree (e.g. a host copy of a swarm). A restore lands on the devices of
    the state it replaces.
    """

    def __init__(self, cfg: RunnerConfig, step_fn: Callable,
                 save_tree: Callable = lambda s: s,
                 load_tree: Callable = lambda tree, tmpl: tree,
                 heartbeat: Optional[Callable[[int, Any], None]] = None):
        self.cfg = cfg
        self.step_fn = step_fn
        self.save_tree = save_tree
        self.load_tree = load_tree
        self.heartbeat = heartbeat
        self.retries = 0

    def resume_or(self, init_state: Any):
        """Restore the latest checkpoint if one exists, else init."""
        step, tree = ckpt.restore_latest(self.cfg.ckpt_dir,
                                         self.save_tree(init_state))
        if step is None:
            return 0, init_state
        return step, self.load_tree(tree, init_state)

    def run(self, state: Any, start_step: int, num_steps: int) -> Any:
        step = start_step
        while step < start_step + num_steps:
            try:
                state = self.step_fn(state, step)
                step += 1
                self.retries = 0
            except Exception:                     # device loss, OOM, ...
                self.retries += 1
                if self.retries > self.cfg.max_retries:
                    # final checkpoint attempt, then surface the failure
                    ckpt.save(self.cfg.ckpt_dir, step,
                              self.save_tree(state))
                    raise
                time.sleep(self.cfg.backoff_s * 2 ** (self.retries - 1))
                # restart from the last durable state
                step, state = self.resume_or(state)
                continue
            if step % self.cfg.ckpt_interval == 0:
                ckpt.save(self.cfg.ckpt_dir, step, self.save_tree(state))
                ckpt.prune(self.cfg.ckpt_dir, self.cfg.keep)
            if self.heartbeat and step % self.cfg.heartbeat_interval == 0:
                self.heartbeat(step, state)
        ckpt.save(self.cfg.ckpt_dir, step, self.save_tree(state))
        return state
