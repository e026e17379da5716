"""Data pipeline, the port of ``repro.data.pipeline``: deterministic
synthetic token streams (for benchmarks, dry runs and tests) and a
memmap-backed tokenized corpus reader, both shard-aware and restart-exact.

A data loader is host-side by design, as the reference's: batches are
numpy arrays made on the host, and the train step moves them to its
device. This is not a CPU fallback of device work.

Determinism contract: batch(step) depends only on (seed, step, global
example index), through the port's counter RNG (``core/rng.py``, bit for
bit the reference's), so the batches equal the reference's bit for bit. A
job restarted from a checkpoint at step k regenerates exactly the batches
k+1, k+2, ... whatever the shard count.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from ..core import rng as crng


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # sharding over hosts
    num_shards: int = 1
    shard_id: int = 0

    @property
    def local_batch(self) -> int:
        if self.global_batch % self.num_shards:
            raise ValueError(f"global_batch {self.global_batch} does not "
                             f"split over {self.num_shards} shards")
        return self.global_batch // self.num_shards


def _uniform(seed: int, iteration: int, stream: int,
             idx: np.ndarray) -> np.ndarray:
    """``rng.uniform`` at uint32 element indices, as float32 numpy."""
    return crng.uniform(seed, iteration, stream,
                        torch.from_numpy(idx.astype(np.int64))).numpy()


class SyntheticLM:
    """Markov-ish synthetic tokens: the next token correlated with the
    current one, so a model can actually learn."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        b, s = cfg.local_batch, cfg.seq_len
        ex0 = step * cfg.global_batch + cfg.shard_id * b
        idx = (np.arange(b * (s + 1), dtype=np.uint32).reshape(b, s + 1)
               + np.uint32(ex0 * (s + 1)))
        u = _uniform(cfg.seed, 0, 7, idx)
        base = (u * cfg.vocab).astype(np.int32) % cfg.vocab
        # correlate: token[t+1] = (token[t] + small drift) mod V  (80%)
        drift = (u * 17).astype(np.int32) % 7
        toks = base.copy()
        for t in range(1, s + 1):
            keep = u[:, t] < 0.8
            toks[:, t] = np.where(keep,
                                  (toks[:, t - 1] + drift[:, t]) % cfg.vocab,
                                  base[:, t])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class MemmapCorpus:
    """Flat .bin of int32 tokens; random-access windows, shard-aware,
    restart-exact (window choice keyed by (seed, step, example))."""

    def __init__(self, path: str, cfg: DataConfig):
        self.cfg = cfg
        self.data = np.memmap(path, dtype=np.int32, mode="r")
        self.n_windows = (len(self.data) - 1) // cfg.seq_len
        if self.n_windows <= 0:
            raise ValueError(f"corpus at {path} shorter than seq_len")

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        b, s = cfg.local_batch, cfg.seq_len
        ex0 = step * cfg.global_batch + cfg.shard_id * b
        idx = np.arange(b, dtype=np.uint32) + np.uint32(ex0)
        u = _uniform(cfg.seed, 1, 11, idx)
        starts = (u * self.n_windows).astype(np.int64) * cfg.seq_len
        toks = np.stack([self.data[st:st + s + 1] for st in starts])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


def write_corpus(path: str, tokens: np.ndarray) -> None:
    np.asarray(tokens, dtype=np.int32).tofile(path)
