"""Deterministic, shardable token data pipeline (port of
``repro/data/pipeline.py``; numpy only, so batches are bitwise-equal to
the reference's for the same seed, step and rank).

Two sources:
  * ``SyntheticLM`` — a fixed-seed Zipfian Markov stream: a LEARNABLE
    distribution, so loss curves mean something without a dataset (it
    stands in for OpenWebText in the paper's Tables 2/4/5/6);
  * ``MemmapTokens`` — a flat uint16/uint32 token file, random-access
    windows, deterministic shuffling by (seed, step).

Both are stateless: batch(step) is a pure function of (seed, step), so a
resumed run replays exactly. Per-host sharding slices the global batch
by data-parallel rank.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    order: int = 3          # Markov order of the synthetic language

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        # Zipfian unigram + deterministic successor tables: each context
        # hash maps to a small candidate set -> learnable structure.
        self._probs = 1.0 / (np.arange(1, v + 1) ** 1.1)
        self._probs /= self._probs.sum()
        # Zipf-biased successor candidates: the marginal stays Zipfian
        # (fast unigram learning signal) on top of the Markov structure
        self._succ = rng.choice(v, size=(8192, 4),
                                p=self._probs).astype(np.int64)

    def batch(self, step: int, rank: int = 0, world: int = 1) -> dict:
        b = self.global_batch // world
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 4096 + rank)
        toks = np.empty((b, self.seq_len + 1), np.int64)
        toks[:, 0] = rng.choice(self.vocab_size, size=b, p=self._probs)
        h = toks[:, 0].copy()
        for t in range(1, self.seq_len + 1):
            cand = self._succ[h % 8192]                    # (b, 4)
            pick = rng.integers(0, 4, size=b)
            nxt = cand[np.arange(b), pick]
            # 10% noise resample from unigram for entropy
            noise = rng.random(b) < 0.1
            nxt[noise] = rng.choice(self.vocab_size, size=int(noise.sum()),
                                    p=self._probs)
            toks[:, t] = nxt
            h = h * 31 + nxt
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


@dataclasses.dataclass
class MemmapTokens:
    path: str
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    dtype: str = "uint16"

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=self.dtype, mode="r")
        self._n = len(self._data) - self.seq_len - 1
        if self._n <= 0:
            raise ValueError("token file shorter than one sequence")

    def batch(self, step: int, rank: int = 0, world: int = 1) -> dict:
        b = self.global_batch // world
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 4096 + rank)
        starts = rng.integers(0, self._n, size=b)
        toks = np.stack([np.asarray(
            self._data[s:s + self.seq_len + 1], dtype=np.int64)
            for s in starts])
        toks = np.clip(toks, 0, self.vocab_size - 1)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


def make_source(cfg, shape, path: str | None = None, seed: int = 0):
    if path:
        return MemmapTokens(path, cfg.vocab_size, shape.seq_len,
                            shape.global_batch, seed)
    return SyntheticLM(cfg.vocab_size, shape.seq_len, shape.global_batch,
                       seed)
