"""Synthetic LM data: seeded structured token streams (Zipf unigrams
with a fixed successor grammar, so the loss can fall), cut into
(tokens, labels) batches, sharded by rank.

Counterpart of `repro.data.pipeline`, copied as numpy code so that a
seed gives the reference's batches bit for bit.  Batches are numpy
int32 arrays; the caller moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    zipf_a: float = 1.2
    rank: int = 0
    world: int = 1


def _zipf_probs(vocab: int, a: float) -> np.ndarray:
    p = 1.0 / np.arange(1, vocab + 1) ** a
    return p / p.sum()


def synthetic_stream(cfg: DataConfig) -> Iterator[np.ndarray]:
    """Yields (batch, seq_len+1) int32 arrays: Zipf-distributed unigrams,
    each token followed by its fixed successor 60% of the time."""
    rng = np.random.default_rng(cfg.seed + 1009 * cfg.rank)
    probs = _zipf_probs(cfg.vocab, cfg.zipf_a)
    successor = rng.permutation(cfg.vocab)
    while True:
        u = rng.choice(cfg.vocab, size=(cfg.batch, cfg.seq_len + 1), p=probs)
        out = u.copy()
        follow = rng.random((cfg.batch, cfg.seq_len)) < 0.6
        out[:, 1:] = np.where(follow, successor[out[:, :-1]], u[:, 1:])
        yield out.astype(np.int32)


def make_batches(cfg: DataConfig) -> Iterator[dict]:
    """{"tokens", "labels"} next-token pairs, sharded by (rank, world)."""
    for chunk in synthetic_stream(cfg):
        yield {"tokens": chunk[:, :-1], "labels": chunk[:, 1:]}
