"""Data pipeline (a copy of ``repro.training.data``, numpy only): a
synthetic LM stream and a memmap-backed tokenized corpus.

Both emit {tokens (B, S) int32, labels (B, S)} with next-token labels; the
memmap path supports per-host sharding (host h of H reads disjoint strided
windows).  The batches equal the JAX package's for the same seed and host
split: the same numpy generator draws them in the same order.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class DataConfig:
    batch: int
    seq_len: int
    vocab_size: int
    seed: int = 0
    path: Optional[str] = None       # memmap .bin of uint16/uint32 tokens
    dtype: str = "uint16"
    host_id: int = 0
    n_hosts: int = 1


def synthetic_stream(cfg: DataConfig) -> Iterator[dict]:
    """Zipf-ish synthetic tokens — cheap, deterministic, vocab-covering."""
    rng = np.random.default_rng(cfg.seed + cfg.host_id)
    ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    while True:
        toks = rng.choice(cfg.vocab_size, size=(cfg.batch, cfg.seq_len + 1),
                          p=probs).astype(np.int32)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def memmap_stream(cfg: DataConfig) -> Iterator[dict]:
    """Strided window reads from a flat token file, host-sharded."""
    if cfg.path is None:
        raise ValueError("memmap_stream needs DataConfig.path")
    data = np.memmap(cfg.path, dtype=np.dtype(cfg.dtype), mode="r")
    window = cfg.seq_len + 1
    n_windows = len(data) // window
    rng = np.random.default_rng(cfg.seed + cfg.host_id)
    # host h owns windows where idx % n_hosts == host_id
    owned = np.arange(cfg.host_id, n_windows, cfg.n_hosts)
    while True:
        idx = rng.choice(owned, size=cfg.batch, replace=n_windows < cfg.batch)
        batch = np.stack([data[i * window:(i + 1) * window] for i in idx])
        batch = batch.astype(np.int32)
        yield {"tokens": batch[:, :-1], "labels": batch[:, 1:]}


def make_stream(cfg: DataConfig) -> Iterator[dict]:
    return memmap_stream(cfg) if cfg.path else synthetic_stream(cfg)


def write_corpus(path: str, tokens: np.ndarray, dtype: str = "uint16") -> None:
    tokens.astype(np.dtype(dtype)).tofile(path)
