"""Port of ``src/repro/data/synthetic.py`` (copied; imports re-pointed).

Deterministic synthetic data pipeline.

Two flavours:
* LM token streams (markov-ish structure so loss actually decreases) for the
  at-scale archs;
* per-silo non-IID labelled datasets (images or token sequences) for the
  cross-silo FL path — each silo gets a Dirichlet-skewed label distribution,
  the standard FL heterogeneity model.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


def synthetic_lm_batch(rng: np.random.Generator, batch: int, seq: int,
                       vocab: int):
    """Structured token stream: next token = (3*prev + noise) % vocab, which
    a causal model can learn quickly (used to check loss decreases)."""
    t0 = rng.integers(0, vocab, size=(batch, 1))
    toks = [t0]
    for _ in range(seq):
        nxt = (3 * toks[-1] + rng.integers(0, 7, size=(batch, 1))) % vocab
        toks.append(nxt)
    toks = np.concatenate(toks, axis=1)
    return {"tokens": toks[:, :seq].astype(np.int32),
            "targets": toks[:, 1:seq + 1].astype(np.int32)}


def lm_batch_iterator(seed: int, batch: int, seq: int, vocab: int) -> Iterator:
    rng = np.random.default_rng(seed)
    while True:
        yield synthetic_lm_batch(rng, batch, seq, vocab)


# ---------------------------------------------------------------------------
# per-silo FL datasets
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SiloDataset:
    """One silo's local shard."""
    silo_id: int
    kind: str  # image | text
    features: np.ndarray  # images (N,H,W,3) or tokens (N,S)
    labels: np.ndarray  # (N,)
    num_classes: int

    def num_examples(self) -> int:
        return len(self.labels)

    def batches(self, batch_size: int, seed: int = 0) -> Iterator[dict]:
        rng = np.random.default_rng(seed * 1000 + self.silo_id)
        n = self.num_examples()
        while True:
            idx = rng.choice(n, size=min(batch_size, n), replace=False)
            key = "images" if self.kind == "image" else "tokens"
            yield {key: self.features[idx], "labels": self.labels[idx]}


def make_silo_datasets(num_silos: int, *, kind: str = "image",
                       examples_per_silo: int = 128, num_classes: int = 16,
                       image_size: int = 32, seq_len: int = 64,
                       vocab: int = 30522, alpha: float = 0.5,
                       seed: int = 0):
    """Dirichlet(alpha) label skew across silos; class-conditional synthetic
    features so that learning is possible (class-dependent mean patterns)."""
    rng = np.random.default_rng(seed)
    proportions = rng.dirichlet([alpha] * num_classes, size=num_silos)
    class_dirs = rng.normal(size=(num_classes, 8)).astype(np.float32)
    silos = []
    for sid in range(num_silos):
        labels = rng.choice(num_classes, size=examples_per_silo,
                            p=proportions[sid]).astype(np.int32)
        if kind == "image":
            base = rng.normal(
                size=(examples_per_silo, image_size, image_size, 3)
            ).astype(np.float32) * 0.3
            # class-dependent low-frequency pattern
            xs = np.linspace(0, np.pi * 2, image_size, dtype=np.float32)
            grid = np.stack([np.sin(np.outer(xs * (k % 4 + 1), xs))
                             for k in range(num_classes)])
            feats = base + grid[labels][..., None]
            silos.append(SiloDataset(sid, "image", feats, labels, num_classes))
        else:
            toks = rng.integers(0, vocab, size=(examples_per_silo, seq_len))
            # class-dependent token bias in the first positions
            toks[:, :8] = (labels[:, None] * 37 +
                           np.arange(8)[None]) % min(vocab, 1000)
            silos.append(SiloDataset(sid, "text", toks.astype(np.int32),
                                     labels, num_classes))
    return silos
