"""Deterministic synthetic LM data pipeline (a copy of
``repro/data/pipeline.py``: NumPy only, so the batches are JAX's bit for
bit for the same seed and step; the port keeps its own copy rather than
importing the JAX package).

Production posture: the pipeline is a pure function of (seed, step) so that
(1) every data-parallel host can generate exactly its own shard without
coordination, and (2) restarts resume bit-identically from the checkpointed
``DataState`` — the data side of fault tolerance. A double-buffered
prefetch thread overlaps host generation with device steps.

The token stream is a mixture of Zipf-distributed unigrams and short
repeated motifs, so models actually reduce loss on it (useful for the
end-to-end training example) while staying fully offline.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class DataState:
    seed: int
    step: int

    def to_dict(self) -> Dict[str, int]:
        return {"seed": self.seed, "step": self.step}

    @staticmethod
    def from_dict(d) -> "DataState":
        return DataState(int(d["seed"]), int(d["step"]))


class SyntheticLM:
    def __init__(self, vocab: int, seq_len: int, global_batch: int, seed: int = 0,
                 motif_len: int = 16, n_motifs: int = 64):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.state = DataState(seed, 0)
        base = np.random.default_rng(seed)
        # fixed motif table (part of the "dataset", derived from seed)
        self.motifs = base.integers(0, vocab, size=(n_motifs, motif_len))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, step) — restart-safe, host-shardable."""
        rng = np.random.default_rng((self.state.seed << 20) ^ step)
        B, S = self.global_batch, self.seq_len
        zipf = rng.zipf(1.3, size=(B, S)) % self.vocab
        toks = zipf.astype(np.int32)
        # overlay motifs (predictable structure -> learnable signal)
        n_over = S // self.motifs.shape[1] // 2
        for b in range(B):
            ids = rng.integers(0, len(self.motifs), size=n_over)
            starts = rng.integers(0, S - self.motifs.shape[1], size=n_over)
            for m, s0 in zip(ids, starts):
                toks[b, s0 : s0 + self.motifs.shape[1]] = self.motifs[m]
        return {"tokens": toks}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch_at(self.state.step)
            self.state.step += 1


def make_pipeline(vocab: int, seq_len: int, global_batch: int, seed: int = 0,
                  prefetch: int = 2):
    """Returns (source, iterator-with-prefetch)."""
    src = SyntheticLM(vocab, seq_len, global_batch, seed)
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    it = iter(src)

    def worker():
        for b in it:
            q.put(b)

    t = threading.Thread(target=worker, daemon=True)
    t.start()

    def gen():
        while True:
            yield q.get()

    return src, gen()
