"""Synthetic data pipeline: deterministic, seekable token stream with
host-side prefetch — stands in for a real corpus loader with the same
interface (``__iter__`` of {'tokens': (B, S+1)} batches)."""
from __future__ import annotations

import queue
import threading

import numpy as np


class SyntheticLM:
    """Markov-ish synthetic LM data: structured enough that a model can
    reduce loss on it (token t+1 = f(t) + noise), deterministic per seed."""

    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0, prefetch: int = 2):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq_len
        self.seed = seed
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _gen(self, step: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 100003 + step)
        x = np.zeros((self.batch, self.seq + 1), np.int32)
        x[:, 0] = rng.integers(0, self.vocab, self.batch)
        mult = 31
        for t in range(1, self.seq + 1):
            noise = rng.integers(0, 4, self.batch)
            x[:, t] = (x[:, t - 1] * mult + noise) % self.vocab
        return x

    def _produce(self):
        step = 0
        while not self._stop.is_set():
            try:
                self._q.put({"tokens": self._gen(step)}, timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()


def doc_corpus(num_docs: int = 8, seed: int = 1):
    """Tiny deterministic text corpus for the RAG workflows."""
    rng = np.random.default_rng(seed)
    topics = ["optics", "finance", "llm systems", "biology", "chess",
              "espresso", "sailing", "volcanoes"]
    docs = []
    for i in range(num_docs):
        t = topics[i % len(topics)]
        sents = [f"Fact {j} about {t}: value {int(rng.integers(0, 999))}."
                 for j in range(40)]
        docs.append({"id": f"doc{i}", "topic": t, "text": " ".join(sents)})
    return docs
