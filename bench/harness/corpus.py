"""The documents the traffic asks about, and the word tokenizer the
reference needs to read them.

``doc_corpus`` follows the port's ``training/data.py::doc_corpus``: 40
"Fact j about <topic>: value N." sentences per document over 8 topics,
here drawn from the run's seed. ``HashTokenizer`` is a copy of the
port's ``engines/tokenizer.py`` (md5 of each word, bucketed into the
vocabulary): it is the text format both sides read, so the reference
encodes a text into the same ids the program's encoders do.
"""
from __future__ import annotations

import hashlib

import numpy as np

TOPICS = ("optics", "finance", "llm systems", "biology", "chess",
          "espresso", "sailing", "volcanoes")
FACTS = 40


def doc_corpus(num_docs: int, seed: int) -> list:
    """``num_docs`` documents, document i on topic i mod 8, each fact's
    value drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(num_docs):
        t = TOPICS[i % len(TOPICS)]
        sents = [f"Fact {j} about {t}: value {int(rng.integers(0, 999))}."
                 for j in range(FACTS)]
        docs.append({"id": f"doc{i}", "topic": t, "text": " ".join(sents)})
    return docs


class HashTokenizer:
    """Word ids as the port's tokenizer makes them (encode only)."""

    def __init__(self, vocab_size: int, reserved: int = 8):
        self.vocab = vocab_size
        self.reserved = reserved

    def _wid(self, w: str) -> int:
        h = int.from_bytes(hashlib.md5(w.encode()).digest()[:4], "little")
        return self.reserved + h % (self.vocab - self.reserved)

    def encode(self, text: str) -> list:
        return [self._wid(w) for w in text.split()]
