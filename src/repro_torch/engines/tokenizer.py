"""Deterministic word-level tokenizer (hash-bucketed, reversible for any
word seen during encoding)."""
from __future__ import annotations

import hashlib
import threading


class HashTokenizer:
    def __init__(self, vocab_size: int = 4096, reserved: int = 8):
        self.vocab = vocab_size
        self.reserved = reserved       # 0=pad 1=bos 2=eos 3=sep ...
        self._inv = {}
        self._lock = threading.Lock()

    def _wid(self, w: str) -> int:
        h = int.from_bytes(hashlib.md5(w.encode()).digest()[:4], "little")
        tid = self.reserved + h % (self.vocab - self.reserved)
        with self._lock:
            self._inv.setdefault(tid, w)
        return tid

    def encode(self, text: str):
        return [self._wid(w) for w in text.split()]

    def decode(self, ids):
        return " ".join(self._inv.get(int(i), f"<{int(i)}>") for i in ids
                        if int(i) >= self.reserved)

    SEP = 3
